"""Mixture-of-Experts with top-k routing and capacity-bounded dispatch, and
the dense feed-forward block, on PyTorch tensors — the counterparts of the
reference package's ``models/moe.py``.

GShard-style: tokens are organised into fixed-size groups so the dispatch /
combine einsums stay O(tokens * group * d) rather than quadratic in the
global token count.  Overflowing tokens (beyond each expert's capacity) are
dropped — their residual stream passes through unchanged.  The queue slot
of each (token, k) pair counts over the flattened (T * k) order of the
top-k output, so that order is part of the result: the top k come from a
stable descending sort, which ranks equal probabilities lower expert index
first, as ``jax.lax.top_k`` does (``torch.topk`` promises no order among
ties).

Expert weights: (E, d, f).  On a mesh the sharding hints
(``runtime/hints.py``) lay the dispatched activations out as the
reference's: expert-parallel over ``model`` where the experts divide it,
the hidden axis over ``model`` otherwise (at every token count, where the
reference starts at 2048); outside a step's hints they are the identity.
The dispatch, the experts' products and the combine then run on each
rank's own groups and experts (or hidden slice), a partial sum over
``model``, the weights gathered over ``data`` first (``hints.on_ranks``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..runtime.hints import active as hints_active
from ..runtime.hints import axis_size, constrain, on_ranks, spec_of
from .common import dense_init, gated_act

GROUP = 512  # tokens per dispatch group


def moe_params(gen: torch.Generator, cfg, dtype=torch.float32,
               lead: tuple = ()) -> dict:
    """The router (f32, as in the reference) and the expert weights, each
    with the leading axes ``lead``."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    p = {"router": dense_init(gen, lead + (d, E), torch.float32),
         "w_up": dense_init(gen, lead + (E, d, f), dtype),
         "w_down": dense_init(gen, lead + (E, f, d), dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, lead + (E, d, f), dtype)
    return p


def capacity(group: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(group * m.top_k * m.capacity_factor / m.n_experts))
    return max(min(c, group), 1)


@dataclasses.dataclass
class Routing:
    """One group-batch's routing decision, every tensor (G, T, ...):
    ``logits`` / ``probs`` (G, T, E); ``gate_vals`` (renormalised),
    ``gate_idx``, ``slot`` (the queue slot in its expert) and ``keep``
    (slot within capacity), each (G, T, k)."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int

    @property
    def dropped(self) -> int:
        """(token, k) pairs past their expert's capacity."""
        return int(((self.gate_vals > 0) & ~self.keep).sum())


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    equal values lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gate(x2d: torch.Tensor, router_w: torch.Tensor, cfg) -> Routing:
    """x2d: (G, T, d) grouped tokens -> the router's choices and queue
    slots."""
    m = cfg.moe
    G, T, _ = x2d.shape
    E, C = m.n_experts, capacity(T, cfg)
    logits = x2d.float() @ router_w                          # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, m.top_k)              # (G, T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, k) in its expert's queue, counted over the
    # flattened (T * k) priority order
    flat = F.one_hot(gate_idx, E).float().reshape(G, T * m.top_k, E)
    pos = torch.cumsum(flat, dim=1) - flat                   # (G, T*k, E)
    slot = (pos * flat).sum(-1).reshape(G, T, m.top_k)
    keep = (slot < C) & (gate_vals > 0)
    return Routing(logits, probs, gate_vals, gate_idx, slot.long(), keep, C)


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg):
    """x2d: (G, T, d) grouped tokens -> (dispatch, combine, aux_loss).

    dispatch: (G, T, E, C) one-hot; combine: same shape with gate weights.
    """
    r = gate(x2d, router_w, cfg)
    E, C = cfg.moe.n_experts, r.capacity
    onehot = F.one_hot(r.gate_idx, E).float()                # (G, T, k, E)
    # a dropped pair's slot may lie past C: its row of zeros, as
    # jax.nn.one_hot gives for an index out of range
    slot_oh = (F.one_hot(r.slot.clamp(max=C - 1), C).float()
               * r.keep[..., None])                          # (G, T, k, C)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot, slot_oh)
    # one nonzero term a sum: the reference's three-way einsum, exactly
    combine = torch.einsum("gtke,gtkc->gtec",
                           onehot * r.gate_vals[..., None], slot_oh)
    # load-balancing auxiliary loss (Switch)
    density = onehot.sum(2).mean(1)                          # (G, E)
    density_proxy = r.probs.mean(1)                          # (G, E)
    aux = (density * density_proxy).sum(-1).mean() * E
    return dispatch, combine, aux


def apply_moe(p: dict, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    N = B * S
    T = min(GROUP, N)
    if N % T:
        # the reference asserts the same
        raise ValueError(f"{N} tokens do not split into dispatch groups of "
                         f"{T}: a batch of more than {GROUP} tokens must be "
                         f"a multiple of {GROUP}")
    # the reference leaves decode-size token counts (N < 2048) to GSPMD's
    # propagation; DTensor's propagation through the unconstrained dispatch
    # loses a gradient's layout, so on a mesh the port constrains every
    # count (outside a step's hints constrain is the identity)
    xg = constrain(x.reshape(N // T, T, d), "dp", None, None)
    dispatch, combine, aux = route(xg, p["router"], cfg)
    dd, cc = dispatch.to(x.dtype), combine.to(x.dtype)
    # EP when the expert axis divides the model axis, TP on d_ff otherwise
    ep = cfg.moe.n_experts % max(axis_size("tp"), 1) == 0
    names = [n for n in ("w_up", "w_gate", "w_down") if n in p]

    def experts(xg, dd, cc, *w):
        w = dict(zip(names, w))
        xe = torch.einsum("gtd,gtec->gecd", xg, dd)          # (G, E, C, d)
        up = torch.einsum("gecd,edf->gecf", xe, w["w_up"])
        if "w_gate" in w:
            h = gated_act(cfg.act, up,
                          torch.einsum("gecd,edf->gecf", xe, w["w_gate"]))
        else:
            h = F.gelu(up, approximate="tanh")               # jax.nn.gelu
        out = torch.einsum("gecf,efd->gecd", h, w["w_down"])
        return torch.einsum("gecd,gtec->gtd", out, cc)
    # on a mesh the dispatch, the experts' products and the combine run on
    # each rank's own groups and its experts (EP, as the reference lays the
    # dispatched tokens out) or its d_ff slice (TP), the weights gathered
    # over data first (FSDP); the output is then a partial sum over the
    # model axis
    e_ax = "tp" if ep else None
    wspec = {n: ((e_ax, None, None) if ep else (None, None, "tp"))
             for n in ("w_up", "w_gate")}
    wspec["w_down"] = (e_ax, None, None) if ep else (None, "tp", None)
    split = hints_active() and (
        spec_of(tuple(dd.shape), None, None, e_ax, None)[2] is not None
        if ep else
        spec_of(tuple(p["w_down"].shape), None, "tp", None)[1] is not None)
    y = on_ranks(experts, (xg, dd, cc, *(p[n] for n in names)),
                 (("dp", None, None), ("dp", None, e_ax, None),
                  ("dp", None, e_ax, None), *(wspec[n] for n in names)),
                 ((tuple(xg.shape), ("dp", None, None))
                  + (("tp",) if split else ()),))
    # the groups laid out over the rows' axes before they become rows (a
    # split over more ranks than there are rows has no (B, S, d) view)
    y = constrain(y, "dp", None, None)
    return y.reshape(B, S, d), aux


def dense_ffn_params(gen: torch.Generator, cfg, dtype=torch.float32,
                     lead: tuple = ()) -> dict:
    """The FFN weights, each with the leading axes ``lead``."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(gen, lead + (d, f), dtype),
         "w_down": dense_init(gen, lead + (f, d), dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, lead + (d, f), dtype)
    return p


def apply_dense_ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = gated_act(cfg.act, up, x @ p["w_gate"])
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]
