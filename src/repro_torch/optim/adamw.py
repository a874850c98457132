"""AdamW with optionally block-quantised (int8) moment states, on PyTorch
tensors — the counterpart of the reference package's ``optim/adamw.py``.

The quantised variant stores each moment as int8 mantissas with one f32
scale per row of the last axis (``quantize_states``): 1 byte a value in
place of 4.  For yi-6b on one 80 GB card that is the difference between
fitting and not fitting: f32 parameters, gradients and f32 moments take
97 GB; with int8 moments about 61 GB.

The arithmetic is the reference's, operation for operation in f32: the
schedule and the bias corrections ``b ** step`` in f32, weight decay on
every leaf of two or more axes (so on the stacked norm scales, not on
``final_norm``), ``round`` half to even, the scale floored at 1e-20.  The
update runs in place: each leaf is taken in slices along its first axis
(one layer group of a stacked leaf, or a block of rows; every step but the
per-row scale is elementwise, and the scale is per row of the last axis,
so the slices give the reference's numbers), so that the card holds a few
slice-sized temporaries, not six leaf-sized ones; and each gradient is
dropped once its leaf is done.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.model import _leaves

#: elements of one slice of the in-place update (256 MB of f32)
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_states: bool = False     # int8 m/v with per-row scales
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# -- int8 row-quantised storage ------------------------------------------------

def _q8(x: torch.Tensor, row_amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise along the last axis: int8 payload + f32 row scale.
    ``row_amax`` turns a local row maximum into the whole row's (a
    parameter whose last axis is sharded)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if row_amax is not None:
        amax = row_amax(amax)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _node(tree: dict, path: str) -> tuple[dict, str]:
    *keys, leaf = path.split("/")
    for k in keys:
        tree = tree[k]
    return tree, leaf


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in the parameters' tree and on their devices, and the
    step count, an int32 scalar on the first parameter's device."""
    dev = next(_leaves(params))[1].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if not cfg.quantize_states:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
                "step": step}

    def qzeros(p):
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                                 device=p.device)}
    return {"m": _tree_map(qzeros, params), "v": _tree_map(qzeros, params),
            "step": step}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (sums in another
    order than XLA's)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in _leaves(tree)))


def _slices(n0: int, row: int):
    """Row ranges of a leaf's first axis, each of at most SLICE_ELEMS
    elements (at least one row)."""
    step = max(1, SLICE_ELEMS // max(row, 1))
    return [(i, min(i + step, n0)) for i in range(0, n0, step)]


def adamw_update(params: Any, grads: Any, state: dict,
                 cfg: AdamWConfig, *, grad_norm: torch.Tensor | None = None,
                 row_amax: dict | None = None) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (params, state, metrics).

    The port updates ``params`` and ``state`` in place and returns them;
    ``grads`` is consumed: each leaf is set to ``None`` in it once its
    update is done.  On a mesh the trees are each rank's local shards:
    ``grad_norm`` is then the whole gradient's norm, and ``row_amax`` maps
    a leaf's name to the function that makes a local row maximum the whole
    row's, for the int8 states of a leaf whose last axis is sharded."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    quant = cfg.quantize_states
    stepf = step.to(torch.float32)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v, decay: bool, amax_fn=None):
        g = g.to(torch.float32) * clip
        m_f = _dq8(m["q"], m["s"]) if quant else m
        v_f = _dq8(v["q"], v["s"]) if quant else v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        u = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        if decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        if quant:
            for st, x in ((m, m_f), (v, v_f)):
                q, s = _q8(x, amax_fn)
                st["q"].copy_(q)
                st["s"].copy_(s)
        else:
            m.copy_(m_f)
            v.copy_(v_f)

    with torch.no_grad():
        for name, p in list(_leaves(params)):
            gnode, key = _node(grads, name)
            g = gnode[key]
            m = _node(state["m"], name)[0][key]
            v = _node(state["v"], name)[0][key]
            amax_fn = (row_amax or {}).get(name)
            if p.dim() < 2:
                upd(p, g, m, v, decay=False, amax_fn=amax_fn)
            else:
                for a, b in _slices(p.shape[0], p[0].numel()):
                    upd(p[a:b], g[a:b], _tree_map(lambda t: t[a:b], m),
                        _tree_map(lambda t: t[a:b], v), decay=True,
                        amax_fn=amax_fn)
            gnode[key] = None
        state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def opt_state_bytes(state: dict) -> int:
    return sum(x.numel() * x.element_size() for _, x in _leaves(state))


__all__ = ["AdamWConfig", "schedule", "init_opt_state", "global_norm",
           "adamw_update", "opt_state_bytes"]
