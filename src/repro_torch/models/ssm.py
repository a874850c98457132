"""State-space and recurrent mixers on PyTorch tensors: Mamba (jamba),
mLSTM and sLSTM (xLSTM) — the counterparts of the reference package's
``models/ssm.py``, with its names, parameter trees and state layouts.

* **Mamba**: the selective SSM.  The prefill scans over time with an
  f32 (B, d_inner, d_state) carry; decode is one step of the same update.
  The port runs the scan as a Python loop, :data:`SCAN_CHUNK` steps at a
  time: each chunk's discretisation (``exp(delta A)`` and ``delta B x``)
  is computed for all its steps at once, then every step is two
  elementwise launches, and the chunk's states are stacked for y.
* **mLSTM**: the matrix-memory LSTM in the chunkwise-parallel form of gated
  linear attention: within a chunk of :data:`MLSTM_CHUNK` steps an
  attention-like block, between chunks the (C, n) state carried forward.
  q and k take diagonal (per-channel) transforms.
* **sLSTM**: the scalar-memory LSTM with a block-diagonal (per-head)
  recurrence and the stabiliser ``m``; sequential, one step at a time.

Each scan is functional (no ``out=``, no in-place op), so autograd takes
it as it is.  Serving and decode (no tensor that autograd records) run it
plain.  Training (grad enabled and the input or a parameter requiring a
gradient, :func:`_records`) runs the same chunks under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` at two
levels bounds a backward's memory: Mamba's and sLSTM's steps in chunks of
:data:`SCAN_CHUNK`, only each chunk's carry saved; mLSTM's chunks each
checkpointed, and grouped n2 at a time under an outer checkpoint, n1 the
largest divisor of the chunk count n at most sqrt(n), so O(sqrt(n)) (C,
n) carries are saved.  The forward values do not depend on the
checkpoints, nor do the gradients.  The loops launch a few small
kernels a step on the card; ROADMAP.md's "The recurrent scans" sizes a
scan kernel from that.

Every state is f32, as in the reference (Mamba's ``conv`` window takes the
cache dtype).  ``jax.nn.softplus`` and ``jax.nn.log_sigmoid`` are
``F.softplus`` and ``F.logsigmoid``: torch's softplus returns x itself
above its threshold of 20, where ``log1p(exp(-x))`` is below 2.1e-9, less
than half an f32 ulp of 20, so the two round alike.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..runtime.hints import merge_heads, on_ranks, split_heads
from .common import dense_init, typed_scale

# Mamba prefill steps whose discretisation is computed at once (bounds the
# (B, L, d_inner, d_state) temporaries); also the steps of a Mamba or sLSTM
# chunk the training route checkpoints
SCAN_CHUNK = 128


def _records(p: dict, x: torch.Tensor) -> bool:
    """Whether autograd records a mixer call: grad enabled and ``x`` or a
    parameter requiring a gradient (the serving engine runs with grad
    enabled on leaves that require none)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.values()))


def _chunked(fn, remat: bool):
    """``fn`` under a non-reentrant checkpoint, or as it is."""
    if not remat:
        return fn
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


# =============================================================================
# Mamba
# =============================================================================

def mamba_params(gen: torch.Generator, cfg, dtype=torch.float32,
                 lead: tuple = ()) -> dict:
    """In/out projections, the causal conv, the input-dependent (dt, B, C)
    projection, ``A_log`` = log(1..d_state) and ``D`` = 1 (both f32), each
    with the leading axes ``lead``."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    dt_rank = max(di // 16, 1)
    dev = gen.device
    a_log = np.log(np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                                   lead + (di, ds)))
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di), dtype),
        "conv_w": dense_init(gen, lead + (cfg.d_conv, di), dtype, scale=0.5),
        "x_proj": dense_init(gen, lead + (di, dt_rank + 2 * ds), dtype),
        "dt_proj": dense_init(gen, lead + (dt_rank, di), dtype),
        "A_log": torch.as_tensor(a_log, dtype=torch.float32, device=dev),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, lead + (di, d), dtype),
    }


def _mamba_dbc(p: dict, xin: torch.Tensor, cfg):
    """delta (B, S, di), Bmat and Cmat (B, S, ds), f32, from the conv
    output."""
    dt_rank = p["dt_proj"].shape[0]
    proj = xin @ p["x_proj"]
    dt, Bm, Cm = proj.split([dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"]).float()
    return delta, Bm.float(), Cm.float()


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time.  x: (B, S, di); w: (K, di);
    ``state``: (B, K - 1, di), the previous inputs (decode), or None (zero
    padding).  Returns (out, the last K - 1 inputs)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, S+K-1, di)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out, new_state


def _mamba_chunk(h, delta, Bm, Cm, xf, A):
    """L steps of the scan from the carry ``h`` (B, di, ds): the chunk's
    discretisation at once, then h_t = exp(delta_t A) h_{t-1} + delta_t B_t
    x_t a step; y_t = <h_t, C_t> over the state axis.  delta, xf: (B, L,
    di); Bm, Cm: (B, L, ds).  Returns (h_L, y (B, L, di))."""
    dt = delta[:, :, :, None]                              # (B, L, di, 1)
    da = torch.exp(dt * A)                                 # (B, L, di, ds)
    dbx = dt * Bm[:, :, None, :] * xf[:, :, :, None]
    hs = []
    for da_t, dbx_t in zip(da.unbind(1), dbx.unbind(1)):
        h = da_t * h + dbx_t
        hs.append(h)
    return h, (torch.stack(hs, dim=1) * Cm[:, :, None, :]).sum(-1)


def _mamba_scan(h, delta, Bm, Cm, xf, A, remat: bool) -> tuple:
    """:func:`_mamba_chunk` over S steps, SCAN_CHUNK at a time, each chunk
    checkpointed where ``remat`` (training: the backward saves one (B, di,
    ds) carry a chunk and recomputes the chunk's steps).  Returns (h_S, y
    (B, S, di))."""
    chunk = _chunked(_mamba_chunk, remat)
    ys = []
    for t0 in range(0, delta.shape[1], SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        h, y = chunk(h, delta[:, sl], Bm[:, sl], Cm[:, sl], xf[:, sl], A)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def mamba_forward(p: dict, x: torch.Tensor, cfg):
    """Full-sequence selective scan.  x: (B, S, d) -> (y, final state
    ``{"conv", "h"}``)."""
    B = x.shape[0]
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xin, conv_state = _causal_conv(xin, p["conv_w"])
    xin = F.silu(xin)
    delta, Bm, Cm = _mamba_dbc(p, xin, cfg)
    A = -torch.exp(p["A_log"])                              # (di, ds)
    xf = xin.float()
    remat = _records(p, x)

    def scan(delta, Bm, Cm, xf, A):
        h0 = torch.zeros((delta.shape[0], delta.shape[2], A.shape[1]),
                         dtype=torch.float32, device=delta.device)
        return _mamba_scan(h0, delta, Bm, Cm, xf, A, remat=remat)
    # on a mesh the scan runs on each rank's own rows and channels, every
    # step whole
    h, ys = on_ranks(scan, (delta, Bm, Cm, xf, A),
                     (("dp", None, "tp"), ("dp", None, None),
                      ("dp", None, None), ("dp", None, "tp"), ("tp", None)),
                     (((B, cfg.d_inner, cfg.d_state), ("dp", "tp", None)),
                      (tuple(delta.shape), ("dp", None, "tp"))))
    y = ys + xf * p["D"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, {"conv": conv_state, "h": h}


def mamba_decode(p: dict, x: torch.Tensor, cfg, cache: dict):
    """Single-token update.  x: (B, 1, d) -> (y (B, 1, d), new state)."""
    xin, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    xin3, conv_state = _causal_conv(xin[:, None], p["conv_w"], cache["conv"])
    xin = F.silu(xin3[:, 0])
    delta, Bm, Cm = _mamba_dbc(p, xin[:, None], cfg)
    delta, Bm, Cm = delta[:, 0], Bm[:, 0], Cm[:, 0]
    A = -torch.exp(p["A_log"])
    da = torch.exp(delta[..., None] * A)
    db = delta[..., None] * Bm[:, None, :]
    xf = xin.float()
    h = da * cache["h"] + db * xf[..., None]
    y = (h * Cm[:, None, :]).sum(-1) + xf * p["D"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y[:, None], {"conv": conv_state, "h": h}


def mamba_cache(B: int, cfg, dtype=torch.float32,
                device: str | torch.device = "cpu") -> dict:
    return {"conv": torch.zeros((B, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((B, cfg.d_inner, cfg.d_state),
                             dtype=torch.float32, device=device)}


# =============================================================================
# mLSTM — chunkwise-parallel gated linear attention
# =============================================================================

MLSTM_CHUNK = 64


def mlstm_params(gen: torch.Generator, cfg, dtype=torch.float32,
                 lead: tuple = ()) -> dict:
    """The in/out projections, the diagonal q/k transforms (ones), the
    per-head input and forget gate projection (f32) and its bias (0 for
    the input gates, 3 for the forget gates)."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    dev = gen.device
    bias = torch.cat([torch.zeros(H), 3.0 * torch.ones(H)])
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di), dtype),
        "wq": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "wk": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "gate_proj": dense_init(gen, lead + (d, 2 * H), torch.float32,
                                scale=0.02),
        "gate_bias": bias.expand(lead + (2 * H,)).to(dev).clone(),
        "out_proj": dense_init(gen, lead + (di, d), dtype),
    }


def _mlstm_qkv_gates(p: dict, x: torch.Tensor, cfg):
    B, S, _ = x.shape
    H = cfg.n_heads
    dh = cfg.d_inner // H
    xm, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    q = split_heads(xm * p["wq"], H, dh)
    k = split_heads(xm * p["wk"], H, dh) * typed_scale(dh ** -0.5, xm.dtype)
    v = split_heads(xm, H, dh)
    gates = x.float() @ p["gate_proj"] + p["gate_bias"]
    i_gate, f_gate = gates.chunk(2, dim=-1)                  # (B, S, H)
    log_f = F.logsigmoid(f_gate)
    i_gate = torch.exp(F.logsigmoid(i_gate))                 # in (0, 1)
    return q, k, v, i_gate, log_f, z


def _mlstm_chunk(C, nrm, qf, kf, vf, ic, lfc):
    """One chunk of L steps: (C (B, H, dh, dh), n (B, H, dh)) carried in,
    q/k/v (B, L, H, dh) f32, the input gates and log forget gates (B, L,
    H).  Returns (C', n', y (B, L, H, dh))."""
    L = qf.shape[1]
    Fc = torch.cumsum(lfc, dim=1)                            # (B, L, H)
    Ftot = Fc[:, -1]                                         # (B, H)
    # intra-chunk: decay(t, s) = exp(F_t - F_s) for s <= t
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :]             # (B, L, L, H)
    causal = torch.ones((L, L), dtype=torch.bool,
                        device=qf.device).tril()
    decay = torch.where(causal[None, :, :, None], torch.exp(dmat), 0.0)
    s = torch.einsum("blhd,bmhd->blmh", qf, kf) * decay \
        * ic[:, None, :, :]                                  # (B, L, L, H)
    y_intra = torch.einsum("blmh,bmhd->blhd", s, vf)
    # inter-chunk: q_t reads the carried state, decayed by exp(F_t)
    qe = qf * torch.exp(Fc)[..., None]
    y_inter = torch.einsum("blhd,bhde->blhe", qe, C)
    nrm_t = torch.einsum("blhd,bhd->blh", qe, nrm) + s.sum(2)
    y = (y_intra + y_inter) / torch.clamp_min(nrm_t.abs()[..., None], 1.0)
    # C' = exp(Ftot) C + sum_s exp(Ftot - F_s) i_s k_s v_s^T
    w = torch.exp(Ftot[:, None] - Fc) * ic                   # (B, L, H)
    kw = kf * w[..., None]
    C_new = torch.exp(Ftot)[..., None, None] * C + torch.einsum(
        "blhd,blhe->bhde", kw, vf)
    nrm_new = torch.exp(Ftot)[..., None] * nrm + kw.sum(1)
    return C_new, nrm_new, y


def _mlstm_chunks(C, nrm, xs: tuple, L: int, remat: bool) -> tuple:
    """:func:`_mlstm_chunk` over ``xs`` = (q, k, v, input gates, log
    forget gates), time on axis 1, L steps at a time, each chunk
    checkpointed where ``remat``.  Returns (C, n, y (B, S, H, dh))."""
    chunk = _chunked(_mlstm_chunk, remat)
    ys = []
    for t0 in range(0, xs[0].shape[1], L):
        C, nrm, y = chunk(C, nrm, *(a[:, t0:t0 + L] for a in xs))
        ys.append(y)
    return C, nrm, torch.cat(ys, dim=1)


def _mlstm_scan_train(C, nrm, xs: tuple, L: int) -> tuple:
    """:func:`_mlstm_chunks` for autograd, as the reference's two-level
    scan: the n chunks in n1 groups of n2, n1 the largest divisor of n at
    most sqrt(n); each group under an outer checkpoint and each chunk under
    its own, so the backward saves n1 outer carries and, while it walks a
    group, that group's n2."""
    n = xs[0].shape[1] // L
    n1 = next(c for c in range(int(n ** 0.5), 0, -1) if n % c == 0)
    group = _chunked(functools.partial(_mlstm_chunks, L=L, remat=True),
                     True)
    span = (n // n1) * L
    ys = []
    for t0 in range(0, n * L, span):
        C, nrm, y = group(C, nrm, tuple(a[:, t0:t0 + span] for a in xs))
        ys.append(y)
    return C, nrm, torch.cat(ys, dim=1)


def mlstm_forward(p: dict, x: torch.Tensor, cfg):
    """Chunkwise-parallel form.  x: (B, S, d) -> (y, state ``{"C",
    "n"}``).  S must be a multiple of its chunk, min(MLSTM_CHUNK, S), as in
    the reference."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    L = min(MLSTM_CHUNK, S)
    if S % L:
        raise ValueError(f"mlstm_forward: sequence length {S} is not a "
                         f"multiple of its chunk {L}")
    q, k, v, ig, lf, z = _mlstm_qkv_gates(p, x, cfg)
    remat = _records(p, x)

    def scan(*xs):
        b, h = xs[0].shape[0], xs[0].shape[2]
        C = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                        device=xs[0].device)
        nrm = torch.zeros((b, h, dh), dtype=torch.float32,
                          device=xs[0].device)
        if remat:
            return _mlstm_scan_train(C, nrm, xs, L)
        return _mlstm_chunks(C, nrm, xs, L, remat=False)
    # on a mesh the chunks run on each rank's own rows and heads
    heads, gates = ("dp", None, "tp", None), ("dp", None, "tp")
    C, nrm, y = on_ranks(scan, (q.float(), k.float(), v.float(), ig, lf),
                         (heads, heads, heads, gates, gates),
                         (((B, H, dh, dh), ("dp", "tp", None, None)),
                          ((B, H, dh), ("dp", "tp", None)),
                          (tuple(q.shape), heads)))
    y = merge_heads(y).to(x.dtype)
    y = (y * F.silu(z)) @ p["out_proj"]
    return y, {"C": C, "n": nrm}


def mlstm_decode(p: dict, x: torch.Tensor, cfg, cache: dict):
    B = x.shape[0]
    q, k, v, ig, lf, z = _mlstm_qkv_gates(p, x, cfg)

    def step(q, k, v, ig, lf, C, nrm):
        qf, kf, vf = (a[:, 0].float() for a in (q, k, v))    # (B, H, dh)
        f = torch.exp(lf[:, 0])                              # (B, H)
        i = ig[:, 0]
        C = f[..., None, None] * C + i[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", kf, vf)
        nrm = f[..., None] * nrm + i[..., None] * kf
        y = torch.einsum("bhd,bhde->bhe", qf, C)
        denom = torch.clamp_min(torch.einsum("bhd,bhd->bh", qf, nrm).abs(),
                                1.0)
        return C, nrm, y / denom[..., None]
    # on a mesh the update runs on each rank's own rows, every head
    rows = (("dp", None, None, None), ("dp", None, None))
    C, nrm, y = on_ranks(step, (q, k, v, ig, lf, cache["C"], cache["n"]),
                         (rows[0],) * 3 + (rows[1],) * 2 + rows,
                         tuple((tuple(t.shape), spec) for t, spec in
                               zip((cache["C"], cache["n"], cache["n"]),
                                   rows + (rows[1],))))
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = (y * F.silu(z)) @ p["out_proj"]
    return y, {"C": C, "n": nrm}


def mlstm_cache(B: int, cfg, dtype=torch.float32,
                device: str | torch.device = "cpu") -> dict:
    H, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    return {"C": torch.zeros((B, H, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((B, H, dh), dtype=torch.float32, device=device)}


# =============================================================================
# sLSTM — scalar memory, block-diagonal recurrence, sequential scan
# =============================================================================

def slstm_params(gen: torch.Generator, cfg, dtype=torch.float32,
                 lead: tuple = ()) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "w_in": dense_init(gen, lead + (d, 4 * d), dtype),
        "r": dense_init(gen, lead + (H, dh, 4 * dh), dtype,
                        scale=0.3 / dh ** 0.5),
        "bias": torch.zeros(lead + (4 * d,), dtype=torch.float32,
                            device=gen.device),
        "out_proj": dense_init(gen, lead + (d, d), dtype),
    }


def _slstm_step(p: dict, cfg, carry: tuple, zx: torch.Tensor) -> tuple:
    """One timestep of the stabilised sLSTM.  carry: (h, c, n, m), each
    (B, d) f32; zx: (B, 4d), the input projection."""
    h, c, n, m = carry
    B, d = h.shape
    H = cfg.n_heads
    dh = d // H
    rec = torch.einsum("bhx,hxy->bhy", h.reshape(B, H, dh).float(),
                       p["r"].float()).reshape(B, 4 * d)
    g = zx.float() + rec + p["bias"]
    zi, ii, fi, oi = g.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    log_i, log_f = ii, F.logsigmoid(fi)
    m_new = torch.maximum(log_f + m, log_i)                  # stabiliser
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * zt
    n_new = f_s * n + i_s
    h_new = ot * c_new / torch.clamp_min(n_new, 1.0)
    return (h_new, c_new, n_new, m_new)


def _slstm_chunk(p: dict, cfg, carry: tuple, zx: torch.Tensor) -> tuple:
    """:func:`_slstm_step` over the steps of ``zx`` (B, L, 4d): (the last
    carry, h of every step (B, L, d))."""
    hs = []
    for z_t in zx.unbind(1):
        carry = _slstm_step(p, cfg, carry, z_t)
        hs.append(carry[0])
    return carry, torch.stack(hs, dim=1)


def _slstm_scan_train(p: dict, cfg, carry: tuple, zx: torch.Tensor
                      ) -> tuple:
    """The sLSTM scan for autograd: SCAN_CHUNK steps a checkpoint, so the
    backward saves one (h, c, n, m) carry a chunk."""
    chunk = _chunked(_slstm_chunk, True)
    hs = []
    for t0 in range(0, zx.shape[1], SCAN_CHUNK):
        carry, h = chunk(p, cfg, carry, zx[:, t0:t0 + SCAN_CHUNK])
        hs.append(h)
    return carry, torch.cat(hs, dim=1)


def slstm_forward(p: dict, x: torch.Tensor, cfg):
    B, S, d = x.shape
    zx = x @ p["w_in"]                                       # (B, S, 4d)
    run = _slstm_scan_train if _records(p, x) else _slstm_chunk

    def scan(zx, r, bias):
        carry = tuple(torch.zeros((zx.shape[0], d), dtype=torch.float32,
                                  device=zx.device) for _ in range(4))
        carry, hs = run({"r": r, "bias": bias}, cfg, carry, zx)
        return (*carry, hs)
    # on a mesh the recurrence runs on each rank's own rows, every head
    *carry, hs = on_ranks(scan, (zx, p["r"], p["bias"]),
                          (("dp", None, None), (None, None, None), (None,)),
                          (((B, d), ("dp", None)),) * 4
                          + (((B, S, d), ("dp", None, None)),))
    y = hs.to(x.dtype) @ p["out_proj"]
    return y, dict(zip(("h", "c", "n", "m"), carry))


def slstm_decode(p: dict, x: torch.Tensor, cfg, cache: dict):
    zx = x[:, 0] @ p["w_in"]
    carry = tuple(cache[n] for n in ("h", "c", "n", "m"))

    def step(zx, r, bias, *carry):
        return _slstm_step({"r": r, "bias": bias}, cfg, carry, zx)
    # on a mesh the step runs on each rank's own rows, every head
    h, c, n, m = on_ranks(step, (zx, p["r"], p["bias"], *carry),
                          (("dp", None), (None, None, None), (None,))
                          + (("dp", None),) * 4,
                          ((tuple(carry[0].shape), ("dp", None)),) * 4)
    y = h[:, None].to(x.dtype) @ p["out_proj"]
    return y, {"h": h, "c": c, "n": n, "m": m}


def slstm_cache(B: int, cfg, dtype=torch.float32,
                device: str | torch.device = "cpu") -> dict:
    return {k: torch.zeros((B, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("h", "c", "n", "m")}
