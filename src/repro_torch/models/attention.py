"""GQA attention: chunked (flash-style) prefill and KV-cache decode, the
whisper encoder's self-attention and the decoder's cross attention, on
PyTorch tensors — the counterparts of the reference package's
``models/attention.py``.

:func:`chunked_attention` is the reference's online-softmax scan in plain
torch, every branch kept (causal or not, ``q_offset``, causal block
skipping, ``_divisor_chunk``); it is also the plain version of the
``flash_attention`` kernels.  On the kernel route
(``kernels/flash_attention.py``: the kernels on a CUDA tensor, the plain
versions on a CPU one) the serving prefill (:func:`prefill_attention` with
``inference=True``) runs ``flash_attention``, and the training forward
(``inference=False``) runs ``FlashAttention``, whose gradient is the two
backward kernels; ``use_kernels=False`` runs the scan, through autograd.
The encoder's attention (:func:`encoder_attention`) and the cross attention
(:func:`cross_attention`, keys of their own length) are non-causal: on the
kernel route both run ``flash_attention(..., causal=False)`` where no
gradient is wanted (serving) and ``FlashAttention`` (non-causal, over keys
of their own length) where autograd records the call (training).  As the
reference, q, k and v are constrained to ("dp", None, "tp", None) after the
head reshape (``runtime/hints.py``, the identity outside a mesh step's
hints); on a mesh the training kernels run on each rank's own rows and
heads (``local_map``).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import NEG_INF, FlashAttention, flash_attention
from ..runtime.hints import constrain
from .common import (apply_mrope, apply_rope, dense_init,
                     text_mrope_positions, typed_scale)


def _divisor_chunk(n: int, target: int) -> int:
    """Largest chunk <= target that divides n (handles e.g. whisper's 1500)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def attn_params(gen: torch.Generator, cfg, dtype=torch.float32,
                lead: tuple = ()) -> dict:
    """The projections, each with the leading axes ``lead`` (the stack over
    layer groups)."""
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, lead + (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, lead + (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, lead + (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, lead + (cfg.n_heads * hd, d), dtype),
    }


def _project_qkv(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor,
                 repeat_kv: bool = False):
    """QKV projections.  With ``repeat_kv`` the KV weight blocks are
    broadcast to all H query heads before the matmul, as the reference
    does, so k and v come out with the full H head axis."""
    B, S, _ = x.shape
    hd, KH, H = cfg.hd, cfg.n_kv_heads, cfg.n_heads
    G = H // KH
    wk, wv = p["wk"], p["wv"]
    if repeat_kv and G > 1:
        d = wk.shape[0]
        wk = wk.reshape(d, KH, hd).repeat_interleave(G, dim=1).reshape(
            d, H * hd)
        wv = wv.reshape(d, KH, hd).repeat_interleave(G, dim=1).reshape(
            d, H * hd)
        KH = H
    q = constrain((x @ p["wq"]).reshape(B, S, H, hd), "dp", None, "tp", None)
    k = constrain((x @ wk).reshape(B, S, KH, hd), "dp", None, "tp", None)
    v = constrain((x @ wv).reshape(B, S, KH, hd), "dp", None, "tp", None)
    if cfg.rope == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        mpos = text_mrope_positions(pos)
        q = apply_mrope(q, mpos, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mpos, cfg.mrope_sections, cfg.rope_theta)
    return q, k, v


def _flash_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """``FlashAttention`` on q, k, v (B, S, H, D), k and v with q's H heads.
    On a mesh (DTensors, laid out ("dp", None, "tp", None) by the hints:
    rows and heads split, every position whole) the kernels run on each
    rank's own rows and heads, plain contiguous tensors, and the output
    keeps that layout."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal)
    from torch.distributed.tensor.experimental import local_map
    q, k, v = (constrain(t, "dp", None, "tp", None) for t in (q, k, v))
    pl = q.placements
    if k.placements != pl or v.placements != pl:
        raise ValueError(f"q, k, v laid out {pl}, {k.placements}, "
                         f"{v.placements}: the kernels take one layout")
    fn = local_map(lambda q, k, v: FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal),
        out_placements=list(pl), in_placements=(pl, pl, pl),
        device_mesh=q.device_mesh)
    return fn(q, k, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, chunk: int = 1024, q_chunk: int = 512,
                      q_offset: int = 0, skip_masked: bool = False,
                      return_lse: bool = False):
    """Flash-style online-softmax attention: an outer loop over query
    blocks, an inner one over KV blocks.

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H a multiple of KH (GQA; KV
    heads are repeated to H).  With ``skip_masked`` and ``causal`` only the
    KV blocks at or below a query block's diagonal run.  With
    ``return_lse`` it returns ``(out, lse, out_wide)``, lse each row's
    log-sum-exp of the scaled scores, ``m + log(max(l, 1e-30))``, as (B, H,
    Sq) f32, and out_wide the output in f32 before its rounding to q's type
    (the gradient's rowsum(dO * O) takes it, as autodiff of this function
    takes the f32 output).
    """
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    # q * D ** -0.5 rounds to q's type before the f32 blocks (bf16: q^)
    scale = typed_scale(D ** -0.5, q.dtype)
    chunk = _divisor_chunk(Sk, chunk)
    q_chunk = _divisor_chunk(Sq, q_chunk)
    nk, nq = Sk // chunk, Sq // q_chunk
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    kb = k.reshape(B, nk, chunk, H, D)
    vb = v.reshape(B, nk, chunk, H, D)
    qb = (q * scale).reshape(B, nq, q_chunk, H, D)
    dev = q.device
    blocks, lses, wides = [], [], []
    for iq in range(nq):
        qf = qb[:, iq].float()
        q_pos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, H), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_chunk, H), dtype=torch.float32, device=dev)
        o = torch.zeros((B, q_chunk, H, D), dtype=torch.float32, device=dev)
        n_run = nk
        if skip_masked and causal:
            n_run = min(((iq + 1) * q_chunk + q_offset + chunk - 1) // chunk,
                        nk)
        for jk in range(n_run):
            s = torch.einsum("bqhd,bkhd->bqhk", qf, kb[:, jk].float())
            if causal:
                k_pos = jk * chunk + torch.arange(chunk, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bqhk,bkhd->bqhd", p, vb[:, jk].float())
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(out.to(q.dtype))
        if return_lse:
            lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
            wides.append(out)
    out = torch.stack(blocks, dim=1).reshape(B, Sq, H, D)
    if return_lse:
        return (out, torch.cat(lses, dim=1).transpose(1, 2).contiguous(),
                torch.stack(wides, dim=1).reshape(B, Sq, H, D))
    return out


def prefill_attention(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor, *,
                      chunk: int = 1024, inference: bool = False,
                      use_kernels: bool = True):
    """Full-sequence causal self-attention; returns (out, (k, v) cache).
    The returned cache keeps the true KH KV heads (strided slice of the
    weight-repeated heads).  ``inference`` enables causal block skipping
    (forward only) and, with ``use_kernels``, the ``flash_attention``
    kernel route; without ``inference``, ``use_kernels`` takes the training
    route, ``FlashAttention`` (the lse forward and the backward kernels).
    GQA as the reference: the KV weights are repeated to H heads, so
    autograd sums dK and dV back over the G copies."""
    B, S, _ = x.shape
    G = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, pos, repeat_kv=True)
    if inference and use_kernels:
        out = flash_attention(q, k, v, causal=True)
    elif use_kernels:
        out = _flash_train(q, k, v, True)
    else:
        out = chunked_attention(q, k, v, causal=True, chunk=min(chunk, S),
                                skip_masked=inference)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, (k[:, :, ::G], v[:, :, ::G])


def decode_attention(p: dict, x: torch.Tensor, cfg, cache: tuple,
                     pos: torch.Tensor):
    """Single-token decode against a (B, S_max, KH, D) KV cache.

    ``pos``: (B,) absolute position of the incoming token.  The new k and v
    are written into the cache tensors at ``pos`` in place (the reference
    returns updated copies; in place saves a copy of the cache per layer
    and step), and positions > pos are masked out.  Returns (out, (k cache,
    v cache)), the same tensors."""
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode_attention takes one token, got {S1}")
    ck, cv = cache
    S_max = ck.shape[1]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(ck.shape[0], device=ck.device)
    ck[rows, pos] = k[:, 0].to(ck.dtype)
    cv[rows, pos] = v[:, 0].to(cv.dtype)
    KH, D = cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KH
    qf = (q * typed_scale(D ** -0.5, q.dtype)).reshape(B, KH, G, D).to(
        ck.dtype)
    # the reference's mixed-precision dots: the cache's type in, f32 sums
    # and result (a bf16 product is exact in f32)
    s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), ck.float())
    mask = torch.arange(S_max, device=ck.device)[None] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w.to(cv.dtype).float(), cv.float())
    out = o.reshape(B, 1, cfg.n_heads * D).to(x.dtype) @ p["wo"]
    return out, (ck, cv)


def _noncausal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               chunk: int, use_kernels: bool) -> torch.Tensor:
    """Non-causal attention of q (B, Sq, H, D) over k, v (B, Sk, KH, D):
    the kernel route (the KV heads repeated to H first where KH < H;
    ``FlashAttention`` where a gradient is wanted, ``flash_attention``
    otherwise, as :func:`prefill_attention` picks by ``inference``) or the
    reference's scan in chunks of ``min(chunk, Sk)`` keys."""
    if not use_kernels:
        return chunked_attention(q, k, v, causal=False,
                                 chunk=min(chunk, k.shape[1]))
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash_train(q, k, v, False)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=False)


def cross_kv(p: dict, enc: torch.Tensor, cfg) -> tuple:
    """The encoder output's keys and values for one decoder layer's cross
    attention, (B, T, KH, D) each: what a prefill writes to the cache as
    ``xk`` and ``xv``."""
    B, T, _ = enc.shape
    k = (enc @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    v = (enc @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    return k, v


def cross_attention(p: dict, x: torch.Tensor, kv: tuple, cfg,
                    chunk: int = 512, use_kernels: bool = True
                    ) -> torch.Tensor:
    """Decoder -> encoder cross attention (whisper): the queries of x (B,
    S, d) over ``kv``, the encoder output's keys and values from
    :func:`cross_kv` (projected once for the attention and the cache) or
    the cache's in a decode step (S = 1).  The reference projects them
    from the encoder output inside; no rotary embedding, as there."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    out = _noncausal(q, *kv, chunk, use_kernels)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


def encoder_attention(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor,
                      chunk: int = 512, use_kernels: bool = True
                      ) -> torch.Tensor:
    """Non-causal self-attention of the whisper encoder over x (B, T,
    d)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, pos, repeat_kv=True)
    out = _noncausal(q, k, v, chunk, use_kernels)
    return out.reshape(B, T, cfg.n_heads * cfg.hd) @ p["wo"]
