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
hints).

On a mesh (DTensors, a step's hints active) every attention kernel, the
serving ``flash_attention`` and the training ``FlashAttention``, runs on
each rank's own rows and heads (``local_map``).  A prefill lays the
prompt's keys and values out as the cache pages it is given
(``cache_shardings``: the sequence split over ``model``, or over
(``data``, ``model``) when the rows do not split): the weight-repeated
heads, padded to the page's length, move from a head split to a sequence
split (an all-to-all), then each rank keeps every G-th head.  A decode
writes the new key and value only on the rank that holds its position, and
takes the softmax over the split key axis as a split softmax: each rank's
maximum and sum of exponentials all-reduced over the axes that split the
sequence, then the weighted values; no cache page leaves its rank.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import NEG_INF, FlashAttention, flash_attention
from ..runtime.hints import (constrain, merge_heads, split_heads,
                             whole_heads)
from ..runtime.sharding import contiguous_strides
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
        # on a mesh the repeated weights keep their heads whole where the
        # KH heads do not split, so that their gradient takes the (d, KH,
        # G, hd) view that sums the G copies
        wk = whole_heads(whole_heads(wk, KH).reshape(d, KH, hd)
                         .repeat_interleave(G, dim=1).reshape(d, H * hd), KH)
        wv = whole_heads(whole_heads(wv, KH).reshape(d, KH, hd)
                         .repeat_interleave(G, dim=1).reshape(d, H * hd), KH)
        KH = H
    q = split_heads(x @ p["wq"], H, hd)
    k = split_heads(x @ wk, KH, hd)
    v = split_heads(x @ wv, KH, hd)
    if cfg.rope == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        mpos = text_mrope_positions(pos)
        q = apply_mrope(q, mpos, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mpos, cfg.mrope_sections, cfg.rope_theta)
    return q, k, v


def _local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """``fn(q, k, v)`` on q (B, Sq, H, D) and k, v (B, Sk, H, D), plain
    contiguous tensors.  On a mesh (DTensors) q, k and v are laid out
    ("dp", None, "tp", None) (rows and heads split, every position whole)
    and ``fn`` runs on each rank's own rows and heads; the output keeps
    that layout."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return fn(q.contiguous(), k.contiguous(), v.contiguous())
    from torch.distributed.tensor.experimental import local_map
    q, k, v = (constrain(t, "dp", None, "tp", None) for t in (q, k, v))
    pl = q.placements
    if k.placements != pl or v.placements != pl:
        raise ValueError(f"q, k, v laid out {pl}, {k.placements}, "
                         f"{v.placements}: the kernels take one layout")
    run = local_map(lambda q, k, v: fn(q.contiguous(), k.contiguous(),
                                       v.contiguous()),
                    out_placements=list(pl), in_placements=(pl, pl, pl),
                    device_mesh=q.device_mesh)
    return run(q, k, v)


def _flash_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """``FlashAttention`` on q, k, v (B, S, H, D), k and v with q's H heads,
    on each rank's own rows and heads on a mesh (:func:`_local_heads`)."""
    return _local_heads(lambda q, k, v: FlashAttention.apply(q, k, v, causal),
                        q, k, v)


def _flash_serve(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """``flash_attention`` (no gradient) likewise."""
    return _local_heads(lambda q, k, v: flash_attention(q, k, v,
                                                        causal=causal),
                        q, k, v)


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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _page(t: torch.Tensor, G: int, like: torch.Tensor) -> torch.Tensor:
    """A cache page of ``like``'s shape (B, s_max, KH, D), type and layout
    holding the prompt's keys or values ``t`` (B, S, H, D), H = G KH
    weight-repeated heads, in its first S positions and zeros after.  On a
    mesh ``t`` is padded to s_max on each rank (every position is whole
    there), moved to ``like``'s row and sequence split with its heads whole
    (an all-to-all where the heads were split), and each rank keeps every
    G-th head of its own block."""
    S = t.shape[1]
    if not _is_dtensor(t):
        c = torch.zeros_like(like)
        c[:, :S] = t[:, :, ::G].to(c.dtype)
        return c
    from torch.distributed.tensor import DTensor
    mesh = like.device_mesh
    loc = t.to_local()
    pad = loc.new_zeros((loc.shape[0], like.shape[1]) + tuple(loc.shape[2:]))
    pad[:, :S] = loc
    shape = (t.shape[0], like.shape[1]) + tuple(t.shape[2:])
    full = DTensor.from_local(pad, mesh, t.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))
    mine = full.redistribute(mesh, like.placements).to_local()
    return DTensor.from_local(mine[:, :, ::G].to(like.dtype).contiguous(),
                              mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def prefill_attention(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor, *,
                      chunk: int = 1024, inference: bool = False,
                      use_kernels: bool = True, pages: tuple | None = None):
    """Full-sequence causal self-attention; returns (out, kv).  ``kv`` is
    the prompt's keys and values with the true KH KV heads (a strided slice
    of the weight-repeated heads), or, with ``pages`` (one group's k and v
    cache, (B, s_max, KH, D) each), new pages of their shapes, types and
    layouts holding them in the first S positions (:func:`_page`).  On a
    mesh without ``pages`` (the training forward) ``kv`` is None.
    ``inference`` enables causal block skipping (forward only) and, with
    ``use_kernels``, the ``flash_attention`` kernel route; without
    ``inference``, ``use_kernels`` takes the training route,
    ``FlashAttention`` (the lse forward and the backward kernels).  GQA as
    the reference: the KV weights are repeated to H heads, so autograd sums
    dK and dV back over the G copies."""
    B, S, _ = x.shape
    G = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, pos, repeat_kv=True)
    if inference and use_kernels:
        out = _flash_serve(q, k, v, True)
    elif use_kernels:
        out = _flash_train(q, k, v, True)
    else:
        out = chunked_attention(q, k, v, causal=True, chunk=min(chunk, S),
                                skip_masked=inference)
    out = merge_heads(out) @ p["wo"]
    if pages is not None:
        return out, (_page(k, G, pages[0]), _page(v, G, pages[1]))
    if _is_dtensor(k):
        return out, None
    return out, (k[:, :, ::G], v[:, :, ::G])


def _all_reduce(t: torch.Tensor, op: str, mesh, dims: tuple) -> torch.Tensor:
    """``t`` all-reduced (``op``) over the mesh dimensions ``dims`` in turn
    (functional collectives)."""
    import torch.distributed._functional_collectives as funcol
    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


def _decode_mesh(q, k, v, ck, cv, pos, cfg):
    """:func:`decode_attention`'s write and softmax on a mesh: ``ck``,
    ``cv`` (B, S_max, KH, D) DTensors laid out by ``cache_shardings`` (rows
    over the data ranks where they split, the sequence over the others);
    q (B, 1, H, D), k, v (B, 1, KH, D) and ``pos`` (B,) DTensors.  Each rank
    takes its own rows of q, k, v and pos with every head, writes k and v
    where it holds position ``pos``, and sums its block of keys; the
    softmax's maximum, its sum of exponentials and the weighted values are
    all-reduced over the mesh dimensions that split the sequence (none on a
    mesh that does not: there ``torch.softmax``, as unsharded).  Returns
    (B, 1, H D) of q's type, laid out as the rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = ck.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in ck.placements)
    split = tuple(d for d, p in enumerate(ck.placements)
                  if isinstance(p, Shard) and p.dim == 1
                  and mesh.size(d) > 1)
    ql, kl, vl = (t.redistribute(mesh, rows).to_local() for t in (q, k, v))
    posl = pos.redistribute(mesh, rows).to_local() \
        if isinstance(pos, DTensor) else pos
    ckl, cvl = ck.to_local(), cv.to_local()
    b, S_loc = ckl.shape[:2]
    _, off = compute_local_shape_and_global_offset(ck.shape, mesh,
                                                   ck.placements)
    s0 = off[1]
    if posl.shape[0] != b:
        raise ValueError(f"pos of {posl.shape[0]} rows on a rank holding "
                         f"{b} cache rows")
    # the new key and value, written only where this rank holds pos (else
    # the slot's own value is written back)
    at = posl - s0
    inside = ((at >= 0) & (at < S_loc))[:, None, None]
    at = at.clamp(0, S_loc - 1)
    r = torch.arange(b, device=ckl.device)
    ckl[r, at] = torch.where(inside, kl[:, 0].to(ckl.dtype), ckl[r, at])
    cvl[r, at] = torch.where(inside, vl[:, 0].to(cvl.dtype), cvl[r, at])
    KH, D = cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KH
    qf = (ql * typed_scale(D ** -0.5, ql.dtype)).reshape(b, KH, G, D).to(
        ckl.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), ckl.float())
    keys = s0 + torch.arange(S_loc, device=ckl.device)
    s = torch.where((keys[None] <= posl[:, None])[:, None, None, :], s,
                    NEG_INF)
    if not split:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", w.to(cvl.dtype).float(),
                         cvl.float())
    else:
        m = _all_reduce(s.amax(dim=-1, keepdim=True), "max", mesh, split)
        e = torch.exp(s - m)
        l = _all_reduce(e.sum(dim=-1, keepdim=True), "sum", mesh, split)
        o = torch.einsum("bhgk,bkhd->bhgd", (e / l).to(cvl.dtype).float(),
                         cvl.float())
        o = _all_reduce(o, "sum", mesh, split)
    out = o.reshape(b, 1, cfg.n_heads * D).to(ql.dtype)
    shape = (ck.shape[0], 1, cfg.n_heads * D)
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def decode_attention(p: dict, x: torch.Tensor, cfg, cache: tuple,
                     pos: torch.Tensor):
    """Single-token decode against a (B, S_max, KH, D) KV cache.

    ``pos``: (B,) absolute position of the incoming token.  The new k and v
    are written into the cache tensors at ``pos`` in place (the reference
    returns updated copies; in place saves a copy of the cache per layer
    and step), and positions > pos are masked out.  Returns (out, (k cache,
    v cache)), the same tensors.  On a mesh (a DTensor cache) the write and
    the softmax run on each rank's own block of the cache
    (:func:`_decode_mesh`)."""
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode_attention takes one token, got {S1}")
    ck, cv = cache
    S_max = ck.shape[1]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    if _is_dtensor(ck):
        out = _decode_mesh(q, k, v, ck, cv, pos, cfg)
        return out @ p["wo"], (ck, cv)
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
    return _flash_serve(q, k, v, False)


def cross_kv(p: dict, enc: torch.Tensor, cfg) -> tuple:
    """The encoder output's keys and values for one decoder layer's cross
    attention, (B, T, KH, D) each: what a prefill writes to the cache as
    ``xk`` and ``xv``."""
    k = split_heads(enc @ p["wk"], cfg.n_kv_heads, cfg.hd)
    v = split_heads(enc @ p["wv"], cfg.n_kv_heads, cfg.hd)
    return k, v


def cross_attention(p: dict, x: torch.Tensor, kv: tuple, cfg,
                    chunk: int = 512, use_kernels: bool = True
                    ) -> torch.Tensor:
    """Decoder -> encoder cross attention (whisper): the queries of x (B,
    S, d) over ``kv``, the encoder output's keys and values from
    :func:`cross_kv` (projected once for the attention and the cache) or
    the cache's in a decode step (S = 1).  The reference projects them
    from the encoder output inside; no rotary embedding, as there."""
    q = split_heads(x @ p["wq"], cfg.n_heads, cfg.hd)
    out = _noncausal(q, *kv, chunk, use_kernels)
    return merge_heads(out) @ p["wo"]


def encoder_attention(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor,
                      chunk: int = 512, use_kernels: bool = True
                      ) -> torch.Tensor:
    """Non-causal self-attention of the whisper encoder over x (B, T,
    d)."""
    q, k, v = _project_qkv(p, x, cfg, pos, repeat_kv=True)
    out = _noncausal(q, k, v, chunk, use_kernels)
    return merge_heads(out) @ p["wo"]
