"""Flash attention, the prefill hot spot: blockwise softmax attention with
the online-softmax recurrence (the reference package's
``kernels/flash_attention.py``), and its gradient for training.

``q: (B, S, H, D)`` and ``k, v: (B, Sk, H, D)`` f32 or bf16 with the KV
heads already repeated to H; causal (then Sk == S) or not (then keys of their
own length, as the encoder-decoder's cross attention has), scale ``D **
-0.5``, mask ``-2**30``, the softmax denominator clamped at ``1e-30``, and
key blocks wholly above the diagonal skipped.  A CUDA tensor goes through
the ``flash_attention`` kernel (``csrc/flash_attention.cu``), which takes
any S and Sk (the Pallas wrapper asks ``S % bq == 0`` and one S) and D in
:data:`HEAD_DIMS`; a CPU tensor through the plain version,
``models.attention.chunked_attention`` with block skipping, the
reference's own oracle for its kernel.  The training instances below take
the same shapes: causal with Sk == S, or keys of their own length.

Training goes through :class:`FlashAttention`, an autograd function.  Its
forward is the same kernel instantiated to write each row's log-sum-exp
too (``flash_attention_lse``: ``lse`` of shape (B, H, S), f32), and it
saves ``q, k, v, lse`` and the output in f32 (a bf16 instance writes it
beside its rounded o: rowsum(dO * O) from the rounded o would move by
2^-8 sum |dO * O|, which dP - D cancels down to where attention is near
uniform); its backward launches
``flash_attention_bwd_dq`` (dQ and ``delta`` = rowsum(dO * O)) and then
``flash_attention_bwd_dkdv`` (dK, dV) on the same stream
(``csrc/flash_attention_bwd.cu``; the bf16 pair
``csrc/flash_attention_bwd_bf16.cu``), each over the Sk keys of k and v
(dK and dV of k's shape).  The reference has no backward kernel:
XLA differentiates ``chunked_attention``.  On a CPU tensor both directions
take the plain versions, ``chunked_attention(return_lse=True)`` and
:func:`flash_attention_backward_plain`.

Each kernel has an f32 and a bf16 instance, picked by the operands' type
(``flash_attention_bf16``, ``flash_attention_lse_bf16``,
``flash_attention_bwd_dq_bf16``, ``flash_attention_bwd_dkdv_bf16``): q, k,
v, o, dO, dQ, dK and dV of that type, lse, delta and the o the backward
reads f32 either way.  A bf16
instance rounds where the plain route does: q^ = bf16(q * bf16(D^-1/2))
(the reference's ``q * D ** -0.5``, its scale a weak type converted to
bf16), then f32 sums, then one rounding of each output.  The f32 instances
run both products on the 3xTF32 split (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).  The bf16 ones have bodies of their own
on the bf16 tensor cores (``csrc/flash_attention_bf16.cu``, the forward
pair; ``csrc/flash_attention_bwd_bf16.cu``, the backward pair; both on
``csrc/bf16_mma.cuh``): a product of two bf16 operands (s = q^ k^T, dP =
dO v^T) is one native bf16 product, and an f32 intermediate (P, dS) enters
its product as the sum of two bf16 pieces (``ref.bf16_pieces``), the
forward's key tiles :data:`BF16_FORWARD_TILE` wide.
"""
from __future__ import annotations

import torch

from .library import check_operand, launch, load_library

#: head widths the kernels are built for
HEAD_DIMS = (16, 32, 64, 128)
KERNEL_BQ = 64              # the kernels' query rows (and keys) a block
BF16_FORWARD_TILE = 64      # keys of a kv tile of the bf16 forward pair
NEG_INF = -2.0 ** 30        # the causal mask, the reference's


def _check(name: str, q, k, v, *, own_keys: bool = False
           ) -> tuple[int, int, int, int]:
    """(B, S, H, D) of ``q``.  q, k and v share that shape; with
    ``own_keys`` k and v share a (B, Sk, H, D) of their own, Sk >= 1."""
    if own_keys:
        fits = (k.dim() == 4 and k.shape[1] >= 1
                and k.shape[:1] + k.shape[2:] == q.shape[:1] + q.shape[2:])
    else:
        fits = k.shape == q.shape
    if q.dim() != 4 or k.shape != v.shape or not fits:
        what = ("q (B, S, H, D) and k, v one (B, Sk, H, D)" if own_keys
                else "q, k, v one (B, S, H, D)")
        raise ValueError(f"{name}: {what} shape expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if q.is_cuda:
        if D not in HEAD_DIMS:
            raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
        # query blocks (the forward, dq) or key blocks (dkdv) a grid row
        rows = max(S, k.shape[1])
        if -(-rows // KERNEL_BQ) > 65535 or B * H > 2**31 - 1:
            raise ValueError(f"{name}: S or Sk = {rows} or B * H = {B * H} "
                             f"exceeds the grid")
    return B, S, H, D


#: the operand types with a kernel instance, and the suffix of its name
INSTANCES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _operands(name: str, dtype: torch.dtype, *named) -> str:
    """Check every operand (lse, delta and the backward's o are f32 whatever
    ``dtype``) and return the name of the instance for ``dtype``."""
    if dtype not in INSTANCES:
        raise ValueError(f"{name}: no instance for {dtype}; have "
                         f"{sorted(map(str, INSTANCES))}")
    for what, t in named:
        want = torch.float32 if what in ("lse", "delta", "o") else dtype
        check_operand(f"{name} {what}", t, want)
    return name + INSTANCES[dtype]


def _scale(D: int, dtype: torch.dtype) -> float:
    """D^-1/2 as the reference multiplies an array of ``dtype`` by it."""
    from ..models.common import typed_scale
    return typed_scale(D ** -0.5, dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention of ``q`` over ``k``, ``v`` of shape (B, Sk,
    H, D): the serving prefill's, the encoder's and the cross attention's
    (no gradient flows through the kernel route).  A causal call takes
    Sk == S; a non-causal one any Sk >= 1 (S = 1 in a cross decode)."""
    B, S, H, D = _check("flash_attention", q, k, v, own_keys=not causal)
    Sk = k.shape[1]
    if not q.is_cuda:
        from ..models.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal,
                                 chunk=min(1024, Sk), skip_masked=causal)
    name = _operands("flash_attention", q.dtype, ("q", q), ("k", k),
                     ("v", v))
    o = torch.empty_like(q)
    # the causal flag beside the shapes: it changes the work they fix
    launch(name, q, k, v, o, B, S, Sk, H, D, int(causal),
           flags=(bool(causal),))
    return o


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(o, lse, o_wide)``: the attention, each row's log-sum-exp of the
    scaled scores, ``m + log(max(l, 1e-30))``, as (B, H, S) f32, and the
    attention in f32 before its rounding to q's type (o itself in f32),
    which :func:`flash_attention_bwd_dq` takes.  Shapes as
    :func:`flash_attention`'s."""
    B, S, H, D = _check("flash_attention_lse", q, k, v, own_keys=not causal)
    Sk = k.shape[1]
    if not q.is_cuda:
        from ..models.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal, chunk=min(1024, Sk),
                                 skip_masked=causal, return_lse=True)
    name = _operands("flash_attention_lse", q.dtype, ("q", q), ("k", k),
                     ("v", v))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        launch(name, q, k, v, o, lse, B, S, Sk, H, D, int(causal),
               flags=(bool(causal),))
        return o, lse, o
    o_wide = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch(name, q, k, v, o, lse, o_wide, B, S, Sk, H, D, int(causal),
           flags=(bool(causal),))
    return o, lse, o_wide


# =============================================================================
# the gradient
# =============================================================================

def _scores(qs, kt, q0, q1, k0, k1, causal):
    """Scaled scores (B, H, q1 - q0, k1 - k0), the causal mask -2**30."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs[:, q0:q1], kt[:, k0:k1])
    if causal:
        qp = torch.arange(q0, q1, device=qs.device)
        kp = torch.arange(k0, k1, device=qs.device)
        s = torch.where(qp[:, None] >= kp[None, :], s, NEG_INF)
    return s


def _wide(*ts):
    """Each tensor in f32 if its type is narrower (bf16), else as it is
    (an f64 gradcheck keeps f64)."""
    return tuple(t.float() if t.element_size() < 4 else t for t in ts)


def flash_attention_bwd_dq_plain(q, k, v, o, do, lse, causal: bool, *,
                                 block: int = KERNEL_BQ):
    """The plain version of ``flash_attention_bwd_dq``: ``(dq, delta)``,
    delta = rowsum(dO * O) as (B, H, S) f32.  Walks query blocks of
    ``block`` rows over the keys at or below their diagonal (all Sk keys of
    k and v, non-causal), as the kernel does; in f32 from q^ (rounded to
    q's type) and the other operands, dq rounded once to q's type."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    scale = _scale(D, q.dtype)
    qs, = _wide(q * scale)
    k, v, o, do = _wide(k, v, o, do)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty(q.shape, dtype=qs.dtype, device=q.device)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        k1 = q1 if causal else Sk
        p = torch.exp(_scores(qs, k, q0, q1, 0, k1, causal)
                      - lse[:, :, q0:q1, None])
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, q0:q1], v[:, :k1])
        ds = p * (dp - delta[:, :, q0:q1, None])
        dq[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", ds, k[:, :k1]) * scale
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal: bool, *,
                                   block: int = KERNEL_BQ):
    """The plain version of ``flash_attention_bwd_dkdv``: ``(dk, dv)``.
    Walks key blocks of ``block`` of the Sk keys over the query rows at or
    above their diagonal (all S rows, non-causal), as the kernel does; in
    f32 as the dq version, dk and dv rounded once to k's type."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    qs, = _wide(q * _scale(D, q.dtype))
    dtype = k.dtype
    k, v, do = _wide(k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, Sk, block):
        k1 = min(k0 + block, Sk)
        q0 = k0 if causal else 0
        p = torch.exp(_scores(qs, k, q0, S, k0, k1, causal)
                      - lse[:, :, q0:, None])
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, q0:], v[:, k0:k1])
        ds = p * (dp - delta[:, :, q0:, None])
        dv[:, k0:k1] = torch.einsum("bhqk,bqhd->bkhd", p, do[:, q0:])
        dk[:, k0:k1] = torch.einsum("bhqk,bqhd->bkhd", ds, qs[:, q0:])
    return dk.to(dtype), dv.to(dtype)


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool):
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse``, blockwise as
    the kernels compute it: P = exp(s - lse), dV = P^T dO, dP = dO V^T,
    D = rowsum(dO * O), dS = P * (dP - D), dQ = dS K D^-1/2, dK = dS^T (q
    D^-1/2)."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, do, lse, causal)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _fits(name, q, lse, *rows) -> None:
    """``rows`` (o, dO) of q's shape and ``lse`` (or delta) (B, H, S)."""
    B, S, H, _ = q.shape
    if lse.shape != (B, H, S) or any(t.shape != q.shape for t in rows):
        raise ValueError(f"{name}: lse or delta {tuple(lse.shape)}, o or "
                         f"dout {[tuple(t.shape) for t in rows]} do not fit "
                         f"q {tuple(q.shape)}")


def flash_attention_bwd_dq(q, k, v, o, do, lse, causal: bool):
    """``(dq, delta)``: the ``flash_attention_bwd_dq`` kernel on a CUDA
    tensor (``o`` f32, the forward's output before its rounding:
    :func:`flash_attention_lse`'s third), its plain version on a CPU one.  Shapes as :func:`flash_attention`'s."""
    B, S, H, D = _check("flash_attention_bwd_dq", q, k, v,
                        own_keys=not causal)
    _fits("flash_attention_bwd_dq", q, lse, o, do)
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, o, do, lse, causal)
    name = _operands("flash_attention_bwd_dq", q.dtype, ("q", q), ("k", k),
                     ("v", v), ("o", o), ("dout", do), ("lse", lse))
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    launch(name, q, k, v, o, do, lse, dq, delta, B, S, k.shape[1], H, D,
           int(causal), flags=(bool(causal),))
    return dq, delta


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool):
    """``(dk, dv)``, of k's shape, from ``delta`` of
    :func:`flash_attention_bwd_dq`: the ``flash_attention_bwd_dkdv`` kernel
    on a CUDA tensor (after the dq kernel on the same stream), its plain
    version on a CPU one."""
    B, S, H, D = _check("flash_attention_bwd_dkdv", q, k, v,
                        own_keys=not causal)
    _fits("flash_attention_bwd_dkdv", q, lse, do)
    _fits("flash_attention_bwd_dkdv", q, delta)
    if not q.is_cuda:
        return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    name = _operands("flash_attention_bwd_dkdv", q.dtype, ("q", q),
                     ("k", k), ("v", v), ("dout", do), ("lse", lse),
                     ("delta", delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch(name, q, k, v, do, lse, delta, dk, dv, B, S, k.shape[1], H, D,
           int(causal), flags=(bool(causal),))
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, do, causal: bool):
    """``(dq, dk, dv)``: the two backward kernels on a CUDA tensor, the
    plain versions on a CPU one."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _occupancy(head_dim: int, entries) -> dict[str, tuple[int, int, int]]:
    """``{kernel: (bytes, registers, blocks)}`` from the C occupancy
    entries ``(entry, (name of instance 0, name of instance 1))``."""
    import ctypes
    lib = load_library().lib
    out = {}
    for entry, names in entries:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
        for i, name in enumerate(names):
            vals = (ctypes.c_int64 * 3)()
            code = fn(head_dim, i, vals)
            if code:
                raise RuntimeError(f"{name}: occupancy at head_dim "
                                   f"{head_dim} failed with CUDA error "
                                   f"{code}")
            out[name] = tuple(vals)
    return out


def backward_occupancy(head_dim: int) -> dict[str, tuple[int, int, int]]:
    """``{kernel: (dynamic shared memory bytes, registers a thread,
    resident blocks an SM)}`` of the four backward kernels (the f32 pair
    and the bf16 pair) at ``head_dim``, as the current card reports
    them."""
    pair = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
    return _occupancy(head_dim, (
        ("smof_flash_attention_bwd_occupancy", pair),
        ("smof_flash_attention_bwd_bf16_occupancy",
         tuple(n + "_bf16" for n in pair))))


def forward_occupancy(head_dim: int) -> dict[str, tuple[int, int, int]]:
    """The same of the bf16 forward pair (``flash_attention_bf16`` and
    ``flash_attention_lse_bf16``, ``csrc/flash_attention_bf16.cu``)."""
    return _occupancy(head_dim, (
        ("smof_flash_attention_bf16_occupancy",
         ("flash_attention_bf16", "flash_attention_lse_bf16")),))


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: ``FlashAttention.apply(q, k, v,
    causal)``, shapes as :func:`flash_attention`'s (non-causal: any Sk >=
    1).  The forward keeps ``q, k, v``, ``lse`` and the output in f32 for
    the backward, which recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        o, lse, o_wide = flash_attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o_wide, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o_wide, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o_wide, lse,
                                              do.contiguous(), ctx.causal)
        return dq, dk, dv, None


__all__ = ["flash_attention", "flash_attention_lse", "FlashAttention",
           "flash_attention_backward", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkdv", "flash_attention_backward_plain",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkdv_plain",
           "backward_occupancy", "forward_occupancy", "HEAD_DIMS",
           "INSTANCES", "BF16_FORWARD_TILE"]
