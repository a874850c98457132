"""BFP8 codec — the paper's §V-A block-floating-point format as the
eviction codec: int8 mantissas plus one int8 shared exponent per ``block``
consecutive channels, ``(8 + 8/block)`` bits per value.

:func:`bfp8_quant_values` / :func:`bfp8_dequant_values` are the one
definition of the codec's numerics.  The plain wrappers below, the fused
egress encodes of ``streaming_conv.act_relu`` and ``streaming_conv.pool``
and the CUDA kernels built on ``csrc/bfp8.cuh`` all compute exactly this,
bit for bit:

* ``exp = ceil(log2(max(amax, 1e-38)))`` for a block with a finite
  ``amax > 0``, else 0 (a block that holds a NaN has ``amax`` NaN).  It is read exactly from the float's bits (``frexp``): an f32
  ``log2`` misses the integer near powers of two, and two implementations of
  it miss in different places.  The reference package's f32 ``log2`` agrees
  with this except where a block's amax lies within about 2^-16 (relative)
  of a power of two.
* ``man = clip(round_half_even(x / 2^(exp-6)), -127, 127)``.  The scale is
  an exact power of two, so the division is exact.  A NaN value's
  mantissa is 0.
"""
from __future__ import annotations

import torch

from .library import check_operand, launch


def bfp8_exponent(amax: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(max(amax, 1e-38)))`` where ``amax`` is finite and > 0,
    else 0, exactly (int32).  ``frexp`` gives ``a = f * 2^e`` with ``f`` in [0.5, 1); ``a``
    is a power of two exactly when ``f == 0.5``, and then the ceiling is
    ``e - 1``."""
    f, e = torch.frexp(torch.clamp(amax, min=1e-38))
    e = torch.where(f == 0.5, e - 1, e)
    return torch.where((amax > 0) & torch.isfinite(amax), e,
                       torch.zeros_like(e))


def bfp8_scale(exp: torch.Tensor) -> torch.Tensor:
    """``2^(exp - 6)`` as an exact f32, built from its bits (a subnormal
    below 2^-126), for integer ``exp`` in [-128, 127]."""
    e = exp.to(torch.int32) - 6
    bits = torch.where(e >= -126, (e + 127).clamp(min=0) << 23,
                       torch.ones_like(e) << (e + 149).clamp(0, 22))
    return bits.view(torch.float32)


def bfp8_quant_values(x: torch.Tensor, *, block: int):
    """(R, C) f32 with ``C % block == 0`` -> (int8 mantissas (R, C), int8
    shared exponents (R, C // block))."""
    x = x.to(torch.float32)
    R, C = x.shape
    xb = x.reshape(R, C // block, block)
    exp = bfp8_exponent(xb.abs().amax(dim=-1))
    q = torch.round(xb / bfp8_scale(exp)[..., None])
    man = torch.where(torch.isnan(q), 0.0, q).clamp(-127, 127)
    return man.reshape(R, C).to(torch.int8), exp.to(torch.int8)


def bfp8_dequant_values(man: torch.Tensor, exp: torch.Tensor, *, block: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Inverse layout of :func:`bfp8_quant_values`: ``man * 2^(exp-6)``."""
    R, C = man.shape
    out = (man.to(torch.float32).reshape(R, C // block, block)
           * bfp8_scale(exp)[..., None])
    return out.reshape(R, C).to(dtype)


def bfp8_quant(x: torch.Tensor, *, block: int = 32):
    """x: (R, C) f32, C % block == 0 -> (mantissa int8 (R, C), exponent int8
    (R, C // block)).  The standalone encode of an evicted stream whose
    producer cannot emit the payload from its own launch: the executor's
    ``_lower_vertex`` fuses the encode only into an act, a pool, a dwconv or
    a conv whose weight is not fragmented, so the output of an ``add`` (or
    another op without a kernel) or of a fragmented conv is encoded here.
    A CUDA tensor goes through the ``bfp8_quant`` kernel, a CPU one through
    the plain version."""
    if x.shape[1] % block:
        raise ValueError(f"bfp8_quant needs C % {block} == 0, got {x.shape}")
    if not x.is_cuda:
        return bfp8_quant_values(x, block=block)
    if block != 32:
        raise ValueError("the bfp8_quant kernel takes block=32")
    check_operand("bfp8_quant x", x, torch.float32, align=4)
    R, C = x.shape
    man = torch.empty((R, C), dtype=torch.int8, device=x.device)
    exp = torch.empty((R, C // block), dtype=torch.int8, device=x.device)
    launch("bfp8_quant", x, man, exp, R, C)
    return man, exp


def bfp8_dequant(man: torch.Tensor, exp: torch.Tensor, *, block: int = 32,
                 dtype=torch.float32) -> torch.Tensor:
    """Payload (R, C) int8 + (R, C // block) int8 -> (R, C) f32.  A CUDA
    payload goes through the ``bfp8_dequant`` kernel, a CPU one through the
    plain version."""
    R, C = man.shape
    if C % block or tuple(exp.shape) != (R, C // block):
        raise ValueError(f"bfp8 payload shapes {tuple(man.shape)} / "
                         f"{tuple(exp.shape)} do not match block {block}")
    if not man.is_cuda:
        return bfp8_dequant_values(man, exp, block=block, dtype=dtype)
    if block != 32 or dtype != torch.float32:
        raise ValueError("the bfp8_dequant kernel takes block=32 and f32")
    check_operand("bfp8_dequant man", man, torch.int8, align=4)
    check_operand("bfp8_dequant exp", exp, torch.int8, align=1)
    y = torch.empty((R, C), dtype=torch.float32, device=man.device)
    launch("bfp8_dequant", man, exp, y, R, C)
    return y
