"""BFP8 codec — the paper's §V-A block-floating-point format as the
eviction codec: int8 mantissas plus one int8 shared exponent per ``block``
consecutive channels, ``(8 + 8/block)`` bits per value.

:func:`bfp8_quant_values` / :func:`bfp8_dequant_values` are the one
definition of the codec's numerics.  The plain wrappers below, the fused
egress encodes of ``streaming_conv.act_relu``, ``streaming_conv.pool`` and
``streaming_conv.conv2d`` and the CUDA kernels built on ``csrc/bfp8.cuh``
all compute exactly this, bit for bit:

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


def bfp8_quant_values(x: torch.Tensor, *, block: int,
                      width: int | None = None):
    """(R, C) f32 -> (int8 mantissas (R, W), int8 shared exponents (R, W //
    block)), W = ``width`` (a multiple of ``block``, at least C; default C,
    then a multiple of ``block``): the payload of x with its channel axis
    padded with zeros to W."""
    x = x.to(torch.float32)
    R, C = x.shape
    W = C if width is None else width
    if W % block or W < C:
        raise ValueError(f"bfp8 width {W} is not a multiple of {block} "
                         f"holding {C} channels")
    if W != C:
        x = torch.nn.functional.pad(x, (0, W - C))
    xb = x.reshape(R, W // block, block)
    exp = bfp8_exponent(xb.abs().amax(dim=-1))
    q = torch.round(xb / bfp8_scale(exp)[..., None])
    man = torch.where(torch.isnan(q), 0.0, q).clamp(-127, 127)
    return man.reshape(R, W).to(torch.int8), exp.to(torch.int8)


def bfp8_dequant_values(man: torch.Tensor, exp: torch.Tensor, *, block: int,
                        c: int | None = None,
                        dtype=torch.float32) -> torch.Tensor:
    """Inverse layout of :func:`bfp8_quant_values`: ``man * 2^(exp-6)`` in
    the first ``c`` channels (default all W), as an (R, c) stripe."""
    R, W = man.shape
    out = (man.to(torch.float32).reshape(R, W // block, block)
           * bfp8_scale(exp)[..., None]).reshape(R, W).to(dtype)
    return out if c is None or c == W else out[:, :c].contiguous()


def _payload_width(name: str, c: int, width: int, block: int) -> None:
    if width % block or not 0 <= c <= width:
        raise ValueError(f"{name}: a payload {width} wide does not carry "
                         f"{c} channels in blocks of {block}")


def bfp8_quant(x: torch.Tensor, *, block: int = 32,
               width: int | None = None):
    """x: (R, c) f32 -> (mantissa int8 (R, W), exponent int8 (R, W //
    block)), W = ``width``, a multiple of ``block`` and at least c: the
    channels past c quantise as zeros, as if x were padded to W.  Without
    ``width`` c itself must be a multiple of ``block``.  The standalone
    encode of an evicted stream whose producer cannot emit the payload from
    its own launch: the executor's ``_lower_vertex`` fuses the encode only
    into an act, a pool, a dwconv or a conv whose weight is not fragmented,
    so the output of an ``add`` (or another op without a kernel) or of a
    fragmented conv is encoded here.  A CUDA tensor goes through the
    ``bfp8_quant`` kernel, a CPU one through the plain version."""
    R, c = x.shape
    if width is None:
        if c % block:
            raise ValueError(f"bfp8_quant needs C % {block} == 0 without a "
                             f"width, got {tuple(x.shape)}")
        width = c
    _payload_width("bfp8_quant", c, width, block)
    if not x.is_cuda:
        return bfp8_quant_values(x, block=block, width=width)
    if block != 32:
        raise ValueError("the bfp8_quant kernel takes block=32")
    check_operand("bfp8_quant x", x, torch.float32, align=4)
    man = torch.empty((R, width), dtype=torch.int8, device=x.device)
    exp = torch.empty((R, width // block), dtype=torch.int8, device=x.device)
    launch("bfp8_quant", x, man, exp, R, c, width)
    return man, exp


def bfp8_dequant(man: torch.Tensor, exp: torch.Tensor, *, block: int = 32,
                 c: int | None = None, dtype=torch.float32) -> torch.Tensor:
    """Payload (R, W) int8 + (R, W // block) int8 -> the (R, c) f32 stripe
    it carries, its first c channels (default all W).  A CUDA payload goes
    through the ``bfp8_dequant`` kernel, a CPU one through the plain
    version."""
    R, W = man.shape
    c = W if c is None else c
    _payload_width("bfp8_dequant", c, W, block)
    if tuple(exp.shape) != (R, W // block):
        raise ValueError(f"bfp8 payload shapes {tuple(man.shape)} / "
                         f"{tuple(exp.shape)} do not match block {block}")
    if not man.is_cuda:
        return bfp8_dequant_values(man, exp, block=block, c=c, dtype=dtype)
    if block != 32 or dtype != torch.float32:
        raise ValueError("the bfp8_dequant kernel takes block=32 and f32")
    check_operand("bfp8_dequant man", man, torch.int8, align=1)
    check_operand("bfp8_dequant exp", exp, torch.int8, align=1)
    y = torch.empty((R, c), dtype=torch.float32, device=man.device)
    launch("bfp8_dequant", man, exp, y, R, c, W)
    return y
