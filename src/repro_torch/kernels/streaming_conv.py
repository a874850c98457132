"""Row-streaming op bodies with the fused BFP8 boundary codec — the
counterparts of the reference package's ``kernels/streaming_conv.py``.

Each wrapper keeps the reference's calling convention: ``payload=(man,
exp)`` in place of ``x`` asks for the BFP8 ingress decode inside the op,
``encode=True`` for the output's spill payload from the same call (then
the result is ``(y, (man, exp))``, the payload's channel axis padded to
the codec block with zeros, bitwise what ``bfp8_spill_encode`` gives).

On the CPU every variant runs its plain version.  On a CUDA tensor a
wrapper launches its kernel or raises:

* ``conv2d`` plain — kernel (``csrc/conv2d.cu``);
* ``dwconv`` plain — kernel (``csrc/dwconv.cu``);
* ``pool`` plain and with the egress encode — kernels
  (``csrc/streaming_conv.cu``);
* ``act_relu`` plain and with the egress encode — kernels (same file);
* the ingress-decode variants of all four ops, and the egress variants of
  ``conv2d`` and ``dwconv`` — no kernel yet (ROADMAP.md, Queue 2).  No
  plan of the staged main path (the paper-width UNet, X3D-M at depth 2)
  reaches them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .bfp8 import bfp8_dequant_values, bfp8_quant_values
from .library import check_operand, launch, not_ported
from .streamed_matmul import _round_up

BFP8_BLOCK = 32
CONV2D_BN = 32            # the conv2d kernel's output columns per block
POOL_SERIAL_MAX_K = 8     # pool sums up to this many rows in one thread
POOL_CHUNK = 256          # rows per block of a pool tree pass
_SRC = "src/repro/kernels/streaming_conv.py"


def _decode(payload, c: int, block: int) -> torch.Tensor:
    man, exp = payload
    if man.shape[1] != _round_up(c, block):
        raise ValueError(f"payload width {man.shape[1]} does not pad "
                         f"{c} channels to the {block} block")
    return bfp8_dequant_values(man, exp, block=block)[:, :c]


def _encode(y: torch.Tensor, block: int):
    c = y.shape[1]
    return bfp8_quant_values(F.pad(y, (0, _round_up(c, block) - c)),
                             block=block)


def _plain(op, x, c, payload, encode, block):
    """The plain version of one fused launch: decode -> op -> encode."""
    if payload is not None:
        x = _decode(payload, c, block)
    y = op(x)
    return (y, _encode(y, block)) if encode else y


def _on_cuda(x, payload) -> bool:
    return (payload[0] if payload is not None else x).is_cuda


def conv2d(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK):
    """1x1 conv ``y = x @ w`` (conv/matmul/deconv), fusion flags as above."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.conv2d_ref(h, w), x, w.shape[0], payload,
                      encode, block)
    if payload is not None or encode:
        not_ported(f"conv2d with the fused codec ({_SRC} _conv_dec_kernel, "
                   f"_conv_enc_kernel, _conv_dec_enc_kernel)")
    check_operand("conv2d x", x, torch.float32, align=4)
    check_operand("conv2d w", w, torch.float32, align=4)
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"conv2d shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if n > 65535 * CONV2D_BN:
        raise ValueError(f"conv2d: n={n} exceeds the grid's columns")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    launch("conv2d", x, w, y, m, k, n)
    return y


def dwconv(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK):
    """Depthwise temporal conv (w: (taps, c), 'same' padding)."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.dwconv_ref(h, w), x, w.shape[1], payload,
                      encode, block)
    if payload is not None or encode:
        not_ported(f"dwconv with the fused codec ({_SRC} _dwconv_dec_kernel, "
                   f"_dwconv_enc_kernel, _dwconv_dec_enc_kernel)")
    check_operand("dwconv x", x, torch.float32, align=4)
    check_operand("dwconv w", w, torch.float32, align=4)
    (m, c), (taps, c2) = x.shape, w.shape
    if c != c2 or taps < 1:
        raise ValueError(f"dwconv shapes {tuple(x.shape)}, {tuple(w.shape)}")
    y = torch.empty_like(x)
    launch("dwconv", x, w, y, m, c, taps)
    return y


def pool_scratch_size(m_out: int, k: int, c: int) -> int:
    """f32 values of partial sums the pool kernel needs: none for the
    serial path (k <= POOL_SERIAL_MAX_K) or a single tree pass, else one
    buffer per tree pass, ping-ponged (``smof_pool`` in
    ``csrc/streaming_conv.cu`` lays them out the same way)."""
    chunks = -(-k // POOL_CHUNK)
    if k <= POOL_SERIAL_MAX_K or chunks == 1:
        return 0
    return m_out * (chunks + -(-chunks // POOL_CHUNK)) * c


def pool(x, m_out: int, *, c: int | None = None, payload=None, encode=False,
         block: int = BFP8_BLOCK):
    """Mean over k = m / m_out consecutive rows (m -> m_out)."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.pool_ref(h, m_out), x, c, payload,
                      encode, block)
    if payload is not None:
        not_ported(f"pool with the ingress decode ({_SRC} _pool_dec_kernel, "
                   f"_pool_dec_enc_kernel)")
    check_operand("pool x", x, torch.float32, align=4)
    m, c = x.shape
    if m_out <= 0 or m % m_out:
        raise ValueError(f"pool needs m_out | m, got {m} -> {m_out}")
    k = m // m_out
    y = torch.empty((m_out, c), dtype=torch.float32, device=x.device)
    if encode:
        if block != BFP8_BLOCK:
            raise ValueError(f"the pool encode kernel takes block="
                             f"{BFP8_BLOCK}, got {block}")
        nb = _round_up(c, block) // block
        man = torch.empty((m_out, nb * block), dtype=torch.int8,
                          device=x.device)
        exp = torch.empty((m_out, nb), dtype=torch.int8, device=x.device)
        launch("pool_encode", x, y, man, exp, m_out, k, c)
        return y, (man, exp)
    scratch = torch.empty(pool_scratch_size(m_out, k, c), dtype=torch.float32,
                          device=x.device)
    launch("pool", x, y, scratch, m_out, k, c)
    return y


def act_relu(x, *, c: int | None = None, payload=None, encode=False,
             block: int = BFP8_BLOCK):
    """relu, with the egress encode fused when ``encode=True``."""
    if not _on_cuda(x, payload):
        return _plain(ref.act_relu_ref, x, c, payload, encode, block)
    if payload is not None:
        not_ported(f"act_relu with ingress decode ({_SRC} _act_dec_kernel, "
                   f"_act_dec_enc_kernel)")
    m, c = x.shape
    if not encode:
        check_operand("act_relu x", x, torch.float32)
        y = torch.empty_like(x)
        launch("act_relu", x, y, m * c)
        return y
    if block != BFP8_BLOCK:
        raise ValueError(f"the act_relu encode kernel takes block="
                         f"{BFP8_BLOCK}, got {block}")
    check_operand("act_relu x", x, torch.float32, align=4)
    y = torch.empty_like(x)
    nb = _round_up(c, block) // block
    man = torch.empty((m, nb * block), dtype=torch.int8, device=x.device)
    exp = torch.empty((m, nb), dtype=torch.int8, device=x.device)
    launch("act_relu_encode", x, y, man, exp, m, c)
    return y, (man, exp)


__all__ = ["conv2d", "dwconv", "pool", "act_relu"]
