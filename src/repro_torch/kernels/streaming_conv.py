"""Row-streaming op bodies with the fused BFP8 boundary codec — the
counterparts of the reference package's ``kernels/streaming_conv.py``.

Each wrapper keeps the reference's calling convention: ``payload=(man,
exp)`` in place of ``x`` asks for the BFP8 ingress decode inside the op,
``encode=True`` for the output's spill payload from the same call (then
the result is ``(y, (man, exp))``, the payload's channel axis padded to
the codec block with zeros, bitwise what ``bfp8_spill_encode`` gives).

On the CPU every variant runs its plain version.  On a CUDA tensor a
wrapper launches its kernel (``csrc/streaming_conv.cu``) or raises:

* ``act_relu`` plain and with egress encode — kernels;
* ``pool`` plain — kernel;
* ``conv2d``, ``dwconv``, and the ingress-decode variants of ``act_relu``
  and ``pool`` and the egress variant of ``pool`` — no kernel yet
  (ROADMAP.md, Queue 2).  The staged main path does not reach them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .bfp8 import bfp8_dequant_values, bfp8_quant_values
from .library import check_operand, launch, not_ported
from .streamed_matmul import _round_up

BFP8_BLOCK = 32
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
    if _on_cuda(x, payload):
        not_ported(f"conv2d ({_SRC} _conv_kernel)")
    return _plain(lambda h: ref.conv2d_ref(h, w), x, w.shape[0], payload,
                  encode, block)


def dwconv(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK):
    """Depthwise temporal conv (w: (taps, c), 'same' padding)."""
    if _on_cuda(x, payload):
        not_ported(f"dwconv ({_SRC} _dwconv_kernel)")
    return _plain(lambda h: ref.dwconv_ref(h, w), x, w.shape[1], payload,
                  encode, block)


def pool(x, m_out: int, *, c: int | None = None, payload=None, encode=False,
         block: int = BFP8_BLOCK):
    """Mean over k = m / m_out consecutive rows (m -> m_out)."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.pool_ref(h, m_out), x, c, payload,
                      encode, block)
    if payload is not None or encode:
        not_ported(f"pool with the fused codec ({_SRC} _pool_dec_kernel, "
                   f"_pool_enc_kernel, _pool_dec_enc_kernel)")
    check_operand("pool x", x, torch.float32, align=4)
    m, c = x.shape
    if m_out <= 0 or m % m_out:
        raise ValueError(f"pool needs m_out | m, got {m} -> {m_out}")
    y = torch.empty((m_out, c), dtype=torch.float32, device=x.device)
    launch("pool", x, y, m_out, m // m_out, c)
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
