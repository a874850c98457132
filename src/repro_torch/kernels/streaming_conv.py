"""Row-streaming op bodies with the fused BFP8 boundary codec — the
counterparts of the reference package's ``kernels/streaming_conv.py``.

Each wrapper keeps the reference's calling convention: ``payload=(man,
exp)`` in place of ``x`` asks for the BFP8 ingress decode inside the op,
``encode=True`` for the output's spill payload from the same call (then
the result is ``(y, (man, exp))``, the payload's channel axis padded to
the codec block with zeros, bitwise what ``bfp8_spill_encode`` gives).

On the CPU every variant runs its plain version (decode -> op -> encode).
On a CUDA tensor a wrapper launches its kernel or raises.  Every variant of
``conv2d`` (``csrc/conv2d.cu``), ``dwconv`` (``csrc/dwconv.cu``) and
``pool`` and ``act_relu`` (``csrc/streaming_conv.cu``) has a kernel,
named ``<op>``, ``<op>_encode``, ``<op>_decode`` and
``<op>_decode_encode``.

Every fused egress payload, on both devices, leaves through
:func:`_egress_payload`, so a test can plant a fault in the fused encode
alone (``repro_torch.testing.oracle.inject_fault``) while the standalone
codec stays correct.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .bfp8 import bfp8_dequant_values, bfp8_quant_values
from .library import check_operand, launch
from .streamed_matmul import _round_up

BFP8_BLOCK = 32
CONV2D_BN = 32            # the conv2d kernel's output columns per block
POOL_SERIAL_MAX_K = 8     # pool sums up to this many rows in one thread
POOL_CHUNK = 256          # rows per block of a pool tree pass


def _egress_payload(man: torch.Tensor, exp: torch.Tensor) -> tuple:
    """The identity on a fused egress payload: the one point every fused
    encode's ``(mantissas, exponents)`` passes."""
    return man, exp


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
    return (y, _egress_payload(*_encode(y, block))) if encode else y


def _on_cuda(x, payload) -> bool:
    return (payload[0] if payload is not None else x).is_cuda


def _kernel_name(op: str, payload, encode: bool) -> str:
    return (op + ("_decode" if payload is not None else "")
            + ("_encode" if encode else ""))


def _check_codec_block(name: str, payload, encode: bool, block: int) -> None:
    if (payload is not None or encode) and block != BFP8_BLOCK:
        raise ValueError(f"the {name} codec kernels take block={BFP8_BLOCK}, "
                         f"got {block}")


def _payload_operands(name: str, payload, c: int) -> tuple:
    """An ingress payload as a kernel reads it: int8 mantissas (m, ceil(c /
    32) * 32) and exponents (m, ceil(c / 32)), contiguous on the card."""
    man, exp = payload
    check_operand(f"{name} man", man, torch.int8, align=1)
    check_operand(f"{name} exp", exp, torch.int8, align=1)
    nb = _round_up(c, BFP8_BLOCK) // BFP8_BLOCK
    if man.shape[1] != nb * BFP8_BLOCK or tuple(exp.shape) != (man.shape[0],
                                                               nb):
        raise ValueError(f"{name}: payload shapes {tuple(man.shape)} / "
                         f"{tuple(exp.shape)} do not carry {c} channels")
    return man, exp


def _empty_payload(m: int, c: int, device) -> tuple:
    nb = _round_up(c, BFP8_BLOCK) // BFP8_BLOCK
    return (torch.empty((m, nb * BFP8_BLOCK), dtype=torch.int8, device=device),
            torch.empty((m, nb), dtype=torch.int8, device=device))


def _input_operands(name: str, x, payload, c: int) -> tuple:
    """The kernel's input tensors (``x``, or the payload's two) and its rows
    m; refuses what the kernels cannot take."""
    if payload is None:
        check_operand(f"{name} x", x, torch.float32, align=4)
        if x.dim() != 2 or x.shape[1] != c:
            raise ValueError(f"{name}: x {tuple(x.shape)} does not have {c} "
                             f"channels")
        return (x,), x.shape[0]
    src = _payload_operands(name, payload, c)
    return src, src[0].shape[0]


def conv2d(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK):
    """1x1 conv ``y = x @ w`` (conv/matmul/deconv), fusion flags as above."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.conv2d_ref(h, w), x, w.shape[0], payload,
                      encode, block)
    _check_codec_block("conv2d", payload, encode, block)
    check_operand("conv2d w", w, torch.float32, align=4)
    k, n = w.shape
    if n > 65535 * CONV2D_BN:
        raise ValueError(f"conv2d: n={n} exceeds the grid's columns")
    src, m = _input_operands("conv2d", x, payload, k)
    y = torch.empty((m, n), dtype=torch.float32, device=w.device)
    name = _kernel_name("conv2d", payload, encode)
    if not encode:
        launch(name, *src, w, y, m, k, n)
        return y
    out = _empty_payload(m, n, w.device)
    launch(name, *src, w, y, *out, m, k, n)
    return y, _egress_payload(*out)


def dwconv(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK):
    """Depthwise temporal conv (w: (taps, c), 'same' padding)."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.dwconv_ref(h, w), x, w.shape[1], payload,
                      encode, block)
    _check_codec_block("dwconv", payload, encode, block)
    check_operand("dwconv w", w, torch.float32, align=4)
    taps, c = w.shape
    if taps < 1:
        raise ValueError(f"dwconv: w {tuple(w.shape)} has no taps")
    src, m = _input_operands("dwconv", x, payload, c)
    y = torch.empty((m, c), dtype=torch.float32, device=w.device)
    name = _kernel_name("dwconv", payload, encode)
    if not encode:
        launch(name, *src, w, y, m, c, taps)
        return y
    out = _empty_payload(m, c, w.device)
    launch(name, *src, w, y, *out, m, c, taps)
    return y, _egress_payload(*out)


def pool_scratch_size(m_out: int, k: int, c: int) -> int:
    """f32 values of partial sums the pool kernels need: none for the
    serial path (k <= POOL_SERIAL_MAX_K) or a single tree pass, else one
    buffer per tree pass, ping-ponged (``run_pool`` in
    ``csrc/streaming_conv.cu`` lays them out the same way)."""
    chunks = -(-k // POOL_CHUNK)
    if k <= POOL_SERIAL_MAX_K or chunks == 1:
        return 0
    return m_out * (chunks + -(-chunks // POOL_CHUNK)) * c


def pool(x, m_out: int, *, c: int | None = None, payload=None, encode=False,
         block: int = BFP8_BLOCK):
    """Mean over k = m / m_out consecutive rows (m -> m_out); with
    ``payload``, ``c`` names the channels it carries."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.pool_ref(h, m_out), x, c, payload,
                      encode, block)
    _check_codec_block("pool", payload, encode, block)
    if payload is None:
        c = x.shape[1]
    elif c is None:
        raise ValueError("pool with the ingress decode needs c")
    src, m = _input_operands("pool", x, payload, c)
    if m_out <= 0 or m % m_out:
        raise ValueError(f"pool needs m_out | m, got {m} -> {m_out}")
    k = m // m_out
    device = src[0].device
    y = torch.empty((m_out, c), dtype=torch.float32, device=device)
    scratch = torch.empty(pool_scratch_size(m_out, k, c), dtype=torch.float32,
                          device=device)
    name = _kernel_name("pool", payload, encode)
    if not encode:
        launch(name, *src, y, scratch, m_out, k, c)
        return y
    out = _empty_payload(m_out, c, device)
    launch(name, *src, y, *out, scratch, m_out, k, c)
    return y, _egress_payload(*out)


def act_relu(x, *, c: int | None = None, payload=None, encode=False,
             block: int = BFP8_BLOCK):
    """relu, with the codec fused as above; with ``payload``, ``c`` names
    the channels it carries."""
    if not _on_cuda(x, payload):
        return _plain(ref.act_relu_ref, x, c, payload, encode, block)
    if payload is None:
        c = x.shape[1]
    elif c is None:
        raise ValueError("act_relu with the ingress decode needs c")
    if payload is None and not encode:
        check_operand("act_relu x", x, torch.float32)
        y = torch.empty_like(x)
        launch("act_relu", x, y, x.numel())
        return y
    _check_codec_block("act_relu", payload, encode, block)
    src, m = _input_operands("act_relu", x, payload, c)
    y = torch.empty((m, c), dtype=torch.float32, device=src[0].device)
    name = _kernel_name("act_relu", payload, encode)
    if not encode:
        # the decode alone reads the mantissas four bytes at a time
        check_operand("act_relu man", src[0], torch.int8, align=4)
        launch(name, *src, y, m, c)
        return y
    out = _empty_payload(m, c, src[0].device)
    launch(name, *src, y, *out, m, c)
    return y, _egress_payload(*out)


__all__ = ["conv2d", "dwconv", "pool", "act_relu"]
