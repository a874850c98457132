"""Row-streaming op bodies with the fused BFP8 boundary codec — the
counterparts of the reference package's ``kernels/streaming_conv.py``.

Each wrapper keeps the reference's calling convention: ``payload=(man,
exp)`` in place of ``x`` asks for the BFP8 ingress decode inside the op,
``encode=True`` for the output's spill payload from the same call (then
the result is ``(y, (man, exp))``, the payload's channel axis padded to
the codec block with zeros, bitwise what ``bfp8_spill_encode`` gives).

On the CPU every variant runs its plain version (decode -> op -> encode).
On a CUDA tensor a wrapper launches its kernel or raises.  Every variant of
``conv2d`` (``csrc/conv2d.cuh``; ``conv2d.cu``, ``conv2d_decode.cu``),
``dwconv`` (``csrc/dwconv.cu``) and ``pool`` and ``act_relu``
(``csrc/streaming_conv.cu``) has a kernel, named ``<op>``,
``<op>_encode``, ``<op>_decode`` and ``<op>_decode_encode``.

Every fused egress payload, on both devices, leaves through
:func:`_egress_payload`, so a test can plant a fault in the fused encode
alone (``repro_torch.testing.oracle.inject_fault``) while the standalone
codec stays correct.

Tiles.  Every wrapper takes the reference's ``bm`` (row tile) and
``conv2d`` also its ``bc`` (column tile), the plan's ``tile_bm`` /
``tile_bc``; 0 is the kernel's default.  The plain versions have no tiles
and ignore them.  On the card they are launch parameters, and no tile
changes a result (each output is summed in the same order whatever the
tile):

* ``conv2d*``: ``bm`` picks the kernel instance by its row tile, 32, 64 or
  128 rows (0: the largest whose blocks number at least the card's SMs,
  else 32; a ``bm`` below 32 rounds up to 32, one between two instances up
  to the larger, one above 128 down to 128); ``bc``, a multiple of 32,
  sets the output columns a block covers, at most 128 (0: ``n`` rounded
  up to the 32-column codec block and cut into the fewest blocks of at
  most 128 columns, as evenly as 32-column steps allow);
* ``dwconv*``: ``bm`` is the run of output rows a thread slides its tap
  window down, at most 64 (0: 16), for 1 to 7 taps; over more taps a
  thread takes one output row and ``bm`` has nothing to set;
* ``act_relu*`` and ``pool*``: ``bm`` rows a row block, which the grid's
  blocks share (0: one row block of all rows; a ``bm`` that would need
  more than 65535 row blocks grows to ``ceil(m / 65535)``).  A pool over
  more than 8 rows gives each block a chunk of one output row whatever
  ``bm`` is.
"""
from __future__ import annotations

import torch

from . import ref
from .bfp8 import bfp8_dequant_values, bfp8_quant_values
from .library import check_operand, launch
from .streamed_matmul import _round_up

BFP8_BLOCK = 32
CONV2D_BN = 32            # conv2d's bc granularity: one codec block
POOL_SERIAL_MAX_K = 8     # pool sums up to this many rows in one thread
# the pool over more rows (csrc/streaming_conv.cu, pool_layout): blocks of
# POOL_THREADS threads, a channel tile of at most POOL_TILE_QUADS quads,
# each of the block's row lanes summing POOL_LANE_ROWS rows of a chunk
POOL_THREADS = 256
POOL_TILE_QUADS = 64
POOL_LANE_ROWS = 32
# the reference autotuner's tile choices (src/repro/optim/autotune.py)
TILE_BM_CHOICES = (0, 8, 16, 32, 64, 128)
TILE_BC_CHOICES = (0, 32, 64, 128)


def _egress_payload(man: torch.Tensor, exp: torch.Tensor) -> tuple:
    """The identity on a fused egress payload: the one point every fused
    encode's ``(mantissas, exponents)`` passes."""
    return man, exp


def _decode(payload, c: int, block: int) -> torch.Tensor:
    man, exp = payload
    if man.shape[1] != _round_up(c, block):
        raise ValueError(f"payload width {man.shape[1]} does not pad "
                         f"{c} channels to the {block} block")
    return bfp8_dequant_values(man, exp, block=block, c=c)


def _encode(y: torch.Tensor, block: int):
    return bfp8_quant_values(y, block=block,
                             width=_round_up(y.shape[1], block))


def _plain(op, x, c, payload, encode, block):
    """The plain version of one fused launch: decode -> op -> encode."""
    if payload is not None:
        x = _decode(payload, c, block)
    y = op(x)
    return (y, _egress_payload(*_encode(y, block))) if encode else y


def _check_tiles(name: str, bm: int, bc: int = 0) -> None:
    if bm < 0 or bc < 0 or bc % CONV2D_BN:
        raise ValueError(f"{name}: tiles bm={bm}, bc={bc}: both >= 0, bc a "
                         f"multiple of {CONV2D_BN}")


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


def conv2d(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK,
           bm: int = 0, bc: int = 0):
    """1x1 conv ``y = x @ w`` (conv/matmul/deconv), fusion flags and tiles
    as above."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.conv2d_ref(h, w), x, w.shape[0], payload,
                      encode, block)
    _check_codec_block("conv2d", payload, encode, block)
    _check_tiles("conv2d", bm, bc)
    check_operand("conv2d w", w, torch.float32, align=4)
    k, n = w.shape
    if n > 65535 * max(bc, CONV2D_BN):
        raise ValueError(f"conv2d: n={n} exceeds the grid's columns")
    src, m = _input_operands("conv2d", x, payload, k)
    y = torch.empty((m, n), dtype=torch.float32, device=w.device)
    name = _kernel_name("conv2d", payload, encode)
    if not encode:
        launch(name, *src, w, y, m, k, n, bm, bc)
        return y
    out = _empty_payload(m, n, w.device)
    launch(name, *src, w, y, *out, m, k, n, bm, bc)
    return y, _egress_payload(*out)


def dwconv(x, w, *, payload=None, encode=False, block: int = BFP8_BLOCK,
           bm: int = 0):
    """Depthwise temporal conv (w: (taps, c), 'same' padding)."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.dwconv_ref(h, w), x, w.shape[1], payload,
                      encode, block)
    _check_codec_block("dwconv", payload, encode, block)
    _check_tiles("dwconv", bm)
    check_operand("dwconv w", w, torch.float32, align=4)
    taps, c = w.shape
    if taps < 1:
        raise ValueError(f"dwconv: w {tuple(w.shape)} has no taps")
    src, m = _input_operands("dwconv", x, payload, c)
    y = torch.empty((m, c), dtype=torch.float32, device=w.device)
    name = _kernel_name("dwconv", payload, encode)
    if not encode:
        launch(name, *src, w, y, m, c, taps, bm)
        return y
    out = _empty_payload(m, c, w.device)
    launch(name, *src, w, y, *out, m, c, taps, bm)
    return y, _egress_payload(*out)


def pool_layout(k: int, c: int) -> tuple[int, int, int, int, int]:
    """``(tiles, tq, lanes, chunk, chunks)`` of a pool over k >
    POOL_SERIAL_MAX_K rows, as ``pool_layout`` in
    ``csrc/streaming_conv.cu`` computes it: channel tiles of tq quads
    (4 channels), row lanes a block, input rows a block (a chunk) and
    chunks an output row."""
    q4 = -(-c // 4)
    tiles = -(-q4 // POOL_TILE_QUADS)
    tq = -(-q4 // tiles)
    if tiles > 1:
        tq = _round_up(tq, 8)       # a tile holds whole codec blocks
    lanes = POOL_THREADS // tq
    chunk = lanes * POOL_LANE_ROWS
    return tiles, tq, lanes, chunk, -(-k // chunk)


def pool_scratch_size(m_out: int, k: int, c: int) -> int:
    """f32 words of partial sums the pool kernels need beside their outputs:
    none for the serial path (k <= POOL_SERIAL_MAX_K) or one chunk an
    output row, else the chunks' partials, (m_out, chunks, c) (``run_pool``
    in ``csrc/streaming_conv.cu`` lays them out the same way)."""
    if k <= POOL_SERIAL_MAX_K:
        return 0
    _, _, _, _, chunks = pool_layout(k, c)
    return 0 if chunks == 1 else m_out * chunks * c


def pool_counters(m_out: int, k: int, c: int) -> int:
    """The counters a pool launch uses, one an (output row, channel tile)
    where its chunks' partials are summed (else none)."""
    tiles = pool_layout(k, c)[0]
    return m_out * tiles if pool_scratch_size(m_out, k, c) else 0


# The zeroed int32 buffers the pool launches count in, by (device, stream):
# a launch finds its last block by counting up to its chunks, and that
# block sets the counter back to 0, so a buffer is zero between launches on
# its own stream, and launches on two streams never count into one buffer.
# A buffer that a launch outgrows is kept, not freed: work queued on its
# stream (or a graph captured there) may still count in it.  Each new
# buffer at least doubles the last, so the kept ones hold fewer words than
# the newest.
_POOL_COUNTERS: dict = {}


def _counter_buffer(n: int, device) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    bufs = _POOL_COUNTERS.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        size = max(n, 1024, 2 * bufs[-1].numel() if bufs else 0)
        bufs.append(torch.zeros(size, dtype=torch.int32, device=device))
    return bufs[-1][:n]


def pool(x, m_out: int, *, c: int | None = None, payload=None, encode=False,
         block: int = BFP8_BLOCK, bm: int = 0):
    """Mean over k = m / m_out consecutive rows (m -> m_out); with
    ``payload``, ``c`` names the channels it carries."""
    if not _on_cuda(x, payload):
        return _plain(lambda h: ref.pool_ref(h, m_out), x, c, payload,
                      encode, block)
    _check_codec_block("pool", payload, encode, block)
    _check_tiles("pool", bm)
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
    count = _counter_buffer(pool_counters(m_out, k, c), device)
    name = _kernel_name("pool", payload, encode)
    if not encode:
        launch(name, *src, y, scratch, count, m_out, k, c, bm)
        return y
    out = _empty_payload(m_out, c, device)
    launch(name, *src, y, *out, scratch, count, m_out, k, c, bm)
    return y, _egress_payload(*out)


def act_relu(x, *, c: int | None = None, payload=None, encode=False,
             block: int = BFP8_BLOCK, bm: int = 0):
    """relu, with the codec fused as above; with ``payload``, ``c`` names
    the channels it carries."""
    if not _on_cuda(x, payload):
        return _plain(ref.act_relu_ref, x, c, payload, encode, block)
    _check_tiles("act_relu", bm)
    if payload is None and not encode:
        check_operand("act_relu x", x, torch.float32)
        if x.dim() != 2:
            raise ValueError(f"act_relu: x {tuple(x.shape)} is not (m, c)")
        y = torch.empty_like(x)
        launch("act_relu", x, y, x.shape[0], x.shape[1], bm)
        return y
    if payload is None:
        c = x.shape[1]
    elif c is None:
        raise ValueError("act_relu with the ingress decode needs c")
    _check_codec_block("act_relu", payload, encode, block)
    src, m = _input_operands("act_relu", x, payload, c)
    y = torch.empty((m, c), dtype=torch.float32, device=src[0].device)
    name = _kernel_name("act_relu", payload, encode)
    if not encode:
        # the decode alone reads the mantissas four bytes at a time
        check_operand("act_relu man", src[0], torch.int8, align=4)
        launch(name, *src, y, m, c, bm)
        return y
    out = _empty_payload(m, c, src[0].device)
    launch(name, *src, y, *out, m, c, bm)
    return y, _egress_payload(*out)


__all__ = ["conv2d", "dwconv", "pool", "act_relu"]
