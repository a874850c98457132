#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card: name and power limit from ``nvidia-smi``; no CUDA device is a
   failure;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. the main paths, one after the other, on the u200 sheet.  Staged (one
   frame at a
   time): the paper-width UNet (widths 64-1024, 368x480 input), then X3D-M
   at its published stage widths (24-192, 16 frames of 128x128), both on
   their DSE plans; then X3D-M on three hand-cut one-stage plans that
   BFP8-evict every edge deeper than 4096, 96 and 0 words (the skips only,
   then the mid-depth streams, then every stream), each compiled on the
   CPU, written with ``Compiled.save`` and run from ``Compiled.load`` on
   the card (the saved-artifact entry point); a few seeded frames each,
   with the kernel launches counted from 0 around every frame and held
   against the path's own table, and the output held against the same plan
   in ``kernel_mode="reference"`` on the card (naming the first vertex
   where the two part, if they do).
   Pipelined (the 1F1B streamer over 8 microbatches): the YOLO head at
   YOLOv8n's neck widths (64-256, P3 = 160x160) on its DSE plan and on a
   hand-cut 3-stage plan; seeded streams, with the launches counted from 0
   around every stream and held against ticks x the plan's table per tick,
   every microbatch held bit for bit against the staged executor on the
   same plan, and within tolerance against reference mode.
   Served (``Compiled.serve`` -> ``GraphStreamServer``): the same YOLO
   head on its DSE plan with an SLO attached; 20 seeded frames, one flush
   (two full streams and one with 4 bubbles), ``resident_limit=4``; every
   result bit for bit the staged executor's, the counters read back from
   the Prometheus exposition, the launches of every stream held to the
   table; one ``Compiled.trace`` (outputs, Chrome trace, ModelCheck); the
   served frames/s, latency percentiles, SLO verdicts and idle share.
   Fuzzed: the port's conformance fuzzer on the card (seed 0, 12 cases,
   every case on the kernel route), zero violations, with the act
   decode-alone launches held to the lowering's count;
4. hold each kernel against its plain PyTorch version on the card, at every
   shape a path launched it with in phase 3 plus ragged shapes (c = 3, 24,
   40 for the codec variants, payloads with random padding bytes) and the
   edge cases (the BFP8 exponent's, 'same'-padding rows and +-0.0 for
   dwconv); a codec variant's y also bit for bit the un-fused kernel's on
   the decode kernel's output, its payload the codec's of that y; and time
   kernel, plain version and one PyTorch call as a yardstick (CUDA events,
   L2 flushed before every launch);
5. each staged path's frame time and peak device memory, with its spills
   evicted as planned and with the same plan's spills kept on the device,
   its frame time in reference mode, and the device's busy time and idle
   share in one profiled frame (for the YOLO head: ms per microbatch
   pipelined and staged, peak memory of one stream, the 3-stage plan's
   measured stage latencies, one profiled stream);
6. one JSON line of per-kernel numbers, then the result line.

Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): f32 outside
# the tensor cores and HBM3 bandwidth.  bound_ms is the larger of the two
# times for a call's operations and bytes.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

FRAMES = 3
REPS = 20
SPIN_CYCLES = 2_000_000    # about 1 ms at the H100's boost clock
# kernel vs plain: f32 sums in another order (streamed_matmul, conv2d)
MATMUL_TOL = 2e-4          # rtol = atol, as the port's CPU parity tests
# the global pool's tree vs the plain mean: two f32 trees that sum in
# different orders, |kernel - plain| <= POOL_TOL * mean |x| per channel
POOL_TOL = 1e-5
# main path vs reference mode: a one-ulp difference before a BFP8 encode
# may move a mantissa by one step of its block's scale
FRAME_TOL = 2e-2           # of max |reference output|


@dataclasses.dataclass(frozen=True)
class Path:
    name: str
    builder: str
    kwargs: dict
    launches: dict          # per frame, kernels not named launch 0 times
    bfp8_edges: int
    #: None for the DSE plan; else the hand-cut plan
    #: ``hand_cut_plan(g, 1, depth_thresh=...)``, saved with
    #: ``Compiled.save`` and run from ``Compiled.load``
    depth_thresh: float | None = None


# X3D-M's stage widths (build_x3d_m), 16 frames of 128 x 128 after the stem
X3D_M = dict(positions=16 * 128 * 128, cin=3, widths=(24, 48, 96, 192),
             expansion=2, depth=2)


PATHS = (
    # the 8 weight layers with K > 128, 9 relus (4 encode a skip), 4 pools,
    # 4 skip decodes at the concats
    Path("unet", "build_unet_exec",
         dict(positions=368 * 480, base=64, levels=5),
         {"streamed_matmul": 8, "act_relu": 5, "act_relu_encode": 4,
          "pool": 4, "bfp8_dequant": 4}, 4),
    # X3D-M's stage widths (build_x3d_m) at expansion 2 and depth 2: the 8
    # SE bottleneck convs at m = 1 and the head through conv2d, 9 dwconvs,
    # 4 standalone encodes (add_14 and three fragmented stage-end convs),
    # the feature-bank skip encoded by its pool, 9 pools (4 global), 13
    # relus (1 encodes), 6 decodes, 5 fragmented layers with K > 128
    Path("x3d", "build_x3d_exec", X3D_M,
         {"conv2d": 9, "dwconv": 9, "bfp8_quant": 4, "pool_encode": 1,
          "pool": 9, "act_relu": 12, "act_relu_encode": 1,
          "bfp8_dequant": 6, "streamed_matmul": 5}, 6),
    # the hand-cut plans, nothing fragmented: the 10 edges deeper than 4096
    # words (the skips; 3 encoded by a conv, 4 by a dwconv, 1 each by a
    # relu, a pool and the standalone quant)
    Path("x3d-evict-deep", "build_x3d_exec", X3D_M,
         {"conv2d": 23, "conv2d_encode": 3, "dwconv": 5, "dwconv_encode": 4,
          "pool": 9, "pool_encode": 1, "act_relu": 12, "act_relu_encode": 1,
          "bfp8_quant": 1, "bfp8_dequant": 10}, 10, 4096.0),
    # ... and the streams at 128 and 64 words: single-input consumers
    # decode inside their own launch
    Path("x3d-evict-mid", "build_x3d_exec", X3D_M,
         {"conv2d": 18, "conv2d_decode": 5, "conv2d_decode_encode": 3,
          "dwconv": 1, "dwconv_decode": 4, "dwconv_decode_encode": 4,
          "pool": 5, "pool_encode": 1, "pool_decode": 4, "act_relu": 4,
          "act_relu_encode": 9, "bfp8_quant": 11, "bfp8_dequant": 11},
         31, 96.0),
    # every stream: every op with one input decodes and encodes in one
    # launch, the SE global pools among them (k up to 262144)
    Path("x3d-evict-all", "build_x3d_exec", X3D_M,
         {"conv2d_decode_encode": 26, "dwconv_decode_encode": 9,
          "pool_decode_encode": 10, "act_relu_decode_encode": 13,
          "bfp8_quant": 11, "bfp8_dequant": 21}, 79, 0.0),
)


@dataclasses.dataclass(frozen=True)
class StreamPath:
    """A pipelined path: ``launches`` per tick (every stage runs at every
    tick, bubbles included, so a stream launches ticks x the table)."""
    name: str
    builder: str
    kwargs: dict
    plan: str               # "dse" or "three-stage" (hand_cut_plan)
    microbatches: int
    ticks: int
    launches: dict          # per tick, kernels not named launch 0 times
    bfp8_edges: int
    crossings: int          # stage-crossing edges (shift registers)


# YOLOv8n's neck widths at the 1280 setting's P3 (160x160 positions)
YOLO = dict(positions=160 * 160, widths=(64, 128, 256), head=64)
STREAM_PATHS = (
    # the DSE plan: one stage, conv_24 and conv_27 BFP8-evicted and encoded
    # by their own conv2d launch; 4 fragmented convs with K > 128 (conv_8,
    # K = 128, is a plain dot), 6 relus, 4 pools, 2 decodes at the output
    StreamPath("yolo", "build_yolo_head_exec", YOLO, "dse", 8, 8,
               {"conv2d": 6, "conv2d_encode": 2, "streamed_matmul": 4,
                "act_relu": 6, "pool": 4, "bfp8_dequant": 2}, 2, 0),
    # the 3-stage plan: 6 BFP8 edges (3 decoded from the crossing shift
    # registers at the tick), 3 raw crossings, nothing fragmented
    StreamPath("yolo-3stage", "build_yolo_head_exec", YOLO, "three-stage",
               8, 10,
               {"conv2d": 10, "conv2d_encode": 3, "act_relu": 3,
                "act_relu_encode": 3, "pool": 4, "bfp8_dequant": 6}, 6, 6),
)
STREAMS = 2

# the fuzz path: the port's conformance fuzzer on the card, seed 0, every
# case on the kernel route (the generator's last draw, so no other draw
# moves); its act decode-alone launches, counted from the lowering on the
# CPU by tests/test_torch_fuzz.py (cases 0-6, 0-10, 0-11: 4 + 3 + 4 frames)
FUZZ_SEED = 0
FUZZ_CASES = 12
FUZZ_P_PALLAS = 1.0
FUZZ_ACT_DECODE_LAUNCHES = 11

# the served path: the YOLO head's DSE stream behind GraphStreamServer
SERVE_FRAMES = 20           # 2 full streams of 8 and one with 4 bubbles
SERVE_RESIDENT = 4          # results kept on the card; the rest go to host
SERVE_ROUNDS = 3            # timed flushes of SERVE_FRAMES, fresh server
# the SLO the served path is scored against: submit -> result of 20 frames
# queued at once, three streams deep
SERVE_SLO = dict(p50_target_s=0.25, p99_target_s=0.5)

TPU_SRC = {
    "streamed_matmul": "src/repro/kernels/streamed_matmul.py:31",
    "act_relu": "src/repro/kernels/streaming_conv.py:409",
    "act_relu_encode": "src/repro/kernels/streaming_conv.py:418",
    "pool": "src/repro/kernels/streaming_conv.py:320",
    "bfp8_dequant": "src/repro/kernels/bfp8.py:55",
    "conv2d": "src/repro/kernels/streaming_conv.py:81",
    "dwconv": "src/repro/kernels/streaming_conv.py:200",
    "bfp8_quant": "src/repro/kernels/bfp8.py:51",
    "pool_encode": "src/repro/kernels/streaming_conv.py:330",
    "conv2d_encode": "src/repro/kernels/streaming_conv.py:91",
    "conv2d_decode": "src/repro/kernels/streaming_conv.py:86",
    "conv2d_decode_encode": "src/repro/kernels/streaming_conv.py:97",
    "dwconv_encode": "src/repro/kernels/streaming_conv.py:217",
    "dwconv_decode": "src/repro/kernels/streaming_conv.py:209",
    "dwconv_decode_encode": "src/repro/kernels/streaming_conv.py:229",
    "pool_decode": "src/repro/kernels/streaming_conv.py:325",
    "pool_decode_encode": "src/repro/kernels/streaming_conv.py:339",
    "act_relu_decode_encode": "src/repro/kernels/streaming_conv.py:426",
    "act_relu_decode": "src/repro/kernels/streaming_conv.py:413",
}
CUDA_SRC = {
    "streamed_matmul": "src/repro_torch/csrc/streamed_matmul.cu",
    "act_relu": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "pool": "src/repro_torch/csrc/streaming_conv.cu",
    "bfp8_dequant": "src/repro_torch/csrc/bfp8.cu",
    "conv2d": "src/repro_torch/csrc/conv2d.cu",
    "dwconv": "src/repro_torch/csrc/dwconv.cu",
    "bfp8_quant": "src/repro_torch/csrc/bfp8.cu",
    "pool_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "conv2d_encode": "src/repro_torch/csrc/conv2d.cu",
    "conv2d_decode": "src/repro_torch/csrc/conv2d.cu",
    "conv2d_decode_encode": "src/repro_torch/csrc/conv2d.cu",
    "dwconv_encode": "src/repro_torch/csrc/dwconv.cu",
    "dwconv_decode": "src/repro_torch/csrc/dwconv.cu",
    "dwconv_decode_encode": "src/repro_torch/csrc/dwconv.cu",
    "pool_decode": "src/repro_torch/csrc/streaming_conv.cu",
    "pool_decode_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_decode_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_decode": "src/repro_torch/csrc/streaming_conv.cu",
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Mean device time of a call, L2 flushed before each launch.  A spin
    kernel of about 1 ms runs between the flush and the first event, so
    the host has enqueued the whole call before the card reaches it and
    the events time the card's work, not the host's wrapper and launch
    overhead (which phase 5's frame times include)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, timer, path_shapes):
    """Hold every kernel against its plain version at each ``(name, tensor
    shapes)`` a path launched, and time kernel, plain version and
    yardstick.  ``path_shapes`` maps each path to its launch shapes and
    their counts per frame (a staged path) or per stream (a pipelined
    path); a kernel's times and bounds are summed over one frame or stream
    of each path (and kept per path under ``by_path``).  Returns per-kernel
    rows."""
    from repro_torch.kernels import ref, streaming_conv as SC
    from repro_torch.kernels.bfp8 import (bfp8_dequant, bfp8_quant,
                                          bfp8_quant_values)
    from repro_torch.kernels.library import reset_launches
    from repro_torch.kernels.streamed_matmul import (streamed_matmul,
                                                     streamed_matmul_padded)

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def randi8(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    rows = {n: dict(name=n, route="cuda", source=CUDA_SRC[n],
                    replaces=TPU_SRC[n], launches=0, max_abs_err=0.0, ms=0.0,
                    plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
                    library_ms=0.0, by_path={})
            for n in TPU_SRC}

    def note_err(name, err):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        float(err.max()) if err.numel()
                                        else 0.0)

    def close(name, got, want, rtol, atol):
        err = (got.double() - want.double()).abs()
        note_err(name, err)
        bad = int((err > atol + rtol * want.double().abs()).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} values outside "
                                 f"atol={atol} rtol={rtol}")

    def exact(name, got, want, nan_bits=True):
        """Bit for bit, NaN and the sign of zero included (with
        ``nan_bits=False`` a NaN need only be a NaN where the plain
        version has one: arithmetic on a NaN may set other payload bits)."""
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        if got.dtype == torch.float32:
            if not nan_bits:
                nan = torch.isnan(want)
                if not torch.equal(torch.isnan(got), nan):
                    raise AssertionError(f"{name}: NaN at other places")
                got, want = got[~nan], want[~nan]
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-exact")

    def pool_close(name, got, x, m_out):
        """The global pool: within POOL_TOL * mean |x| of each channel of
        the plain mean of ``x``."""
        m, c = x.shape
        want = ref.pool_ref(x, m_out)
        err = (got.double() - want.double()).abs()
        note_err(name, err)
        lim = POOL_TOL * x.abs().double().reshape(m_out, m // m_out,
                                                  c).mean(1)
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: global pool outside "
                                 f"{POOL_TOL} x mean|x|")

    def check_pool(x, m_out):
        if x.shape[0] // m_out == 2:
            exact("pool", SC.pool(x, m_out), ref.pool_ref(x, m_out))
        else:
            pool_close("pool", SC.pool(x, m_out), x, m_out)

    def check_dwconv(x, w):
        exact("dwconv", SC.dwconv(x, w), ref.dwconv_ref(x, w))

    # -- the fused-codec variants ----------------------------------------------
    def payload_of(m, c):
        """The codec's payload of a random (m, c) stripe, with random bytes
        in its padding channels: the kernels and the plain versions read
        only the first c."""
        man, exp = bfp8_quant_values(F.pad(randn(m, c) * 2, (0, (-c) % 32)),
                                     block=32)
        if c % 32:
            man[:, c:] = randi8(-127, 127, m, man.shape[1] - c)
        return man, exp

    def variant(kind, c, m_out=None, w=None):
        """(kernel, plain version, the un-fused kernel or None) of a codec
        variant; the first two take (x, payload)."""
        op = kind.split("_decode")[0].removesuffix("_encode")
        enc = kind.endswith("_encode")
        if op == "conv2d":
            def body(h):
                return ref.conv2d_ref(h, w)
            fn = functools.partial(SC.conv2d, w=w)
            unfused = lambda h: SC.conv2d(h, w)                 # noqa: E731
        elif op == "dwconv":
            def body(h):
                return ref.dwconv_ref(h, w)
            fn = functools.partial(SC.dwconv, w=w)
            unfused = lambda h: SC.dwconv(h, w)                 # noqa: E731
        elif op == "pool":
            def body(h):
                return ref.pool_ref(h, m_out)
            fn = functools.partial(SC.pool, m_out=m_out, c=c)
            unfused = lambda h: SC.pool(h, m_out)               # noqa: E731
        else:
            body, unfused = ref.act_relu_ref, SC.act_relu
            fn = functools.partial(SC.act_relu, c=c)

        def kern(x, pay):
            return fn(x, payload=pay, encode=enc)

        def plain(x, pay):
            return SC._plain(body, x, c, pay, enc, 32)
        return kern, plain, unfused

    def check_variant(kind, x, pay, c, m_out=None, w=None, nan_bits=True):
        """y bit for bit the un-fused kernel's on the input (the standalone
        decode kernel's output, for a decoding variant) and the payload bit
        for bit the codec's of that y; y within MATMUL_TOL (conv2d) or
        POOL_TOL (pool, k > 2) of the plain version, else bit for bit."""
        kern, plain, unfused = variant(kind, c, m_out, w)
        enc = kind.endswith("_encode")
        got, want = kern(x, pay), plain(x, pay)
        (y, ypay), (py, ppay) = ((got, want) if enc
                                 else ((got, None), (want, None)))
        xin = x if pay is None else bfp8_dequant(*pay)[:, :c].contiguous()
        exact(kind, y, unfused(xin), nan_bits)
        if enc:
            ppay = bfp8_quant_values(F.pad(y, (0, (-y.shape[1]) % 32)),
                                     block=32)
        if kind.startswith("conv2d"):
            close(kind, y, py, MATMUL_TOL, MATMUL_TOL)
        elif kind.startswith("pool") and xin.shape[0] // m_out > 2:
            pool_close(kind, y, xin, m_out)
        else:
            exact(kind, y, py, nan_bits)
        if enc:
            exact(kind, ypay[0], ppay[0])
            exact(kind, ypay[1], ppay[1])

    def codec_case(kind, arg_shapes):
        """A codec variant at one launch's shapes: the input (x, or its
        payload) and y give m, c and m_out, the weight its shape."""
        dec = "_decode" in kind
        ins, rest = arg_shapes[:1 + dec], arg_shapes[1 + dec:]
        m = ins[0][0]
        weighted = kind.startswith(("conv2d", "dwconv"))
        wshape = rest[0] if weighted else None
        m_out, c_out = rest[1] if weighted else rest[0]
        c = wshape[0] if kind.startswith("conv2d") else c_out
        w = None
        if kind.startswith("conv2d"):
            w = randn(*wshape) / math.sqrt(c)
            ops = 2.0 * m * c * c_out
        elif weighted:
            w = randn(*wshape)
            ops = 2.0 * wshape[0] * m * c
        else:
            ops = float(m * c)
        pay = payload_of(m, c) if dec else None
        x = None if dec else randn(m, c)
        kern, plain, _ = variant(kind, c, m_out, w)
        cq, nq = 32 * -(-c // 32), 32 * -(-c_out // 32)
        nbytes = ((m * (cq + cq // 32) if dec else 4.0 * m * c)
                  + (4.0 * w.numel() if w is not None else 0.0)
                  + 4.0 * m_out * c_out)
        if kind.endswith("_encode"):
            nbytes += m_out * (nq + nq // 32)
            ops += 6.0 * m_out * nq
        if dec:
            ops += m * c
        return ((lambda: check_variant(kind, x, pay, c, m_out, w)),
                lambda: kern(x, pay), lambda: plain(x, pay), None, nbytes,
                ops)

    def case(kind, arg_shapes):
        """Inputs at one launch's shapes: (check, kernel, plain, yardstick
        or None, bytes moved, operations)."""
        if kind.endswith("_encode") or "_decode" in kind:
            return codec_case(kind, arg_shapes)
        if kind == "streamed_matmul":
            (m, k), (ks, n), (kd, _), _ = arg_shapes
            x = randn(m, k)
            ws, wd = randn(ks, n) / math.sqrt(k), randn(kd, n) / math.sqrt(k)
            w = torch.cat([ws, wd])
            kern = lambda: streamed_matmul(x, ws, wd)          # noqa: E731
            plain = lambda: ref.streamed_matmul_ref(x, ws, wd)  # noqa: E731
            return ((lambda: close(kind, kern(), plain(), MATMUL_TOL,
                                   MATMUL_TOL)),
                    kern, plain, lambda: torch.matmul(x, w),
                    4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
        if kind == "conv2d":
            (m, k), (_, n), _ = arg_shapes
            x, w = randn(m, k), randn(k, n) / math.sqrt(k)
            kern = lambda: SC.conv2d(x, w)                     # noqa: E731
            plain = lambda: ref.conv2d_ref(x, w)               # noqa: E731
            return ((lambda: close(kind, kern(), plain(), MATMUL_TOL,
                                   MATMUL_TOL)),
                    kern, plain, lambda: torch.matmul(x, w),
                    4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
        if kind == "dwconv":
            (m, c), (taps, _), _ = arg_shapes
            x, w = randn(m, c), randn(taps, c)
            xt, wt = x.t().contiguous()[None], w.t().contiguous()[:, None]
            return ((lambda: check_dwconv(x, w)),
                    lambda: SC.dwconv(x, w),
                    lambda: ref.dwconv_ref(x, w),
                    lambda: F.conv1d(xt, wt, padding=taps // 2, groups=c),
                    4.0 * (2 * m * c + taps * c), 2.0 * taps * m * c)
        if kind == "act_relu":
            (m, c), _ = arg_shapes
            x = randn(m, c)
            kern = lambda: SC.act_relu(x)                      # noqa: E731
            plain = lambda: ref.act_relu_ref(x)                # noqa: E731
            return ((lambda: exact(kind, kern(), plain())), kern, plain,
                    lambda: torch.relu(x), 8.0 * m * c, m * c)
        if kind == "pool":
            (m, c), (m_out, _), _ = arg_shapes
            x = randn(m, c)
            kern = lambda: SC.pool(x, m_out)                   # noqa: E731
            plain = lambda: ref.pool_ref(x, m_out)             # noqa: E731
            return ((lambda: check_pool(x, m_out)), kern, plain,
                    lambda: x.view(m_out, m // m_out, c).mean(1),
                    4.0 * (m * c + m_out * c), m * c)
        if kind == "bfp8_quant":
            (r, c), _, (_, nb) = arg_shapes
            x = randn(r, c) * 4
            kern = lambda: bfp8_quant(x)                       # noqa: E731
            plain = lambda: bfp8_quant_values(x, block=32)     # noqa: E731

            def check():
                (man, exp), (pman, pexp) = kern(), plain()
                exact(kind, man, pman)
                exact(kind, exp, pexp)
            return (check, kern, plain, None, 5.0 * r * c + r * nb,
                    6.0 * r * c)
        (r, c), (_, nb), _ = arg_shapes                        # bfp8_dequant
        man, exp = randi8(-127, 127, r, c), randi8(-30, 20, r, nb)
        kern = lambda: bfp8_dequant(man, exp)                  # noqa: E731
        plain = lambda: ref.bfp8_dequant_ref(man, exp)         # noqa: E731
        return ((lambda: exact(kind, kern(), plain())), kern, plain, None,
                5.0 * r * c + r * nb, r * c)

    # -- at the paths' shapes: correctness, then times per frame or stream ----
    # a kernel's bound_by: what bounds most of its summed bound time
    bound_parts = collections.defaultdict(collections.Counter)
    union = collections.Counter()
    for shapes in path_shapes.values():
        union.update(shapes)
    for key in sorted(union):
        kind, arg_shapes = key
        check, kern, plain, lib, nbytes, ops = case(kind, arg_shapes)
        check()
        t_kern, t_plain = timer(kern), timer(plain)
        t_lib = None if lib is None else timer(lib)
        b, bound_by = bound_ms(nbytes, ops)
        print(f"  {kind} {arg_shapes}: ms {t_kern:.4f} plain {t_plain:.4f} "
              f"library {'-' if t_lib is None else f'{t_lib:.4f}'} bound "
              f"{b:.4f} ({bound_by}), on the paths x{union[key]}")
        row = rows[kind]
        for pname, shapes in path_shapes.items():
            n = shapes.get(key, 0)
            if not n:
                continue
            row["ms"] += n * t_kern
            row["plain_ms"] += n * t_plain
            row["library_ms"] = None if t_lib is None else (
                row["library_ms"] + n * t_lib)
            row["bound_ms"] += n * b
            bound_parts[kind][bound_by] += n * b
            row["bound_by"] = max(bound_parts[kind],
                                  key=bound_parts[kind].get)
            p = row["by_path"].setdefault(pname, dict(
                launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=None if t_lib is None else 0.0))
            p["launches"] += n
            p["ms"] += n * t_kern
            p["plain_ms"] += n * t_plain
            p["bound_ms"] += n * b
            if t_lib is not None:
                p["library_ms"] += n * t_lib

    # -- ragged shapes and edge cases ----------------------------------------
    for m, k, n, f in ((1000, 300, 200, 0.0), (77, 1536, 130, 0.5)):
        x, w = randn(m, k), randn(k, n) / math.sqrt(k)
        close("streamed_matmul", streamed_matmul_padded(x, w,
                                                        static_fraction=f),
              ref.conv2d_ref(x, w), MATMUL_TOL, MATMUL_TOL)
    for m, k, n in ((77, 45, 130), (300, 17, 5), (1, 1, 1)):
        x, w = randn(m, k), randn(k, n) / math.sqrt(k)
        close("conv2d", SC.conv2d(x, w), ref.conv2d_ref(x, w), MATMUL_TOL,
              MATMUL_TOL)
        check_variant("conv2d_encode", x, None, k, w=w)
    for m, c in ((77, 45), (3, 1), (129, 96)):
        x = randn(m, c)
        exact("act_relu", SC.act_relu(x), ref.act_relu_ref(x))
        check_variant("act_relu_encode", x, None, c)
        check_variant("pool_encode", randn(2 * m, c), None, c, m)
    # every variant at c = 3, 24 and 40 (a payload's padding channels
    # hold random bytes), rows not a multiple of any tile: m = 77 and
    # 4099, and for pool k = 2 and k = m (the global pool)
    for c in (3, 24, 40):
        for m in (77, 4099):
            for kind in ("conv2d_decode", "conv2d_decode_encode"):
                check_variant(kind, None, payload_of(m, c), c,
                              w=randn(c, 130) / math.sqrt(c))
            for kind in ("dwconv_encode", "dwconv_decode",
                         "dwconv_decode_encode"):
                for taps in (3, 5):
                    dec = "_decode" in kind
                    check_variant(kind, None if dec else randn(m, c),
                                  payload_of(m, c) if dec else None, c,
                                  w=randn(taps, c))
            check_variant("act_relu_decode_encode", None, payload_of(m, c), c)
            check_variant("act_relu_decode", None, payload_of(m, c), c)
            for m_out in (m, 1):
                for kind in ("pool_decode", "pool_decode_encode",
                             "pool_encode"):
                    k = 2 if m_out == m else 2 * m
                    dec = "_decode" in kind
                    check_variant(kind, None if dec else randn(k * m_out, c),
                                  payload_of(k * m_out, c) if dec else None,
                                  c, m_out)
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -1.0],
                            device="cuda")
    exact("act_relu", SC.act_relu(specials[None, :]),
          ref.act_relu_ref(specials[None, :]))
    # dwconv: 'same'-padding rows at both ends of x and of a block's tile,
    # +-0.0 in x and w (the plain tap sum starts from 0 + w0 x0, so a -0.0
    # product becomes +0.0), taps other than 3
    for m, c, taps in ((1, 24, 3), (2, 48, 3), (86, 24, 3), (4097, 384, 3),
                       (300, 40, 5), (77, 96, 2)):
        x, w = randn(m, c), randn(taps, c)
        x[0, :4] = -0.0
        x[-1, 4:8] = 0.0
        x[m // 2, 8:12] = -0.0
        w[:, 0] = -0.0
        check_dwconv(x, w)
        check_variant("dwconv_encode", x, None, c, w=w)
    # BFP8 exponent edge cases: block amax at 2^k (1 + j 2^-23), j in
    # -3..3, across the normal range and into the subnormals, plus all-zero
    # blocks (exp 0), blocks whose values round half-way, and blocks that
    # hold a NaN or an infinity (exp 0, a NaN's mantissa 0); the same rows
    # through the relu encode, the standalone quant and the pool encode (a
    # mean of two equal rows is the row)
    k = torch.arange(-140, 40, device="cuda", dtype=torch.float32)
    j = torch.arange(-3, 4, device="cuda", dtype=torch.float32)
    amax = (torch.exp2(k)[:, None] * (1 + j[None, :] * 2.0**-23)).reshape(-1)
    x = randn(amax.numel(), 64).clamp(-1, 1) * amax[:, None] * 0.999
    x[:, 0] = amax
    x[:, 33] = -amax
    x[::5, 32:] = 0.0
    x[1::7, 1] = amax[1::7] * (2.5 / 64)        # x / scale = 2.5: ties
    x[2::11, 7] = float("nan")
    x[3::11, 40] = float("inf")
    x[4::11, 9], x[4::11, 50] = float("nan"), float("inf")
    x[5::11, 60] = -float("inf")
    check_variant("act_relu_encode", x, None, 64)
    man, exp = bfp8_quant(x)
    pman, pexp = bfp8_quant_values(x, block=32)
    exact("bfp8_quant", man, pman)
    exact("bfp8_quant", exp, pexp)
    check_variant("pool_encode", x.repeat_interleave(2, dim=0), None, 64,
                  x.shape[0], nan_bits=False)
    # the same blocks as payloads: the decode of every exponent from the
    # subnormals up, through relu's decode (alone and -> encode) and a k = 2
    # pool's
    check_variant("act_relu_decode_encode", None, (man, exp), 64)
    check_variant("act_relu_decode", None, (man, exp), 64)
    check_variant("pool_decode_encode", None,
                  (man.repeat_interleave(2, dim=0),
                   exp.repeat_interleave(2, dim=0)), 64, x.shape[0])
    # the conv encode's epilogue on the same blocks: x @ I is x exactly
    # (every other product is +-0), so the finite rows reach it unchanged
    # through the product, in a ragged last row tile
    fin = x[torch.isfinite(x).all(1)][:1000]
    check_variant("conv2d_encode", fin, None, 64,
                  w=torch.eye(64, device="cuda"))
    for m, c, m_out in ((4096, 96, 1), (3 * 70001, 40, 3)):
        g = randn(m, c)
        pool_close("pool", SC.pool(g, m_out), g, m_out)
    man, exp = randi8(-128, 127, 300, 96), randi8(-128, 127, 300, 3)
    exact("bfp8_dequant", bfp8_dequant(man, exp),
          ref.bfp8_dequant_ref(man, exp))
    # the decode alone at the shape the YOLO head's acts run at, beside its
    # siblings there (no path launches it at this shape)
    check, kern, plain, _, nbytes, ops = case(
        "act_relu_decode", ((25600, 64), (25600, 2), (25600, 64)))
    check()
    t_kern, t_plain = timer(kern), timer(plain)
    b, bound_by = bound_ms(nbytes, ops)
    rows["act_relu_decode"]["at_25600x64"] = dict(
        ms=t_kern, plain_ms=t_plain, bound_ms=b, bound_by=bound_by)
    print(f"  act_relu_decode at 25600 x 64: ms {t_kern:.4f} plain "
          f"{t_plain:.4f} bound {b:.4f} ({bound_by})")
    torch.cuda.synchronize()
    reset_launches()        # the comparisons above are not path launches
    return rows


def frame_stats(torch, comp, x) -> tuple[float, int]:
    """Median host-clock ms of 5 frames, and the peak device memory one
    frame allocates above what is held before it (weights, input)."""
    comp.run(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comp.run(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        comp.run(x)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), peak


def first_divergence(torch, main, refc, x) -> str:
    """The first vertex, in topological order, where the two compiled
    designs' outputs part by more than FRAME_TOL x max |reference|."""
    got = main.executor.run_intermediates(x)
    want = refc.executor.run_intermediates(x)
    for name, w in want.items():
        err = float((got[name] - w).abs().max()) if w.numel() else 0.0
        lim = FRAME_TOL * float(w.abs().max()) if w.numel() else 0.0
        if err > lim:
            return (f"{name} ({main.graph.vertex(name).kind}, max|y - "
                    f"ref| {err:.3e} > {lim:.3e})")
    return "no vertex"


def compile_path(repro_torch, path: Path, g):
    """The path's compiled design on the card: the DSE plan through
    ``compile``, or the hand-cut plan compiled on the CPU, written with
    ``Compiled.save`` and read back with ``Compiled.load``."""
    if path.depth_thresh is None:
        return repro_torch.compile(repro_torch.CompileSpec(
            model=g, device="u200", strategy="dse", mode="staged"))
    from repro_torch.core import hand_cut_plan
    saved = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", mode="staged",
        plan=hand_cut_plan(g, 1, depth_thresh=path.depth_thresh),
        torch_device="cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        art = saved.save(pathlib.Path(tmp) / f"{path.name}.smof.json")
        print(f"[{path.name}] artifact: {art.stat().st_size} bytes")
        return repro_torch.Compiled.load(art)


def run_path(torch, repro_torch, library, path: Path):
    """Phase 3 for one path: compile, then FRAMES seeded frames, each with
    its launches counted from 0 and its output held against reference
    mode.  Returns (compiled, reference-mode compiled, launches per frame,
    launch shapes per frame)."""
    from repro_torch.core import builders
    g = getattr(builders, path.builder)(**path.kwargs)
    t0 = time.perf_counter()
    main = compile_path(repro_torch, path, g)
    kind = "DSE" if path.depth_thresh is None else "hand-cut"
    print(f"[{path.name}] compile ({kind} plan + lowering): "
          f"{time.perf_counter() - t0:.2f} s; kernel_mode "
          f"{main.spec.kernel_mode} on {main.executor.device}")
    if main.executor.device.type != "cuda":
        raise AssertionError(f"[{path.name}] not on the card")
    rep = main.report()
    bfp8 = [s for s in main.executor.report.spills
            if s.codec == "bfp8" and s.reason == "evicted"]
    print(f"[{path.name}] spill report: {json.dumps(rep['traffic'])}")
    print(f"[{path.name}] bfp8-evicted edges ({len(bfp8)}): "
          f"{[(s.src, s.dst) for s in bfp8]}, "
          f"{sum(s.offchip_bits for s in bfp8) // 8} bytes each way")
    if len(bfp8) != path.bfp8_edges:
        raise AssertionError(f"[{path.name}] expected {path.bfp8_edges} "
                             f"BFP8-evicted edges, got {len(bfp8)}")
    refc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, device="u200", strategy="manual-plan",
        plan=main.plan, mode="staged", kernel_mode="reference"))
    refc.executor.params = main.executor.params
    expected = dict.fromkeys(library.SIGNATURES, 0) | path.launches
    m, c = main.input_shape()
    shapes = None
    for f in range(FRAMES):
        x = torch.randn((m, c), generator=torch.Generator().manual_seed(f))
        xd = x.cuda()
        torch.cuda.synchronize()
        library.reset_launches()
        y = main.run(xd)
        torch.cuda.synchronize()
        counts = library.launches()
        if shapes is None:
            shapes = library.launch_shapes()
        elif library.launch_shapes() != shapes:
            raise AssertionError(f"[{path.name}] frame {f}: launch shapes "
                                 f"changed")
        if counts != expected:
            raise AssertionError(f"[{path.name}] frame {f}: launches "
                                 f"{counts}, expected {expected}")
        yr = refc.run(xd)
        torch.cuda.synchronize()
        if y.shape != yr.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"[{path.name}] frame {f}: bad output "
                                 f"{tuple(y.shape)}")
        err = float((y - yr).abs().max())
        scale = float(yr.abs().max())
        print(f"[{path.name}] frame {f}: output {tuple(y.shape)} "
              f"max|y - ref| {err:.3e} (tol {FRAME_TOL} x max|ref| = "
              f"{FRAME_TOL * scale:.3e})")
        if err > FRAME_TOL * scale:
            raise AssertionError(
                f"[{path.name}] frame {f}: main path leaves reference; "
                f"first diverging vertex: "
                f"{first_divergence(torch, main, refc, xd)}")
    print(f"[{path.name}] launches per frame: "
          f"{ {k: n for k, n in counts.items() if n} }")
    for (name, arg_shapes), n in sorted(shapes.items()):
        print(f"  {name} {arg_shapes} x{n}")
    return main, refc, counts, shapes


def bit_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def run_stream_path(torch, repro_torch, library, path: StreamPath):
    """Phase 3 for a pipelined path: compile, then STREAMS seeded streams
    of ``path.microbatches``, each with its launches counted from 0, every
    microbatch held bit for bit against the staged executor on the same
    plan and within FRAME_TOL against reference mode.  Returns (compiled,
    staged, reference-mode compiled, launches per stream, launch shapes
    per stream)."""
    from repro_torch.core import builders, hand_cut_plan
    g = getattr(builders, path.builder)(**path.kwargs)
    B = path.microbatches
    spec = dict(model=g, device="u200", mode="pipelined", microbatches=B)
    if path.plan == "dse":
        spec["strategy"] = "dse"
    else:
        spec.update(strategy="manual-plan", plan=hand_cut_plan(g))
    t0 = time.perf_counter()
    main = repro_torch.compile(repro_torch.CompileSpec(**spec))
    print(f"[{path.name}] compile ({path.plan} plan + lowering): "
          f"{time.perf_counter() - t0:.2f} s")
    sx = main.executor
    print(f"[{path.name}] stream report: "
          f"{json.dumps(main.report()['traffic'])}")
    bfp8 = [r for r in sx.report.spills if r.codec == "bfp8"]
    print(f"[{path.name}] bfp8-evicted edges: "
          f"{[(r.src, r.dst) for r in bfp8]}, "
          f"{sum(r.offchip_bits for r in bfp8) // 8} bytes each way; "
          f"crossings {sx._crossing}; off-chip "
          f"{sum(r.offchip_bits for r in sx.report.spills) // 8} bytes "
          f"per microbatch each way")
    if len(bfp8) != path.bfp8_edges or len(sx._crossing) != path.crossings:
        raise AssertionError(f"[{path.name}] expected {path.bfp8_edges} "
                             f"BFP8 edges and {path.crossings} crossings")
    if sx.report.ticks != path.ticks:
        raise AssertionError(f"[{path.name}] {sx.report.ticks} ticks, "
                             f"expected {path.ticks}")
    plan_spec = dict(model=g, device="u200", strategy="manual-plan",
                     plan=main.plan)
    staged = repro_torch.compile(repro_torch.CompileSpec(**plan_spec))
    refc = repro_torch.compile(repro_torch.CompileSpec(
        **plan_spec, mode="pipelined", microbatches=B,
        kernel_mode="reference"))
    staged.executor.params = refc.executor.params = sx.params
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        k: path.ticks * n for k, n in path.launches.items()}
    m, c = main.input_shape()
    shapes = None
    for st in range(STREAMS):
        xs = torch.randn((B, m, c),
                         generator=torch.Generator().manual_seed(100 + st))
        xd = xs.cuda()
        torch.cuda.synchronize()
        library.reset_launches()
        ys = main.run(xd)
        torch.cuda.synchronize()
        counts = library.launches()
        if shapes is None:
            shapes = library.launch_shapes()
        elif library.launch_shapes() != shapes:
            raise AssertionError(f"[{path.name}] stream {st}: launch "
                                 f"shapes changed")
        if counts != expected:
            raise AssertionError(f"[{path.name}] stream {st}: launches "
                                 f"{counts}, expected {expected}")
        if ys.shape[0] != B or not bool(torch.isfinite(ys).all()):
            raise AssertionError(f"[{path.name}] stream {st}: bad output "
                                 f"{tuple(ys.shape)}")
        yr = refc.run(xd)
        torch.cuda.synchronize()
        errs = []
        for b in range(B):
            if not bit_equal(torch, ys[b], staged.run(xd[b])):
                raise AssertionError(f"[{path.name}] stream {st}, "
                                     f"microbatch {b}: pipelined and "
                                     f"staged part")
            err = float((ys[b] - yr[b]).abs().max())
            lim = FRAME_TOL * float(yr[b].abs().max())
            errs.append(err / lim)
            if err > lim:
                raise AssertionError(f"[{path.name}] stream {st}, "
                                     f"microbatch {b}: leaves reference")
        print(f"[{path.name}] stream {st}: output {tuple(ys.shape)}, every "
              f"microbatch bit-equal to the staged executor; max|y - ref| "
              f"at most {max(errs):.3e} of its tolerance ({FRAME_TOL} x "
              f"max|ref|)")
    print(f"[{path.name}] launches per stream ({path.ticks} ticks): "
          f"{ {k: n for k, n in counts.items() if n} }")
    for (name, arg_shapes), n in sorted(shapes.items()):
        print(f"  {name} {arg_shapes} x{n}")
    return main, staged, refc, counts, shapes


def serve_phase(torch, repro_torch, library, path: StreamPath):
    """The served path: ``Compiled.serve`` over the YOLO head's DSE stream,
    SERVE_FRAMES seeded frames in one flush with ``resident_limit``; every
    result (resident or restored) bit for bit the staged executor's, the
    counters read back from ``metrics_text()``, each stream's launches
    counted from 0 and held to the table, one ``Compiled.trace``; then the
    served frames/s, latency percentiles and SLO verdicts, and the idle
    share of one served stream.  Returns (launches, launch shapes) summed
    over the checked flush's streams."""
    from repro_torch.core import builders
    from repro_torch.obs.metrics import MetricsRegistry, parse_metrics_text
    from repro_torch.obs.slo import SloConfig
    from repro_torch.obs.trace import ObsConfig, validate_chrome_trace
    from repro_torch.serving import GraphStreamServer
    g = getattr(builders, path.builder)(**path.kwargs)
    B = path.microbatches
    t0 = time.perf_counter()
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="dse", mode="pipelined",
        microbatches=B, obs=ObsConfig(slo=SloConfig(**SERVE_SLO))))
    staged = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=comp.plan))
    print(f"[serve] compile (DSE plan, pipelined B={B}, and staged): "
          f"{time.perf_counter() - t0:.2f} s")
    srv = comp.serve(resident_limit=SERVE_RESIDENT)
    if srv.executor is not comp.executor or srv.slo is None:
        raise AssertionError("[serve] serve() did not reuse the pipelined "
                             "executor or attach the SLO")
    m, c = comp.input_shape()
    frames = [torch.randn((m, c), generator=torch.Generator().manual_seed(
        200 + i)) for i in range(SERVE_FRAMES)]
    inner = srv.executor
    per_stream, shapes = [], collections.Counter()

    def counted(xs):
        torch.cuda.synchronize()
        library.reset_launches()
        ys = inner(xs)
        torch.cuda.synchronize()
        per_stream.append(library.launches())
        shapes.update(library.launch_shapes())
        return ys
    srv.executor = counted
    tickets = [srv.submit(f) for f in frames]
    t0 = time.perf_counter()
    srv.flush()
    flush_s = time.perf_counter() - t0
    srv.executor = inner
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        k: path.ticks * n for k, n in path.launches.items()}
    n_streams = -(-SERVE_FRAMES // B)
    if len(per_stream) != n_streams or any(n != expected
                                           for n in per_stream):
        raise AssertionError(f"[serve] launches per stream {per_stream}, "
                             f"expected {n_streams} x {expected}")
    resident = set(tickets[-SERVE_RESIDENT:])   # the oldest go to host
    for t, f in zip(tickets, frames):
        y = srv.result(t)
        where = "resident" if t in resident else "restored"
        if y.device.type != comp.executor.device.type or not bit_equal(
                torch, y, staged.run(f.cuda())):
            raise AssertionError(f"[serve] ticket {t} ({where}) is not the "
                                 f"staged executor's result")
    fams = parse_metrics_text(comp.metrics_text())

    def total(fam):
        return sum(fams[fam]["samples"].values())
    got = {k: total(f"smof_server_{k}_total") for k in (
        "frames_in", "frames_out", "streams", "padded_frames",
        "evicted_results", "restored_results")}
    n_pad = n_streams * B - SERVE_FRAMES
    n_host = SERVE_FRAMES - SERVE_RESIDENT
    want = dict(frames_in=SERVE_FRAMES, frames_out=SERVE_FRAMES,
                streams=n_streams, padded_frames=n_pad,
                evicted_results=n_host, restored_results=n_host)
    if got != want:
        raise AssertionError(f"[serve] counters {got}, expected {want}")
    verdicts = fams["smof_server_slo_evaluations_total"]["samples"]
    print(f"[serve] {SERVE_FRAMES} frames, one flush: every result bit-equal "
          f"to the staged executor ({len(resident)} resident, {n_host} "
          f"restored from the host); counters {got}; launches per stream "
          f"{ {k: n for k, n in per_stream[0].items() if n} } x "
          f"{n_streams}")
    print(f"[serve] checked flush (launches counted around each stream): "
          f"{flush_s * 1e3:.3f} ms host clock, submit -> flush delivery p50 "
          f"{srv.latency.quantile(0.5) * 1e3:.3f} ms p99 "
          f"{srv.latency.quantile(0.99) * 1e3:.3f} ms; SLO verdicts "
          f"{verdicts}; last report "
          f"{json.dumps(srv.slo.last_report.summary())}")

    # -- one traced stream ---------------------------------------------------
    xs = torch.stack(frames[:B]).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        tpath = pathlib.Path(tmp) / "served.trace.json"
        ys, mc = comp.trace(xs, path=tpath)
        stats = validate_chrome_trace(json.loads(tpath.read_text()))
    want_ys = comp.run(xs)
    if not all(bit_equal(torch, ys[b], want_ys[b]) for b in range(B)):
        raise AssertionError("[serve] traced outputs are not run's")
    S = comp.plan.n_stages
    if (not (mc.ticks_ok and mc.queues_ok)
            or mc.ticks_measured != B + S - 1):
        raise AssertionError(f"[serve] ModelCheck {mc.violations()}")
    print(f"[serve] trace: outputs bit-equal to run; Chrome trace "
          f"{ {k: v for k, v in stats.items() if k != 'tracks'} }; "
          f"ModelCheck ticks {mc.ticks_measured} = B + S - 1, queues ok")

    # -- served rate and latency on a fresh server -----------------------------
    timed = GraphStreamServer(executor=comp.executor,
                              metrics=MetricsRegistry(),
                              resident_limit=SERVE_RESIDENT)
    fps = []
    for _ in range(SERVE_ROUNDS):
        ts = [timed.submit(f) for f in frames]
        t0 = time.perf_counter()
        timed.flush()
        for t in ts:
            timed.result(t)
        torch.cuda.synchronize()
        fps.append(SERVE_FRAMES / (time.perf_counter() - t0))
    print(f"[serve] {SERVE_ROUNDS} timed rounds of {SERVE_FRAMES} frames "
          f"(flush and every claim, to a synchronize): "
          f"{statistics.median(fps):.2f} frames/s median "
          f"({', '.join(f'{f:.2f}' for f in fps)}), submit -> flush "
          f"delivery p50 "
          f"{timed.latency.quantile(0.5) * 1e3:.3f} ms p99 "
          f"{timed.latency.quantile(0.99) * 1e3:.3f} ms (host clock, "
          f"after the stream's results are on the card)")
    one = frames[:B]

    def one_stream():
        ts = [timed.submit(f) for f in one]
        timed.flush()
        for t in ts:
            timed.result(t)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_stream()
        ms.append((time.perf_counter() - t0) * 1e3)
    profile_device(torch, "[serve] profile of one served stream (8 frames "
                   "submitted, flushed, claimed)", one_stream,
                   statistics.median(ms))
    summed = collections.Counter()
    for n in per_stream:
        summed.update(n)
    return dict(summed), dict(shapes)


def fuzz_phase(torch, library):
    """The fuzz path: the port's conformance fuzzer on the card through its
    API, FUZZ_CASES cases of seed FUZZ_SEED with every case on the kernel
    route; zero violations, and ``act_relu_decode`` launched exactly
    FUZZ_ACT_DECODE_LAUNCHES times.  Returns (launches, launch shapes)
    over the phase."""
    from repro_torch.testing import GenConfig
    from repro_torch.testing.fuzz import fuzz
    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        failures = fuzz(GenConfig(p_pallas=FUZZ_P_PALLAS), seed=FUZZ_SEED,
                        budget=FUZZ_CASES, max_shrink_runs=6, out=tmp,
                        torch_device="cuda")
        # a shrunk repro, printed so that it can be replayed elsewhere
        for repro in sorted(pathlib.Path(tmp).glob("*.json")):
            print(f"[fuzz] repro {repro.name}: "
                  f"{json.dumps(json.loads(repro.read_text()))}")
    torch.cuda.synchronize()
    counts, shapes = library.launches(), library.launch_shapes()
    print(f"[fuzz] {FUZZ_CASES} cases in {time.perf_counter() - t0:.2f} s, "
          f"{failures} violation(s); launches "
          f"{ {k: n for k, n in counts.items() if n} }")
    if failures:
        raise AssertionError(f"[fuzz] {failures} violation(s)")
    if counts["act_relu_decode"] != FUZZ_ACT_DECODE_LAUNCHES:
        raise AssertionError(f"[fuzz] act_relu_decode launched "
                             f"{counts['act_relu_decode']} times, expected "
                             f"{FUZZ_ACT_DECODE_LAUNCHES}")
    return counts, shapes


def profile_device(torch, label: str, fn, ms: float) -> None:
    """``fn`` once under ``torch.profiler``: the device-side events'
    busy time against ``ms``, the median unprofiled time of the same work
    (the profiler itself slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device-side events (kernels, copies): a host op's own device
    # time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        print(f"{label}: the profiler saw no device time; device busy and "
              f"idle share not measured")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{label}: device busy {busy:.3f} ms, idle share "
          f"{1 - busy / ms:.3f} of {ms:.3f} ms ({wall:.3f} ms under the "
          f"profiler); by device time: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in top))


def profile_host(torch, label: str, fn, top: int = 8) -> None:
    """``fn`` once under ``cProfile``, synchronised at the end: the host
    functions with the most time of their own (Python and the C calls it
    makes; a call that waits for the card shows its wait here)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"{label}: host {st.total_tt * 1e3:.3f} ms under cProfile; most "
          f"time of their own: " + "; ".join(
              f"{pstats.func_std_string(f)[-60:]} {tt * 1e3:.3f} ms x{nc}"
              for f, (_, nc, tt, _, _) in rows))


def stream_phase(torch, repro_torch, path: StreamPath, main, staged, refc):
    """Phase 5 for a pipelined path: ms per microbatch, pipelined (spills
    evicted, spills resident, reference mode) and staged; peak device
    memory of one stream; the measured stage latencies; one profiled
    stream (DSE plan)."""
    from repro_torch.runtime.streamer import measured_stage_latencies
    plan = main.plan
    resident = dataclasses.replace(
        plan, provenance=dict(plan.provenance),
        streams=[dataclasses.replace(s, evicted=False, codec="none")
                 for s in plan.streams])
    resc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, device="u200", strategy="manual-plan",
        plan=resident, mode="pipelined", microbatches=path.microbatches))
    resc.executor.params = main.executor.params
    B = path.microbatches
    m, c = main.input_shape()
    xs = torch.randn((B, m, c),
                     generator=torch.Generator().manual_seed(99)).cuda()
    per_mb = {}
    for label, comp in (("pipelined, spills evicted", main),
                        ("pipelined, spills resident", resc),
                        ("pipelined, reference mode", refc)):
        ms, peak = frame_stats(torch, comp, xs)
        per_mb[label] = ms / B
        print(f"[{path.name}] {label}: {ms / B:.3f} ms per microbatch "
              f"({ms:.3f} ms per stream of {B}, median of 5, host clock), "
              f"peak device memory of one stream above weights and input "
              f"{peak} bytes")
    ms, peak = frame_stats(torch, staged, xs[0])
    print(f"[{path.name}] staged, spills evicted: {ms:.3f} ms per "
          f"microbatch (median of 5, host clock), peak device memory of one "
          f"frame {peak} bytes")
    lat = measured_stage_latencies(main.executor, xs[0], repeats=5,
                                   warmup=2)
    print(f"[{path.name}] measured stage latencies (CUDA events, median of "
          f"5): {[round(t * 1e3, 4) for t in lat]} ms; Eq. 5 sum "
          f"{sum(lat) * 1e3:.4f} ms, Eq. 6 max {max(lat) * 1e3:.4f} ms")
    if path.plan == "dse":
        profile_device(torch, f"[{path.name}] profile of one evicted stream",
                       lambda: main.run(xs),
                       per_mb["pipelined, spills evicted"] * B)
        for label, comp in (("evicted", main), ("resident", resc)):
            profile_host(torch, f"[{path.name}] host profile of one "
                         f"{label} stream", lambda c=comp: c.run(xs))


def memory_phase(torch, repro_torch, path: Path, main, refc):
    """Phase 5 for one path: frame time and peak memory with the spills
    evicted, with the same plan's spills resident (no encode, no off-chip
    hop, no decode), and in reference mode; then one evicted frame under
    ``torch.profiler`` for the device's busy time and idle share."""
    plan = main.plan
    resident = dataclasses.replace(
        plan, provenance=dict(plan.provenance),
        streams=[dataclasses.replace(s, evicted=False, codec="none")
                 for s in plan.streams])
    resc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, device="u200", strategy="manual-plan",
        plan=resident, mode="staged"))
    resc.executor.params = main.executor.params
    m, c = main.input_shape()
    x = torch.randn((m, c), generator=torch.Generator().manual_seed(99))
    xd = x.cuda()
    frame_ms = {}
    for label, comp in (("kernels, spills evicted", main),
                        ("kernels, spills resident", resc),
                        ("reference mode, spills evicted", refc)):
        frame_ms[label], peak = frame_stats(torch, comp, xd)
        print(f"[{path.name}] frame ({label}): {frame_ms[label]:.3f} ms "
              f"(median of 5, host clock), peak device memory above "
              f"weights and input {peak} bytes")
    # where the evicted frame's time goes on the device
    profile_device(torch, f"[{path.name}] profile of one evicted frame",
                   lambda: main.run(xd), frame_ms["kernels, spills evicted"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import library

    # -- 1. the card -----------------------------------------------------------
    name_limit = card()
    print(name_limit)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kl = library.load_library()
    print(f"build: {kl.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_s:.2f} s)")
    for line in kl.log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # -- 3. the main paths, one after the other -------------------------------
    runs = {p.name: run_path(torch, repro_torch, library, p) for p in PATHS}
    streams = {p.name: run_stream_path(torch, repro_torch, library, p)
               for p in STREAM_PATHS}
    t0 = time.perf_counter()
    served = serve_phase(torch, repro_torch, library, STREAM_PATHS[0])
    t1 = time.perf_counter()
    fuzzed = fuzz_phase(torch, library)
    print(f"served path {t1 - t0:.1f} s, fuzz path "
          f"{time.perf_counter() - t1:.1f} s")
    # launches and launch shapes per frame (staged), per stream
    # (pipelined), per flush (served) or over the phase (fuzz)
    counts = {n: r[-2] for n, r in (runs | streams).items()}
    shapes = {n: r[-1] for n, r in (runs | streams).items()}
    for name, (c, sh) in (("yolo-served", served), ("fuzz", fuzzed)):
        counts[name], shapes[name] = c, sh

    # -- 4. kernels against their plain versions --------------------------------
    timer = Timer(torch)
    rows = kernel_phase(torch, timer, shapes)
    for name, row in rows.items():
        row["launches"] = sum(c[name] for c in counts.values())
        if row["launches"] == 0:
            raise AssertionError(f"kernel {name} never launched on a path")
    for r in rows.values():
        name = r["name"]
        if name in ("streamed_matmul", "conv2d"):
            tol = MATMUL_TOL
        elif name.startswith("conv2d"):
            tol = (f"bit-exact vs the conv2d kernel on the decode kernel's "
                   f"output and the codec, {MATMUL_TOL} vs plain")
        elif name.startswith("pool"):
            tol = (f"bit-exact vs the pool kernel on the decode kernel's "
                   f"output and the codec; vs plain bit-exact at k=2, "
                   f"{POOL_TOL} x mean|x| above")
        else:
            tol = "bit-exact"
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name:22s} launches {r['launches']:3d} "
              f"max_abs_err {r['max_abs_err']:.3e} (tol {tol}) "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib} "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"by path {json.dumps(r['by_path'])}")
    for pname in counts:
        kern_sum = sum(r["by_path"].get(pname, {}).get("ms", 0.0)
                       for r in rows.values())
        print(f"[{pname}] sum of the path's kernel times (L2 flushed): "
              f"{kern_sum:.3f} ms")

    # -- 5. time and memory per frame or microbatch ----------------------------
    for p in PATHS:
        main_c, refc, _, _ = runs[p.name]
        memory_phase(torch, repro_torch, p, main_c, refc)
    for p in STREAM_PATHS:
        main_c, staged, refc, _, _ = streams[p.name]
        stream_phase(torch, repro_torch, p, main_c, staged, refc)
    print(f"phases 2-5: {time.perf_counter() - t_start:.1f} s")

    # -- 6. results -------------------------------------------------------------
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
