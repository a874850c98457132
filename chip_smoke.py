#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card: name and power limit from ``nvidia-smi``; no CUDA device is a
   failure;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. the main path, one model after the other, each through
   ``repro_torch.compile`` (DSE on the u200 sheet, staged executor): the
   paper-width UNet (widths 64-1024, 368x480 input), then X3D-M at its
   published stage widths (24-192, 16 frames of 128x128).  A few seeded
   frames each, with the kernel launches counted from 0 around every frame
   and held against the path's own table, and the output held against the
   same plan in ``kernel_mode="reference"`` on the card;
4. hold each kernel against its plain PyTorch version on the card, at every
   shape either path launched it with in phase 3 plus ragged shapes and
   the edge cases (the BFP8 exponent's, 'same'-padding rows and +-0.0 for
   dwconv), and time kernel, plain version and one PyTorch call as a
   yardstick (CUDA events, L2 flushed before every launch);
5. each path's frame time and peak device memory, with its spills evicted
   as planned and with the same plan's spills kept on the device, and the
   device's busy time and idle share in one profiled frame;
6. one JSON line of per-kernel numbers, then the result line.

Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
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
    Path("x3d", "build_x3d_exec",
         dict(positions=16 * 128 * 128, cin=3, widths=(24, 48, 96, 192),
              expansion=2, depth=2),
         {"conv2d": 9, "dwconv": 9, "bfp8_quant": 4, "pool_encode": 1,
          "pool": 9, "act_relu": 12, "act_relu_encode": 1,
          "bfp8_dequant": 6, "streamed_matmul": 5}, 6),
)

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
    their counts per frame; a kernel's times and bounds are summed over one
    frame of each path (and kept per path under ``by_path``).  Returns
    per-kernel rows."""
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
        """The global pool: within POOL_TOL * mean |x| of each channel."""
        m, c = x.shape
        want = ref.pool_ref(x, m_out)
        err = (got.double() - want.double()).abs()
        note_err(name, err)
        lim = POOL_TOL * x.abs().double().reshape(m_out, m // m_out,
                                                  c).mean(1)
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: global pool outside "
                                 f"{POOL_TOL} x mean|x|")

    def enc_plain(op, x):
        y = op(x)
        yq = F.pad(y, (0, (-y.shape[1]) % 32))
        return y, bfp8_quant_values(yq, block=32)

    def check_encode(name, kern, op, x, nan_bits=True):
        y, (man, exp) = kern(x)
        py, (pman, pexp) = enc_plain(op, x)
        exact(name, y, py, nan_bits)
        exact(name, man, pman)
        exact(name, exp, pexp)

    def relu_encode(x):
        return SC.act_relu(x, encode=True)

    def check_pool(x, m_out):
        if x.shape[0] // m_out == 2:
            exact("pool", SC.pool(x, m_out), ref.pool_ref(x, m_out))
        else:
            pool_close("pool", SC.pool(x, m_out), x, m_out)

    def check_dwconv(x, w):
        exact("dwconv", SC.dwconv(x, w), ref.dwconv_ref(x, w))

    def case(kind, arg_shapes):
        """Inputs at one launch's shapes: (check, kernel, plain, yardstick
        or None, bytes moved, operations)."""
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
        if kind == "act_relu_encode":
            (m, c), _, (_, cq), (_, nb) = arg_shapes
            x = randn(m, c)
            return ((lambda: check_encode(kind, relu_encode,
                                          ref.act_relu_ref, x)),
                    lambda: relu_encode(x),
                    lambda: enc_plain(ref.act_relu_ref, x), None,
                    8.0 * m * c + m * cq + m * nb, 6.0 * m * cq)
        if kind == "pool":
            (m, c), (m_out, _), _ = arg_shapes
            x = randn(m, c)
            kern = lambda: SC.pool(x, m_out)                   # noqa: E731
            plain = lambda: ref.pool_ref(x, m_out)             # noqa: E731
            return ((lambda: check_pool(x, m_out)), kern, plain,
                    lambda: x.view(m_out, m // m_out, c).mean(1),
                    4.0 * (m * c + m_out * c), m * c)
        if kind == "pool_encode":
            (m, c), (m_out, _), (_, cq), (_, nb) = arg_shapes
            x = randn(m, c)

            def op(h):
                return ref.pool_ref(h, m_out)

            def kern(h=x):
                return SC.pool(h, m_out, encode=True)
            return ((lambda: check_encode(kind, kern, op, x)),
                    kern, lambda: enc_plain(op, x), None,
                    4.0 * (m * c + m_out * c) + m_out * (cq + nb),
                    m * c + 6.0 * m_out * cq)
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

    # -- at the paths' shapes: correctness, then times per frame ---------------
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
              f"{b:.4f} ({bound_by}), per frame x{union[key]}")
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
            row["bound_by"] = bound_by
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
    for m, c in ((77, 45), (3, 1), (129, 96)):
        x = randn(m, c)
        exact("act_relu", SC.act_relu(x), ref.act_relu_ref(x))
        check_encode("act_relu_encode", relu_encode, ref.act_relu_ref, x)
        check_encode("pool_encode", lambda h: SC.pool(h, m, encode=True),
                     lambda h: ref.pool_ref(h, m), randn(2 * m, c))
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
    check_encode("act_relu_encode", relu_encode, ref.act_relu_ref, x)
    man, exp = bfp8_quant(x)
    pman, pexp = bfp8_quant_values(x, block=32)
    exact("bfp8_quant", man, pman)
    exact("bfp8_quant", exp, pexp)
    check_encode("pool_encode", lambda h: SC.pool(h, x.shape[0], encode=True),
                 lambda h: ref.pool_ref(h, x.shape[0]),
                 x.repeat_interleave(2, dim=0), nan_bits=False)
    for m, c, m_out in ((4096, 96, 1), (3 * 70001, 40, 3)):
        g = randn(m, c)
        pool_close("pool", SC.pool(g, m_out), g, m_out)
    man, exp = randi8(-128, 127, 300, 96), randi8(-128, 127, 300, 3)
    exact("bfp8_dequant", bfp8_dequant(man, exp),
          ref.bfp8_dequant_ref(man, exp))
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


def run_path(torch, repro_torch, library, path: Path):
    """Phase 3 for one path: compile, then FRAMES seeded frames, each with
    its launches counted from 0 and its output held against reference
    mode.  Returns (compiled, reference-mode compiled, launches per frame,
    launch shapes per frame)."""
    from repro_torch.core import builders
    g = getattr(builders, path.builder)(**path.kwargs)
    t0 = time.perf_counter()
    main = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="dse", mode="staged"))
    print(f"[{path.name}] compile (DSE + lowering): "
          f"{time.perf_counter() - t0:.2f} s")
    rep = main.report()
    bfp8 = [s for s in main.executor.report.spills
            if s.codec == "bfp8" and s.reason == "evicted"]
    print(f"[{path.name}] spill report: {json.dumps(rep['traffic'])}")
    print(f"[{path.name}] bfp8-evicted edges: "
          f"{[(s.src, s.dst) for s in bfp8]}, "
          f"{sum(s.offchip_bits for s in bfp8) // 8} bytes each way")
    if len(bfp8) != path.bfp8_edges:
        raise AssertionError(f"[{path.name}] expected {path.bfp8_edges} "
                             f"BFP8-evicted edges, got {len(bfp8)}")
    refc = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=main.plan,
        mode="staged", kernel_mode="reference"))
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
            raise AssertionError(f"[{path.name}] frame {f}: main path leaves "
                                 f"reference")
    print(f"[{path.name}] launches per frame: "
          f"{ {k: n for k, n in counts.items() if n} }")
    for (name, arg_shapes), n in sorted(shapes.items()):
        print(f"  {name} {arg_shapes} x{n}")
    return main, refc, counts, shapes


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
    # where the evicted frame's time goes on the device: torch.profiler's
    # device time (kernels and copies, one stream) against the median
    # frame above (the profiler itself slows the host)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main.run(xd)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device-side events (kernels, copies): a host op's own device
    # time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        print(f"[{path.name}] profile: the profiler saw no device time; "
              f"device busy and idle share not measured")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    ms = frame_ms["kernels, spills evicted"]
    print(f"[{path.name}] profile of one evicted frame: device busy "
          f"{busy:.3f} ms, idle share {1 - busy / ms:.3f} of the "
          f"{ms:.3f} ms frame ({wall:.3f} ms under the profiler); by "
          f"device time: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in top))


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

    # -- 3. the main path, one model after the other --------------------------
    runs = {p.name: run_path(torch, repro_torch, library, p) for p in PATHS}

    # -- 4. kernels against their plain versions --------------------------------
    timer = Timer(torch)
    rows = kernel_phase(torch, timer,
                        {name: r[3] for name, r in runs.items()})
    for name, row in rows.items():
        row["launches"] = sum(r[2][name] for r in runs.values())
        if row["launches"] == 0:
            raise AssertionError(f"kernel {name} never launched on a path")
    for r in rows.values():
        tol = {"streamed_matmul": MATMUL_TOL, "conv2d": MATMUL_TOL,
                     "pool": f"bit-exact at k=2, {POOL_TOL} x mean|x| "
                             f"above"}.get(r["name"], "bit-exact")
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']:16s} launches/frame {r['launches']:2d} "
              f"max_abs_err {r['max_abs_err']:.3e} (tol {tol}) "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib} "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"by path {json.dumps(r['by_path'])}")
    for pname in runs:
        kern_sum = sum(r["by_path"].get(pname, {}).get("ms", 0.0)
                       for r in rows.values())
        print(f"[{pname}] sum of the path's kernel times (L2 flushed): "
              f"{kern_sum:.3f} ms")

    # -- 5. time and memory per frame -------------------------------------------
    for p in PATHS:
        main_c, refc, _, _ = runs[p.name]
        memory_phase(torch, repro_torch, p, main_c, refc)
    print(f"phases 2-5: {time.perf_counter() - t_start:.1f} s")

    # -- 6. results -------------------------------------------------------------
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
