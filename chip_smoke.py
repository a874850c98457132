#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card: name and power limit from ``nvidia-smi``; no CUDA device is a
   failure;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. the main path: the paper-width UNet (widths 64-1024, 368x480 input)
   through ``repro_torch.compile`` (DSE on the u200 sheet, staged executor)
   — a few seeded frames, each with its kernel launches counted and held
   against the same plan in ``kernel_mode="reference"`` on the card;
4. hold each kernel against its plain PyTorch version on the card, at every
   shape the main path launched it with in phase 3 plus ragged shapes and
   the BFP8 exponent's edge cases, and time kernel, plain version and one
   PyTorch call as a yardstick (CUDA events, L2 flushed before every
   launch);
5. the frame's time and peak device memory, with the skips evicted as
   planned and with the same plan's skips kept on the device;
6. one JSON line of per-kernel numbers, then the result line.

Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

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

PAPER_UNET = dict(positions=368 * 480, base=64, levels=5)
FRAMES = 3
REPS = 20
# kernel vs plain: f32 sums in another order (streamed_matmul, global pool)
MATMUL_TOL = 2e-4          # rtol = atol, as the port's CPU parity tests
# main path vs reference mode: a one-ulp difference before a BFP8 encode
# may move a mantissa by one step of its block's scale
FRAME_TOL = 2e-2           # of max |reference output|
# launches per frame of the paper-width UNet's staged plan on u200: the 8
# weight layers with K > 128, 9 relus (4 encode a skip), 4 pools, 4 skip
# decodes at the concats
EXPECTED = {"streamed_matmul": 8, "act_relu": 5, "act_relu_encode": 4,
            "pool": 4, "bfp8_dequant": 4}

TPU_SRC = {
    "streamed_matmul": "src/repro/kernels/streamed_matmul.py:31",
    "act_relu": "src/repro/kernels/streaming_conv.py:409",
    "act_relu_encode": "src/repro/kernels/streaming_conv.py:418",
    "pool": "src/repro/kernels/streaming_conv.py:320",
    "bfp8_dequant": "src/repro/kernels/bfp8.py:55",
}
CUDA_SRC = {
    "streamed_matmul": "src/repro_torch/csrc/streamed_matmul.cu",
    "act_relu": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "pool": "src/repro_torch/csrc/streaming_conv.cu",
    "bfp8_dequant": "src/repro_torch/csrc/bfp8.cu",
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Mean device time of a call, L2 flushed before each launch."""

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


def kernel_phase(torch, timer, shapes):
    """Hold every kernel against its plain version at each ``(name, tensor
    shapes)`` the main path launched, and time kernel, plain version and
    yardstick; ``shapes`` maps each to its launches per frame, and the times
    and bounds are summed over one frame.  Returns per-kernel rows."""
    from repro_torch.kernels import ref, streaming_conv as SC
    from repro_torch.kernels.bfp8 import bfp8_dequant, bfp8_quant_values
    from repro_torch.kernels.library import reset_launches
    from repro_torch.kernels.streamed_matmul import (streamed_matmul,
                                                     streamed_matmul_padded)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def randi8(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    rows = {n: dict(name=n, route="cuda", source=CUDA_SRC[n],
                    replaces=TPU_SRC[n], launches=0, max_abs_err=0.0, ms=0.0,
                    plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
                    library_ms=0.0)
            for n in TPU_SRC}

    def close(name, got, want, rtol, atol):
        err = (got.double() - want.double()).abs()
        lim = atol + rtol * want.double().abs()
        bad = int((err > lim).sum())
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        float(err.max()) if err.numel()
                                        else 0.0)
        if bad:
            raise AssertionError(f"{name}: {bad} values outside "
                                 f"atol={atol} rtol={rtol}")

    def exact(name, got, want):
        """Bit for bit, NaN and the sign of zero included."""
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-exact")

    def enc_plain(x):
        y = ref.act_relu_ref(x)
        c = y.shape[1]
        yq = torch.nn.functional.pad(y, (0, (-c) % 32))
        return y, bfp8_quant_values(yq, block=32)

    def check_encode(x):
        y, (man, exp) = SC.act_relu(x, encode=True)
        py, (pman, pexp) = enc_plain(x)
        exact("act_relu_encode", y, py)
        exact("act_relu_encode", man, pman)
        exact("act_relu_encode", exp, pexp)

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
            return ((lambda: check_encode(x)),
                    lambda: SC.act_relu(x, encode=True),
                    lambda: enc_plain(x), None,
                    8.0 * m * c + m * cq + m * nb, 6.0 * m * cq)
        if kind == "pool":
            (m, c), (m_out, _) = arg_shapes
            x = randn(m, c)
            kern = lambda: SC.pool(x, m_out)                   # noqa: E731
            plain = lambda: ref.pool_ref(x, m_out)             # noqa: E731
            return ((lambda: exact(kind, kern(), plain())), kern, plain,
                    lambda: x.view(m_out, m // m_out, c).mean(1),
                    4.0 * (m * c + m_out * c), m * c)
        (r, c), (_, nb), _ = arg_shapes                        # bfp8_dequant
        man, exp = randi8(-127, 127, r, c), randi8(-30, 20, r, nb)
        kern = lambda: bfp8_dequant(man, exp)                  # noqa: E731
        plain = lambda: ref.bfp8_dequant_ref(man, exp)         # noqa: E731
        return ((lambda: exact(kind, kern(), plain())), kern, plain, None,
                5.0 * r * c + r * nb, r * c)

    # -- at the path's shapes: correctness, then times per frame ---------------
    for (kind, arg_shapes), n in sorted(shapes.items()):
        check, kern, plain, lib, nbytes, ops = case(kind, arg_shapes)
        check()
        row = rows[kind]
        row["ms"] += n * timer(kern)
        row["plain_ms"] += n * timer(plain)
        row["library_ms"] = None if lib is None else (
            row["library_ms"] + n * timer(lib))
        b, row["bound_by"] = bound_ms(nbytes, ops)
        row["bound_ms"] += n * b

    # -- ragged shapes and edge cases ----------------------------------------
    for m, k, n, f in ((1000, 300, 200, 0.0), (77, 1536, 130, 0.5)):
        x, w = randn(m, k), randn(k, n) / math.sqrt(k)
        close("streamed_matmul", streamed_matmul_padded(x, w,
                                                        static_fraction=f),
              ref.conv2d_ref(x, w), MATMUL_TOL, MATMUL_TOL)
    for m, c in ((77, 45), (3, 1), (129, 96)):
        x = randn(m, c)
        exact("act_relu", SC.act_relu(x), ref.act_relu_ref(x))
        check_encode(x)
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -1.0],
                            device="cuda")
    exact("act_relu", SC.act_relu(specials[None, :]),
          ref.act_relu_ref(specials[None, :]))
    # BFP8 exponent edge cases: block amax at 2^k (1 + j 2^-23), j in
    # -3..3, across the normal range and into the subnormals, plus all-zero
    # blocks (exp 0), blocks whose values round half-way, and blocks that
    # hold a NaN or an infinity (exp 0, a NaN's mantissa 0)
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
    check_encode(x)
    g = randn(4096, 96)
    close("pool", SC.pool(g, 1), ref.pool_ref(g, 1), 1e-5, 1e-6)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core import build_unet_exec
    from repro_torch.kernels import library

    # -- 1. the card -----------------------------------------------------------
    name_limit = card()
    print(name_limit)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kl = library.load_library()
    print(f"build: {kl.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_s:.2f} s)")
    for line in kl.log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # -- 3. the main path -------------------------------------------------------
    g = build_unet_exec(**PAPER_UNET)
    t0 = time.perf_counter()
    main = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="dse", mode="staged"))
    print(f"compile (DSE + lowering): {time.perf_counter() - t0:.2f} s")
    rep = main.report()
    bfp8 = [s for s in main.executor.report.spills
            if s.codec == "bfp8" and s.reason == "evicted"]
    print(f"spill report: {json.dumps(rep['traffic'])}")
    print(f"bfp8-evicted edges: {[(s.src, s.dst) for s in bfp8]}")
    if len(bfp8) != 4:
        raise AssertionError(f"expected 4 BFP8-evicted skips, got {len(bfp8)}")
    refc = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=main.plan,
        mode="staged", kernel_mode="reference"))
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
            raise AssertionError(f"frame {f}: launch shapes changed")
        if counts != EXPECTED:
            raise AssertionError(f"frame {f}: launches {counts}, expected "
                                 f"{EXPECTED}")
        yr = refc.run(xd)
        torch.cuda.synchronize()
        if y.shape != yr.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"frame {f}: bad output {tuple(y.shape)}")
        err = float((y - yr).abs().max())
        scale = float(yr.abs().max())
        print(f"frame {f}: output {tuple(y.shape)} max|y - ref| {err:.3e} "
              f"(tol {FRAME_TOL} x max|ref| = {FRAME_TOL * scale:.3e})")
        if err > FRAME_TOL * scale:
            raise AssertionError(f"frame {f}: main path leaves reference")
    total_act = counts["act_relu"] + counts["act_relu_encode"]
    print(f"launches per frame: streamed_matmul {counts['streamed_matmul']}, "
          f"act_relu {total_act} ({counts['act_relu_encode']} with encode), "
          f"pool {counts['pool']}, bfp8_dequant {counts['bfp8_dequant']}")
    for (name, arg_shapes), n in sorted(shapes.items()):
        print(f"  {name} {arg_shapes} x{n}")

    # -- 4. kernels against their plain versions --------------------------------
    timer = Timer(torch)
    rows = kernel_phase(torch, timer, shapes)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the path")
        rows[name]["launches"] = n
    for r in rows.values():
        print(f"kernel {r['name']:16s} launches/frame {r['launches']:2d} "
              f"max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {'bit-exact' if r['name'] != 'streamed_matmul' else MATMUL_TOL}"
              f"{', global pool rtol 1e-5' if r['name'] == 'pool' else ''}) "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    kern_sum = sum(r["ms"] for r in rows.values())
    print(f"sum of the path's kernel times (L2 flushed): {kern_sum:.3f} ms")

    # -- 5. time and memory per frame -------------------------------------------
    # the same plan with every skip kept on the device: no encode, no
    # off-chip hop, no decode
    plan = main.plan
    resident = dataclasses.replace(
        plan, provenance=dict(plan.provenance),
        streams=[dataclasses.replace(s, evicted=False, codec="none")
                 for s in plan.streams])
    resc = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=resident,
        mode="staged"))
    x = torch.randn((m, c), generator=torch.Generator().manual_seed(99))
    xd = x.cuda()
    for label, comp in (("kernels, skips evicted", main),
                        ("kernels, skips resident", resc),
                        ("reference mode, skips evicted", refc)):
        ms, peak = frame_stats(torch, comp, xd)
        print(f"frame ({label}): {ms:.3f} ms (median of 5, host clock), "
              f"peak device memory above weights and input {peak} bytes")

    # -- 6. results -------------------------------------------------------------
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
