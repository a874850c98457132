"""Flash attention's backward kernels on the card: build, check, time.

    PYTHONPATH=src python examples/torch_flash_bwd.py
    PYTHONPATH=src python examples/torch_flash_bwd.py --no-check --train-steps 4
    PYTHONPATH=src python examples/torch_flash_bwd.py --dtype bfloat16

Builds the kernel library, prints ptxas's registers and spills for
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_bf16.cu``
and each backward instance's shared memory, registers and resident blocks
an SM, holds ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkdv``
in ``--dtype`` (float32 or bfloat16) to their plain versions (f32: within
2e-4 x max(1, max|plain|); bf16: every element within one bf16 ulp of the
plain value plus twice its f32 slack, ``testing.ulp``; a second launch bit
for bit the first) at ragged shapes and at the tiles' edges, causal and
not, and then times, at yi-6b's train shape (B, S, H, D) = (1, 1024, 32,
128), causal, the training forward (``flash_attention_lse``), each
backward kernel, and SDPA's forward and autograd backward in the same type
as yardsticks, beside the bound (f32: at 67 TFLOP/s, and the 3xTF32
split's; bf16: at the bf16 tensor cores' 989 TFLOP/s, and the bf16
backward pair's own products, 4 in dq and 6 in dkdv); in bf16 the f32
instances of the three kernels are timed too, on the same values widened.
Times are medians of 20 launches, each after a 64 MB L2 flush and a 1 ms
spin, as ``chip_smoke.py`` phase 4 takes them.  With ``--train-steps N``
it then trains yi-6b at its published widths in ``--dtype`` as
``chip_smoke.py``'s ``lm-train`` (``lm-train-bf16``) path does (int8 AdamW
states, remat "full", 1 x 1024 tokens of ``TokenPipeline.batch_at(0)``,
repeated) for N steps and prints each step's host-clock time to the loss
and the median of steps 2-N.  Run it once per tree (``PYTHONPATH``) in one
call, in turns, to compare two versions of the kernels.  Exits 2 without
a card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_HBM_BYTES_S = 67e12, 495e12, 3.35e12
PEAK_BF16_FLOPS = 989e12
# the bf16 backward pair's own products against the counted 3 (dq) and 4
# (dkdv): s, dP and dQ or dV, dK once a piece of P or dS, two pieces
BF16_PRODUCTS = {"flash_attention_bwd_dq": 4 / 3,
                 "flash_attention_bwd_dkdv": 6 / 4}
TOL = 2e-4
SHAPE = (1, 1024, 32, 128)  # yi-6b's train shape (B, S, H, D)
REPS = 20
SPIN_CYCLES = 2_000_000    # about 1 ms at the H100's boost clock
# ragged S and S one below and above a backward block (64 rows) and tile
# (32 rows) and their doubles
CHECK_SHAPES = ([(2, S, 3, D) for D in (16, 128)
                 for S in (1, 31, 33, 63, 65, 127, 129, 300)]
                + [(1, 77, 4, 32), (1, 200, 2, 64)])


def median_ms(fn, flush) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(FA, gen, B, S, H, D, causal, dtype) -> float:
    """Worst error of the two kernels as a fraction of its bound."""
    from repro_torch.testing.ulp import bf16_ulp, f32_slack
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    got = FA.flash_attention_backward(q, k, v, o, lse, do, causal)
    want = FA.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    again = FA.flash_attention_backward(q, k, v, o, lse, do, causal)
    slack = (f32_slack(q, k, v, causal, do) if dtype == torch.bfloat16
             else None)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    worst = 0.0
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        err = (g.double() - w.double()).abs()
        if slack is None:
            lim = TOL * max(1.0, float(w.abs().max()))
        else:
            lim = bf16_ulp(w) + 2 * slack[name]
        ratio = float((err / lim).max())
        worst = max(worst, ratio)
        if ratio > 1.0:
            raise AssertionError(f"{name} at {(B, S, H, D)} causal "
                                 f"{causal}: {ratio} of the bound")
        if not torch.equal(g.view(bits), a.view(bits)):
            raise AssertionError(f"{name} at {(B, S, H, D)}: a second "
                                 f"launch differs")
    return worst


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("torch_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.library import load_library
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    kl = load_library()
    print(f"torch {torch.__version__}, library {kl.path.name}, nvcc "
          f"{kl.build_s:.1f} s")
    source = kernel = ""
    for line in kl.log.splitlines():
        if line.startswith("=="):
            source = line[2:].strip()
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        if source in ("flash_attention_bwd.cu",
                      "flash_attention_bwd_bf16.cu") and (
                "registers" in line or "spill" in line):
            print(f"  ptxas {line.strip()} [{kernel}]")
    for D in FA.HEAD_DIMS if hasattr(FA, "backward_occupancy") else ():
        for name, (nbytes, regs, blocks) in FA.backward_occupancy(D).items():
            print(f"  {name} D={D}: {nbytes} bytes of shared memory, {regs} "
                  f"registers, {blocks} block(s) an SM")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.no_check:
        worst = max(check(FA, gen, *shape, causal, dtype)
                    for shape in CHECK_SHAPES for causal in (True, False))
        print(f"checked {2 * len(CHECK_SHAPES)} cases: worst error "
              f"{worst:.3f} of the bound, every second launch bit for bit")

    B, S, H, D = SHAPE
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    fwd = 2.0 * B * H * D * S * (S + 1)     # the causal forward's operations
    n = B * S * H * D
    rows = []
    # the kernels in --dtype, and in bf16 their f32 instances on the same
    # values widened
    for dt in (dtype,) + ((torch.float32,) if dtype != torch.float32
                          else ()):
        qd, kd, vd, dd = (t.to(dt) for t in (q, k, v, do))
        o, lse = FA.flash_attention_lse(qd, kd, vd, causal=True)
        delta = FA.flash_attention_bwd_dq(qd, kd, vd, o, dd, lse, True)[1]
        es = qd.element_size()
        io = es * 6 * n + 8.0 * B * H * S
        tag = f" ({str(dt).removeprefix('torch.')})"
        rows += [
            ("flash_attention_lse" + tag, dt,
             lambda qd=qd, kd=kd, vd=vd: FA.flash_attention_lse(
                 qd, kd, vd, causal=True),
             es * 4 * n + 4.0 * B * H * S, fwd, None),
            ("flash_attention_bwd_dq" + tag, dt,
             lambda qd=qd, kd=kd, vd=vd, o=o, dd=dd, lse=lse:
             FA.flash_attention_bwd_dq(qd, kd, vd, o, dd, lse, True),
             io, 1.5 * fwd, "flash_attention_bwd_dq"),
            ("flash_attention_bwd_dkdv" + tag, dt,
             lambda qd=qd, kd=kd, vd=vd, dd=dd, lse=lse, delta=delta:
             FA.flash_attention_bwd_dkdv(qd, kd, vd, dd, lse, delta, True),
             io, 2.0 * fwd, "flash_attention_bwd_dkdv")]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    es = q.element_size()
    rows += [
        (f"sdpa forward ({args.dtype})", dtype,
         lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
         es * 4 * n, fwd, None),
        (f"sdpa backward ({args.dtype}, autograd)", dtype,
         lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                     retain_graph=True),
         es * 6 * n + 8.0 * B * H * S, 3.5 * fwd, None)]
    print(f"causal at (B, S, H, D) = {SHAPE}, median of {REPS}:")
    for name, dt, fn, nbytes, ops, own in rows:
        ms = median_ms(fn, flush)
        t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
        if dt == torch.float32:
            f32 = max(t_bytes, ops / PEAK_F32_FLOPS * 1e3)
            x3 = max(t_bytes, 3 * ops / PEAK_TF32_FLOPS * 1e3)
            print(f"  {name}: {ms:.4f} ms; f32 bound {f32:.4f}, 3xTF32 "
                  f"bound {x3:.4f} ({x3 / ms:.3f} of it)")
            continue
        b16 = max(t_bytes, ops / PEAK_BF16_FLOPS * 1e3)
        line = f"  {name}: {ms:.4f} ms; bf16 bound {b16:.4f}"
        if own is not None:
            pb = max(t_bytes, ops * BF16_PRODUCTS[own] / PEAK_BF16_FLOPS
                     * 1e3)
            line += f", own products bound {pb:.4f} ({pb / ms:.3f} of it)"
        print(line)
    if args.train_steps:
        del q, k, v, do, rows, qt, kt, vt, ot, dot, flush
        train(args.train_steps, dtype)
    return 0


def train(steps: int, dtype: torch.dtype) -> None:
    """yi-6b's train step on the kernel route in ``dtype``, as
    chip_smoke's lm-train (f32) or lm-train-bf16."""
    import time
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.steps import make_train_step
    cfg = ARCHS["yi-6b"]
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         dtype=dtype)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                     global_batch=1)).batch_at(0)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=steps, quantize_states=True)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat="full", device="cuda",
                           dtype=dtype)
    walls, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(round(float(m["loss"]), 6))     # synchronises
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls[1:]) * 1e3
    print(f"yi-6b train in {dtype}, 1 x 1024 tokens: losses {losses}; ms "
          f"a step "
          f"{[round(w * 1e3, 3) for w in walls]}, median of steps 2-{steps} "
          f"{ms:.3f} ms, {1024 / ms * 1e3:.1f} tokens/s")


if __name__ == "__main__":
    sys.exit(main())
