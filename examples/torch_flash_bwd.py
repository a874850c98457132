"""Flash attention's backward kernels on the card: build, check, time.

    PYTHONPATH=src python examples/torch_flash_bwd.py
    PYTHONPATH=src python examples/torch_flash_bwd.py --no-check --train-steps 4

Builds the kernel library, prints ptxas's registers and spills for
``csrc/flash_attention_bwd.cu`` and each backward instance's shared memory,
registers and resident blocks an SM, holds ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkdv`` to their plain versions (within 2e-4 x max(1,
max|plain|), a second launch bit for bit the first) at ragged shapes and at
the tiles' edges, causal and not, and then times, at yi-6b's train shape
(B, S, H, D) = (1, 1024, 32, 128), causal, the training forward
(``flash_attention_lse``), each backward kernel, and SDPA's f32 forward
and autograd backward as yardsticks, beside the f32 bound and the 3xTF32
split's bound.  Times are medians of 20 launches, each after a 64 MB L2 flush and a 1 ms spin, as ``chip_smoke.py``
phase 4 takes them.  With ``--train-steps N`` it then trains yi-6b at its
published widths as ``chip_smoke.py``'s ``lm-train`` path does (int8 AdamW
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


def check(FA, gen, B, S, H, D, causal) -> float:
    """Worst error of the two kernels as a fraction of its bound."""
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    got = FA.flash_attention_backward(q, k, v, o, lse, do, causal)
    want = FA.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    again = FA.flash_attention_backward(q, k, v, o, lse, do, causal)
    worst = 0.0
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        lim = TOL * max(1.0, float(w.abs().max()))
        err = float((g.double() - w.double()).abs().max())
        worst = max(worst, err / lim)
        if err > lim:
            raise AssertionError(f"{name} at {(B, S, H, D)} causal "
                                 f"{causal}: {err} > {lim}")
        if not torch.equal(g.view(torch.int32), a.view(torch.int32)):
            raise AssertionError(f"{name} at {(B, S, H, D)}: a second "
                                 f"launch differs")
    return worst


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--train-steps", type=int, default=0)
    args = ap.parse_args(argv)
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
        if source == "flash_attention_bwd.cu" and (
                "registers" in line or "spill" in line):
            print(f"  ptxas {line.strip()} [{kernel}]")
    for D in FA.HEAD_DIMS if hasattr(FA, "backward_occupancy") else ():
        for name, (nbytes, regs, blocks) in FA.backward_occupancy(D).items():
            print(f"  {name} D={D}: {nbytes} bytes of shared memory, {regs} "
                  f"registers, {blocks} block(s) an SM")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.no_check:
        worst = max(check(FA, gen, *shape, causal)
                    for shape in CHECK_SHAPES for causal in (True, False))
        print(f"checked {2 * len(CHECK_SHAPES)} cases: worst error "
              f"{worst:.3f} of the bound, every second launch bit for bit")

    B, S, H, D = SHAPE
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = FA.flash_attention_lse(q, k, v, causal=True)
    delta = FA.flash_attention_bwd_dq(q, k, v, o, do, lse, True)[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    fwd = 2.0 * B * H * D * S * (S + 1)     # the causal forward's operations
    n = B * S * H * D
    io = 4.0 * (6 * n + 2 * B * H * S)
    rows = (
        ("flash_attention_lse", lambda: FA.flash_attention_lse(
            q, k, v, causal=True), 4.0 * (4 * n + B * H * S), fwd),
        ("flash_attention_bwd_dq", lambda: FA.flash_attention_bwd_dq(
            q, k, v, o, do, lse, True), io, 1.5 * fwd),
        ("flash_attention_bwd_dkdv", lambda: FA.flash_attention_bwd_dkdv(
            q, k, v, do, lse, delta, True), io, 2.0 * fwd),
        ("sdpa forward (f32)", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 4.0 * 4 * n, fwd),
        ("sdpa backward (f32, autograd)", lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), io, 3.5 * fwd),
    )
    print(f"causal at (B, S, H, D) = {SHAPE}, median of {REPS}:")
    for name, fn, nbytes, ops in rows:
        ms = median_ms(fn, flush)
        f32 = max(nbytes / PEAK_HBM_BYTES_S, ops / PEAK_F32_FLOPS) * 1e3
        x3 = max(nbytes / PEAK_HBM_BYTES_S, 3 * ops / PEAK_TF32_FLOPS) * 1e3
        print(f"  {name}: {ms:.4f} ms; f32 bound {f32:.4f}, 3xTF32 bound "
              f"{x3:.4f} ({x3 / ms:.3f} of it)")
    if args.train_steps:
        del q, k, v, do, o, lse, delta, qt, kt, vt, ot, dot, flush
        train(args.train_steps)
    return 0


def train(steps: int) -> None:
    """yi-6b's train step on the kernel route, as chip_smoke's lm-train."""
    import time
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.steps import make_train_step
    cfg = ARCHS["yi-6b"]
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                     global_batch=1)).batch_at(0)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=steps, quantize_states=True)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat="full", device="cuda")
    walls, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(round(float(m["loss"]), 6))     # synchronises
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls[1:]) * 1e3
    print(f"yi-6b train, 1 x 1024 tokens: losses {losses}; ms a step "
          f"{[round(w * 1e3, 3) for w in walls]}, median of steps 2-{steps} "
          f"{ms:.3f} ms, {1024 / ms * 1e3:.1f} tokens/s")


if __name__ == "__main__":
    sys.exit(main())
