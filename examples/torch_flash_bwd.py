"""Flash attention's backward kernels on the card: build, check, time.

    PYTHONPATH=src python examples/torch_flash_bwd.py
    PYTHONPATH=src python examples/torch_flash_bwd.py --no-check --train-steps 4
    PYTHONPATH=src python examples/torch_flash_bwd.py --dtype bfloat16
    PYTHONPATH=src python examples/torch_flash_bwd.py --forward

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

With ``--forward`` it takes the bf16 forward pair instead
(``csrc/flash_attention_bf16.cu``): prints ptxas's registers and spills
for it and ``csrc/flash_attention.cu`` and each instance's shared memory,
registers and blocks an SM, holds ``flash_attention_bf16`` and
``flash_attention_lse_bf16`` to their plain versions by the same ulp rule
(lse within 2e-4 x max(1, max|plain|); a second launch bit for bit) at the
same ragged shapes and at keys of their own length (Sk 1, 37, 1499 against
Sq 1 and 64), causal and not, and times them at the bf16 paths' launch
shapes (yi-6b's eight served prompts of 71-512 tokens, summed over their
32 launches each as phase 4 sums them, its train shape, and the staged
jamba's 2 x 512 tokens of 32 heads of 128, causal)
beside their f32 instances on the same values widened and SDPA's bf16
forward, against the bf16 bound and their own products' (3 bf16 products
where 2 are counted: P in two pieces).  It needs none of the forward
pair's Python entry points that its parent tree lacks, so it times a
parent tree (``PYTHONPATH``) too.
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
# the bf16 forward pair's own products against the counted 2: s once, P v
# once a piece of P, two pieces
FWD_PRODUCTS = 3 / 2
# (B, S, H, D) and instance of the bf16 paths' forward launches, causal:
# lm-serve-bf16's eight prompts (32 launches each), lm-staged (b)'s 2 x 512
# tokens and lm-train-bf16's 1 x 1024
SERVE_LENGTHS = (71, 82, 97, 185, 202, 293, 349, 512)
FWD_SHAPES = tuple(((1, S, 32, 128), "flash_attention")
                   for S in SERVE_LENGTHS) + (
    ((2, 512, 32, 128), "flash_attention_lse"),
    ((1, 1024, 32, 128), "flash_attention_lse"))


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
    # the backward takes the forward's output in f32 (FlashAttention's)
    _, lse, o = FA.flash_attention_lse(q, k, v, causal=causal)
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


def check_forward(FA, gen, B, S, Sk, H, D, causal) -> float:
    """Worst error of the bf16 forward pair (the lse instance where Sk ==
    S) as a fraction of its bound."""
    from repro_torch.models.attention import chunked_attention
    from repro_torch.testing.ulp import bf16_ulp, f32_slack
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(B, Sk, H, D, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    want = chunked_attention(q, k, v, causal=causal, chunk=min(1024, Sk),
                             skip_masked=causal, return_lse=True)
    o_lim = bf16_ulp(want[0]) + 2 * f32_slack(q, k, v, causal)["o"]
    runs = [("flash_attention_bf16",
             lambda: (FA.flash_attention(q, k, v, causal=causal),))]
    if S == Sk:
        runs.append(("flash_attention_lse_bf16",
                     lambda: FA.flash_attention_lse(q, k, v, causal=causal)))
    worst = 0.0
    for name, run in runs:
        got, again = run(), run()
        for g, w, a in zip(got, want, again):
            err = (g.double() - w.double()).abs()
            lim = (o_lim if g.dtype == torch.bfloat16 else
                   TOL * max(1.0, float(w.abs().max())))
            ratio = float((err / lim).max())
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(f"{name} at {(B, S, Sk, H, D)} causal "
                                     f"{causal}: {ratio} of the bound")
            bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
            if not torch.equal(g.view(bits), a.view(bits)):
                raise AssertionError(f"{name} at {(B, S, Sk, H, D)}: a "
                                     f"second launch differs")
    return worst


def forward(FA, gen, check: bool) -> None:
    """Check and time the bf16 forward pair (see the module docstring)."""
    F = torch.nn.functional
    for D in FA.HEAD_DIMS if hasattr(FA, "forward_occupancy") else ():
        for name, (nbytes, regs, blocks) in FA.forward_occupancy(D).items():
            print(f"  {name} D={D}: {nbytes} bytes of shared memory, {regs} "
                  f"registers, {blocks} block(s) an SM")
    if check:
        cases = ([(B, S, S, H, D, c) for B, S, H, D in CHECK_SHAPES
                  for c in (True, False)]
                 + [(4, Sq, Sk, 20, 64, False) for Sq in (1, 64)
                    for Sk in (1, 37, 1499)])
        worst = max(check_forward(FA, gen, *c) for c in cases)
        print(f"checked {len(cases)} cases: worst error {worst:.3f} of the "
              f"bound, every second launch bit for bit")
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")
    print(f"causal, median of {REPS}: ms; SDPA bf16 forward ms; bf16 bound, "
          f"own products bound (x{FWD_PRODUCTS}); factor against SDPA and "
          f"the own bound; f32 instance ms")
    serve = []
    for (B, S, H, D), base in FWD_SHAPES:
        q, k, v = (torch.randn(B, S, H, D, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        fn = getattr(FA, base)
        n = B * S * H * D
        nbytes = 2 * 4 * n + (4.0 * B * H * S if base.endswith("lse") else 0)
        ops = 2.0 * B * H * D * S * (S + 1)
        t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
        bound = max(t_bytes, ops / PEAK_BF16_FLOPS * 1e3)
        own = max(t_bytes, ops * FWD_PRODUCTS / PEAK_BF16_FLOPS * 1e3)
        ms = median_ms(lambda: fn(q, k, v, causal=True), flush)
        qf, kf, vf = (t.float() for t in (q, k, v))
        ms32 = median_ms(lambda: fn(qf, kf, vf, causal=True), flush)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush)
        print(f"  {base}_bf16 {(B, S, H, D)}: {ms:.4f} ms; SDPA {sdpa:.4f}; "
              f"bound {bound:.4f}, own {own:.4f}; {ms / sdpa:.2f}x SDPA, "
              f"{ms / own:.2f}x own bound; f32 {base} {ms32:.4f} ms")
        if base == "flash_attention":
            serve += [ms, sdpa, ms32]
    print(f"  lm-serve-bf16's prompts, 32 launches each: flash_attention_bf16 "
          f"{32 * sum(serve[0::3]):.3f} ms, SDPA {32 * sum(serve[1::3]):.3f}, "
          f"f32 flash_attention {32 * sum(serve[2::3]):.3f}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--forward", action="store_true",
                    help="the bf16 forward pair in place of the backward")
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
        sources = (("flash_attention.cu", "flash_attention_bf16.cu")
                   if args.forward else ("flash_attention_bwd.cu",
                                         "flash_attention_bwd_bf16.cu"))
        if source in sources and ("registers" in line or "spill" in line):
            print(f"  ptxas {line.strip()} [{kernel}]")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.forward:
        forward(FA, gen, not args.no_check)
        if args.train_steps:
            train(args.train_steps, dtype)
        return 0
    for D in FA.HEAD_DIMS if hasattr(FA, "backward_occupancy") else ():
        for name, (nbytes, regs, blocks) in FA.backward_occupancy(D).items():
            print(f"  {name} D={D}: {nbytes} bytes of shared memory, {regs} "
                  f"registers, {blocks} block(s) an SM")

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
        _, lse, o = FA.flash_attention_lse(qd, kd, vd, causal=True)
        delta = FA.flash_attention_bwd_dq(qd, kd, vd, o, dd, lse, True)[1]
        es = qd.element_size()
        io = es * 6 * n + 8.0 * B * H * S
        # the bf16 lse instance also writes o in f32; dq reads o in f32
        wide = 0.0 if es == 4 else 4.0 * n
        tag = f" ({str(dt).removeprefix('torch.')})"
        rows += [
            ("flash_attention_lse" + tag, dt,
             lambda qd=qd, kd=kd, vd=vd: FA.flash_attention_lse(
                 qd, kd, vd, causal=True),
             es * 4 * n + wide + 4.0 * B * H * S, fwd, None),
            ("flash_attention_bwd_dq" + tag, dt,
             lambda qd=qd, kd=kd, vd=vd, o=o, dd=dd, lse=lse:
             FA.flash_attention_bwd_dq(qd, kd, vd, o, dd, lse, True),
             io - es * n + 4.0 * n, 1.5 * fwd, "flash_attention_bwd_dq"),
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
