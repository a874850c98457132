"""The LM train step of the PyTorch port under two AdamW warmup schedules.

    PYTHONPATH=src python examples/torch_train_schedules.py    # yi-6b, card
    PYTHONPATH=src python examples/torch_train_schedules.py --dtype bfloat16
    PYTHONPATH=src python examples/torch_train_schedules.py --smoke \
        --device cpu --seq 128
    PYTHONPATH=src python examples/torch_train_schedules.py --dtype \
        bfloat16 --layers 2 4 8 16 32   # depth cuts, card

Trains the same random weights (a seeded generator) for ``--steps`` steps
on one repeated batch (``TokenPipeline.batch_at(0)``), in ``--dtype`` (f32
or bf16 parameters) with int8 AdamW states and remat "full", once per
schedule and attention route, and
prints the losses, gradient norms and step times.  The schedules are
``lr`` with one warmup step, and ``lr`` with the optimizer's default 100
(the one ``python -m repro_torch.launch.train`` uses); the routes are the
kernel route (``FlashAttention``) and the plain route (``chunked_attention``
through autograd).  ``--layers`` cuts the depth, every width kept, and runs
each of the depths it is given in turn.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.steps import make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--layers", type=int, nargs="+", default=[None],
                    help="depth cuts (default: the config's depth)")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    base = ARCHS[args.arch].reduced() if args.smoke else ARCHS[args.arch]
    batch = TokenPipeline(DataConfig(vocab=base.vocab, seq_len=args.seq,
                                     global_batch=1)).batch_at(0)
    on_card = args.device.startswith("cuda")
    runs = [(layers, warmup, use_kernels) for layers in args.layers
            for warmup in (1, 100) for use_kernels in (True, False)]
    for layers, warmup, use_kernels in runs:
        cfg = base if layers is None else dataclasses.replace(
            base, n_layers=layers)
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = init_params(gen, cfg, dtype=dtype)
        opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=warmup,
                              total_steps=args.steps,
                              quantize_states=True)
        opt = init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, device=args.device,
                               use_kernels=use_kernels, dtype=dtype)
        losses, norms, secs = [], [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(round(float(m["loss"]), 4))  # synchronises
            norms.append(round(float(m["grad_norm"]), 3))
            secs.append(round(time.perf_counter() - t0, 3))
        route = "kernel" if use_kernels else "plain"
        print(f"{cfg.name} {cfg.n_layers} layers {args.dtype} lr "
              f"{args.lr} warmup {warmup}, {route} route: "
              f"losses {losses}, grad_norm {norms}, s a step {secs}")
        del params, opt, step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
