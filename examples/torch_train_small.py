"""Train a small LM on the PyTorch port with the fault-tolerant loop:
checkpoints, deterministic data resume, straggler monitoring — then kill
and resume to prove restart.

    PYTHONPATH=src python examples/torch_train_small.py --steps 60 \
        --arch yi-6b
    PYTHONPATH=src python examples/torch_train_small.py --steps 40 \
        --batch 2 --seq 32 --device cpu             # no GPU

The flags, flow and printed lines are the reference package's
``examples/train_small.py``, plus ``--device`` (default ``cuda``).  The
step is ``runtime.steps.make_train_step`` (``lm_loss``, its gradient and
``adamw_update``, one microbatch, no remat), which updates the state in
place; the first run takes a copy of the initial state, so the restart's
template is the initial state, as the reference's.  Weights come from a
torch generator seeded 0 on the device.
"""
from __future__ import annotations

import argparse
import copy
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault import FaultConfig, FaultTolerantLoop
from repro_torch.runtime.steps import make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced()
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                          weight_decay=0.01)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="smof_ckpt_")
    store = CheckpointStore(ckpt_dir, keep_last=2)

    params = init_params(torch.Generator(device=args.device).manual_seed(0),
                         cfg, dtype=torch.float32)
    opt = init_opt_state(params, opt_cfg)
    losses = []
    train_step = make_train_step(cfg, opt_cfg, remat="none", microbatches=1,
                                 device=args.device)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = train_step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        return params, opt

    loop = FaultTolerantLoop(step_fn, store,
                             FaultConfig(checkpoint_every=20))
    half = args.steps // 2
    print(f"training {cfg.name}: {args.steps} steps "
          f"(batch {args.batch} x seq {args.seq}), ckpts -> {ckpt_dir}")
    state = loop.run(copy.deepcopy((params, opt)), data.batch_at,
                     start_step=0, num_steps=half)
    print(f"  phase 1: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"simulating node failure + restart...")

    # "restart": a fresh loop restores the newest checkpoint and resumes the
    # deterministic data stream at the right step
    loop2 = FaultTolerantLoop(step_fn, store, FaultConfig(checkpoint_every=20))
    state2, next_step = loop2.try_restore((params, opt))
    print(f"  restored at step {next_step}")
    loop2.run(state2, data.batch_at, start_step=next_step,
              num_steps=args.steps - next_step)
    print(f"  phase 2: final loss {losses[-1]:.3f} "
          f"(start {losses[0]:.3f}; ln V = {np.log(cfg.vocab):.3f})")
    print(f"  events: { [e['kind'] for e in loop.events + loop2.events] }")
    assert losses[-1] < losses[0], "loss should decrease"
    if args.ckpt_dir is None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
