"""Training launcher on PyTorch.

    python -m repro_torch.launch.train --arch yi-6b --steps 100 \
        [--smoke] [--ckpt-dir DIR] [--restore] [--device cuda|cpu]
    python -m repro_torch.launch.train --arch yi-6b --quantize-opt \
        --batch 1 --seq 1024 --steps 3          # yi-6b at full width

The reference CLI's flags and closing line, plus ``--device`` (default
``cuda``).  ``--smoke`` runs the config's reduced form.  The loop is
fault-tolerant: async checkpoints, deterministic data resume, straggler
logging (``runtime/fault.py``).  Parameters come from ``init_params`` with
a generator seeded on the device.  The step runs on a device mesh
(``launch/mesh.py``) through ``make_train_step(..., mesh=)``, as the
reference's CLI: ``--mesh host`` (the default) is the 1x1 mesh on the one
device; ``single`` and ``multi`` the production mesh of 256 or 512 ranks
over a ``torchrun`` world, refused, naming the world size they need, on a
world of another size.  ``--dtype bfloat16`` makes
the parameters bf16 (the reference's default working type; the port's
default stays ``float32``), and attention takes the kernels' bf16
instances on the card.  An encoder-decoder (whisper) is refused before its
model is built: the token pipeline yields tokens and labels only, as the
reference's, and no encoder frames; ``runtime.steps.make_train_step``
trains it on batches that carry ``enc_frames``.
"""
from __future__ import annotations

import argparse

import torch

from ..checkpoint.store import CheckpointStore
from ..configs import ARCHS
from ..data.pipeline import DataConfig, TokenPipeline
from ..models import init_params
from ..optim.adamw import AdamWConfig, init_opt_state
from ..runtime.fault import FaultConfig, FaultTolerantLoop
from ..runtime.steps import make_train_step
from .mesh import make_host_mesh, make_production_mesh
NO_FRAMES = ("{}: the token pipeline has no encoder frames to give an "
             "encoder-decoder; train it through "
             "repro_torch.runtime.steps.make_train_step with batches that "
             "carry enc_frames")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="host", choices=("host", "single", "multi"))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--remat", default="full", choices=("none", "dots", "full"))
    ap.add_argument("--quantize-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh == "host":
        mesh = make_host_mesh(args.device)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=args.device)
    cfg = ARCHS[args.arch]
    if cfg.is_encdec:
        raise ValueError(NO_FRAMES.format(cfg.name))
    if args.smoke:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          quantize_states=args.quantize_opt)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    store = CheckpointStore(args.ckpt_dir, keep_last=3)

    dtype = getattr(torch, args.dtype)
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat, dtype=dtype,
                              device=args.device, mesh=mesh)
    params = init_params(torch.Generator(device=args.device).manual_seed(0),
                         cfg, dtype=dtype)
    opt = init_opt_state(params, opt_cfg)

    losses = []

    def run_step(state, batch):
        p, o = state
        p, o, metrics = step_fn(p, o, batch)
        losses.append(float(metrics["loss"]))
        return (p, o)

    loop = FaultTolerantLoop(run_step, store,
                             FaultConfig(checkpoint_every=args.ckpt_every))
    state, start = ((params, opt), 0)
    if args.restore:
        state, start = loop.try_restore((params, opt))
        print(f"restored; resuming at step {start}")
    state = loop.run(state, data.batch_at, start_step=start,
                     num_steps=args.steps - start)
    print(f"{cfg.name}: {len(losses)} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; events: {[e['kind'] for e in loop.events]}")


if __name__ == "__main__":
    main()
