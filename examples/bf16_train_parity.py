"""The bf16 train step of the reference and of the PyTorch port on the CPU,
from the same weights on the same batch.

    PYTHONPATH=src python examples/bf16_train_parity.py
    PYTHONPATH=src python examples/bf16_train_parity.py --layers 1 --seq 64

yi-6b at its published widths (d_model 4096, 32 heads / 4 KV of 128,
d_ff 11008, vocab 64000) with its depth cut to ``--layers`` (2), one
batch of 1 x ``--seq`` (256) tokens (``TokenPipeline.batch_at(0)``,
repeated), ``--steps`` (4) steps of ``make_train_step(dtype=bf16,
remat="full")`` under AdamW ``lr=3e-4, total_steps=4,
quantize_states=True`` (the default warmup of 100 steps: ``TRAIN_OPT`` of
``chip_smoke.py``, whose bf16 train path overshoots under it at full
depth on the card).

Each package runs in a process of its own, one after the other, so that
neither holds the other's model and the port's process imports no JAX:
the reference's part makes ``init_params(PRNGKey(0), cfg, bf16)``, writes
every leaf to a temporary ``.npz`` (bf16 leaves by their uint16 bits),
and trains; the port's part reads the leaves through
``params_from_numpy`` and trains the same way on the plain attention
route.  Prints both loss trajectories, their largest difference against
``bf16_route_tol`` (2 x 2^-8 x sqrt(2 x layers) of the largest loss, the
card's rule for two routes of the bf16 step) and whether each rises at
the last step.  The larger of the two parts holds about 17 GB of host
memory; each part takes a few minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ARCH = "yi-6b"
OPT = dict(lr=3e-4, total_steps=4, quantize_states=True)


def _cfg(pkg_configs, layers: int):
    import dataclasses
    return dataclasses.replace(pkg_configs.ARCHS[ARCH], n_layers=layers)


def reference(args) -> dict:
    """The reference package's step (JAX on the CPU, ``make_host_mesh``);
    writes the initial weights to ``args.weights``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro import configs
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as M
    from repro.optim import adamw as O
    from repro.runtime.steps import make_train_step

    cfg = _cfg(configs, args.layers)
    params = M.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    leaves = {}
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        a = np.asarray(a)
        leaves[name] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    np.savez(args.weights, **leaves)
    del leaves
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                     global_batch=1)).batch_at(0)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt_cfg = O.AdamWConfig(**OPT)
    with make_host_mesh() as mesh:
        step, _, _ = make_train_step(cfg, mesh, opt_cfg, remat="full",
                                     dtype=jnp.bfloat16, microbatches=1)
        step = jax.jit(step)
        opt = O.init_opt_state(params, opt_cfg)
        losses, secs = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
    return {"losses": losses, "seconds": secs}


def port(args) -> dict:
    """The port's step on the CPU, from the reference's weights."""
    import ml_dtypes
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.steps import make_train_step

    assert "jax" not in sys.modules
    cfg = _cfg(configs, args.layers)
    tree: dict = {}
    with np.load(args.weights) as z:
        for name in z.files:
            a = z[name]
            if a.dtype == np.uint16:
                a = a.view(ml_dtypes.bfloat16)
            node = tree
            *up, leaf = name.split("/")
            for k in up:
                node = node.setdefault(k, {})
            node[leaf] = a
    params = params_from_numpy(tree, cfg, "cpu")
    del tree
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                     global_batch=1)).batch_at(0)
    opt_cfg = AdamWConfig(**OPT)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat="full", dtype=torch.bfloat16,
                           microbatches=1, device="cpu")
    losses, secs = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return {"losses": losses, "seconds": secs}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--part", choices=("both", "reference", "port"),
                    default="both")
    ap.add_argument("--weights", help="the .npz the two parts share")
    args = ap.parse_args(argv)
    if args.part != "both":
        out = (reference if args.part == "reference" else port)(args)
        print(json.dumps(out))
        return 0
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.npz")
        for part in ("reference", "port"):
            cmd = [sys.executable, os.path.abspath(__file__), "--part", part,
                   "--weights", weights, "--layers", str(args.layers),
                   "--seq", str(args.seq), "--steps", str(args.steps)]
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            if done.returncode:
                sys.stderr.write(done.stdout + done.stderr)
                return done.returncode
            runs[part] = json.loads(done.stdout.strip().splitlines()[-1])
    ref, got = runs["reference"]["losses"], runs["port"]["losses"]
    diff = max(abs(a - b) for a, b in zip(ref, got))
    tol = 2 * 2.0 ** -8 * math.sqrt(2 * args.layers) * max(map(abs, ref))
    print(f"{ARCH}, {args.layers} layers at the published widths, 1 x "
          f"{args.seq} tokens, bf16, AdamW {OPT}")
    for part, r in runs.items():
        ls = r["losses"]
        print(f"  {part}: losses {ls}; seconds a step "
              f"{[round(s, 2) for s in r['seconds']]}; the last step "
              f"{'rises' if ls[-1] > ls[-2] else 'falls'}, the last loss "
              f"{'above' if ls[-1] > ls[0] else 'below'} the first")
    print(f"  largest difference {diff:.6g} against bf16_route_tol "
          f"{tol:.6g}: {'within' if diff <= tol else 'PAST'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
