"""Serving launcher (continuous batching + KV eviction) on PyTorch.

    python -m repro_torch.launch.serve --arch yi-6b --requests 8
    python -m repro_torch.launch.serve --arch yi-6b --no-smoke   # full width
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --no-smoke
    python -m repro_torch.launch.serve --arch xlstm-1.3b --no-smoke
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --no-smoke \
        --n-layers 8           # one period of its 32 layers

The reference CLI's flags and printout, plus ``--device`` (default
``cuda``) and ``--n-layers``.  ``--smoke`` (the default) runs the config's
reduced form; ``--no-smoke`` runs the published config (the reference
declares ``--smoke`` with ``default=True``, so its CLI always runs the
reduced form), at its published widths and, with ``--n-layers``, cut to
that depth (a multiple of the layer pattern's period; the cut is printed).
A config whose f32 weights exceed the card's memory is refused before any
weight is made.  Weights are random, drawn from ``--seed`` with a torch
generator on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from ..configs import ARCHS
from ..models import init_params, param_shapes
from ..serving.engine import ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--no-evict", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                         "of the layer pattern's period)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced() if args.smoke else ARCHS[args.arch]
    if args.n_layers is not None:
        if args.n_layers % cfg.group_size:
            ap.error(f"--n-layers {args.n_layers} is not a multiple of "
                     f"{cfg.name}'s period of {cfg.group_size} layers")
        print(f"{cfg.name}: {args.n_layers} of its {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    n_bytes = 4 * sum(math.prod(s) for s in param_shapes(cfg).values())
    if torch.device(args.device).type == "cuda":
        have = torch.cuda.get_device_properties(args.device).total_memory
        if n_bytes > have:
            ap.error(f"{cfg.name}: {n_bytes} bytes of f32 weights do not "
                     f"fit the card's {have}; cut the depth (--n-layers)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(gen, cfg, dtype=torch.float32)
    eng = ServingEngine(cfg, params, max_batch=args.slots, s_max=args.s_max,
                        evict_to_host=not args.no_evict, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, args.prompt_len),
                       max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    eng.run_until_drained()
    dt = time.time() - t0
    st = eng.stats
    print(f"{cfg.name}: {len(reqs)} requests via {args.slots} slots in "
          f"{dt:.2f}s")
    print(f"  tokens/s={st.generated / dt:.1f} prefills={st.prefills} "
          f"decode_steps={st.decode_steps}")
    if st.evicted_bytes_raw:
        print(f"  kv evicted: {st.evicted_bytes_raw / 1e6:.2f} MB -> "
              f"{st.evicted_bytes_compressed / 1e6:.2f} MB "
              f"(c_bar={st.evicted_bytes_compressed / st.evicted_bytes_raw:.2f})")


if __name__ == "__main__":
    main()
