"""Serving launcher (continuous batching + KV eviction) on PyTorch.

    python -m repro_torch.launch.serve --arch yi-6b --requests 8
    python -m repro_torch.launch.serve --arch yi-6b --no-smoke   # full width
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --no-smoke

The reference CLI's flags and printout, plus ``--device`` (default
``cuda``).  ``--smoke`` (the default) runs the config's reduced form;
``--no-smoke`` runs the published config (the reference declares
``--smoke`` with ``default=True``, so its CLI always runs the reduced
form).  Weights are random, drawn from ``--seed`` with a torch generator on
the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS
from ..models import init_params
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
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced() if args.smoke else ARCHS[args.arch]
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
