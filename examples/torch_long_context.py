"""Long-context decode with sub-quadratic mixers (xLSTM / Jamba) on the
PyTorch port.

The long_500k shape runs only on the SSM/hybrid archs: their inter-token
state is O(1), so decoding with a huge "context" costs the same per token
as a short one — shown here at small scale by decoding after contexts of
increasing length and showing flat per-token cost, plus the staged
executor splitting the model when its weights "don't fit".

    PYTHONPATH=src python examples/torch_long_context.py --arch xlstm-1.3b
    PYTHONPATH=src python examples/torch_long_context.py --device cpu

The flags, flow and printed lines are the reference package's
``examples/long_context.py``, plus ``--device`` (default ``cuda``).  The
decode steps update the cache in place; a step is timed to the card's
``synchronize``.  Each context's cache holds the prompt, the warm-up step
and the 8 timed steps.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.runtime.reconfigure import StagedExecutor


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b",
                    choices=["xlstm-1.3b", "jamba-v0.1-52b"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = ARCHS[args.arch].reduced()
    assert cfg.is_subquadratic
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dtype=torch.float32)
    B = 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def randint(seed, shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)

    print(f"{cfg.name}: per-token decode cost vs context length "
          f"(O(1) state => flat)")
    n = 8
    for ctx in (64, 256, 1024):
        cache = init_cache(cfg, B, ctx + 1 + n, dtype=torch.float32,
                           device=dev)
        toks = randint(1, (B, ctx))
        _, cache, _ = forward(params, cfg, toks, cache=cache)
        tok = toks[:, :1]
        # warmup + timed decode steps
        logits, cache = decode_step(params, cfg, tok,
                                    torch.tensor([ctx], device=dev), cache)
        sync()
        t0 = time.perf_counter()
        for i in range(n):
            logits, cache = decode_step(
                params, cfg, tok, torch.tensor([ctx + 1 + i], device=dev),
                cache)
        sync()
        dt = (time.perf_counter() - t0) / n * 1e3
        print(f"  ctx={ctx:5d}: {dt:6.1f} ms/token")

    print("\nstaged execution (weights held on host, Eq. 5 accounting):")
    ex = StagedExecutor(cfg, params, n_stages=min(3, cfg.n_groups),
                        device=dev)
    toks = randint(2, (1, 32))
    ex.forward_logits(toks)
    eq5 = ex.eq5_latency(batch=1)
    print(f"  stages={eq5['n_stages']} compute={eq5['compute_s'] * 1e3:.0f}ms "
          f"reconfig={eq5['reconfig_s'] * 1e3:.0f}ms "
          f"boundary_compression={eq5['boundary_compression']:.2f}")


if __name__ == "__main__":
    main()
