"""End-to-end serving on the PyTorch port (SMOF is an inference
toolflow).

Serves a reduced-config model with batched requests through the
continuous-batching engine: prefill per request, lockstep decode over
slots, KV pages evicted to the host in BFP8 when requests finish (the
paper's activation eviction at the device<->host level).

    PYTHONPATH=src python examples/torch_serve_batched.py --arch yi-6b \
        --requests 6 --max-new 12
    PYTHONPATH=src python examples/torch_serve_batched.py --arch yi-6b \
        --torch-device cpu                          # no GPU

Passing ``--model`` switches to the streaming-graph serving path instead:
an ``EXEC_MODELS`` graph is compiled through ``repro_torch.compile`` (the
same ``--channel``/``--channel-gbps`` knobs as the quickstart,
docs/MEMORY.md) and frames are served through ``Compiled.serve``; the
summary prints the off-chip per-stream bandwidth table and prefetch
deadline misses:

    PYTHONPATH=src python examples/torch_serve_batched.py --model unet_exec \
        --channel weighted-fair --channel-gbps 0.5 --onchip-kbits 300

Both paths run on the card (``--torch-device``, default ``cuda``) unless
asked for the CPU.  The flags and printed lines are the reference
package's ``examples/serve_batched.py``; the weights come from a torch
generator seeded 0 on the device, so the tokens differ from the
reference's while the counters the schedule fixes (prefills, decode steps,
evicted pages) are the same.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch
from repro_torch.api import add_compile_args, spec_from_args
from repro_torch.configs import ARCHS
from repro_torch.core import EXEC_MODELS
from repro_torch.models import init_params
from repro_torch.serving.engine import ServingEngine


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_graph(args) -> None:
    """Serve a compiled streaming graph and report the channel split."""
    from repro_torch.core.resources import get_device

    spec = spec_from_args(args, microbatches=4)
    if args.onchip_kbits is not None:
        spec = dataclasses.replace(spec, device=dataclasses.replace(
            get_device(args.device), onchip_bits=args.onchip_kbits * 1e3))
    c = repro_torch.compile(spec)
    srv = c.serve()
    x = np.zeros(c.input_shape(), np.float32)
    t0 = time.time()
    for _ in range(args.requests):
        srv.submit(x)
    srv.flush()
    _sync(args.torch_device)
    dt = time.time() - t0
    st = srv.stats
    print(f"served {st.frames_out}/{st.frames_in} frames of {args.model} "
          f"({c.mode}, {args.device}) in {dt:.2f}s "
          f"({st.frames_out / dt:.1f} fps)")

    mem = getattr(getattr(c.executor, "report", None), "memory", None)
    if mem is None:
        print("\nno off-chip channel model attached "
              "(pass --channel / --channel-gbps, see docs/MEMORY.md)")
        return
    arb = mem.arbitration
    print(f"\noff-chip channel ({mem.config.policy}, "
          f"{mem.channel.gbps:g} Gbps, utilization {arb.utilization:.0%}):")
    print(f"  {'stream':<28} {'kind':<20} {'demand':>9} {'granted':>9}  ok")
    for r in mem.stream_table():
        print(f"  {r['name']:<28} {r['kind']:<20} "
              f"{r['demand_gbps']:>7.2f}G {r['granted_gbps']:>7.2f}G"
              f"  {'yes' if r['satisfied'] else 'NO'}")
    misses = mem.prefetch.deadline_misses
    print(f"  prefetch deadline misses: {misses}"
          + (f" {mem.prefetch.misses_by_stage()}" if misses else ""))
    print(f"  contended Eq.6: {mem.eq6_contended_cycles:g} cycles "
          f"(uncontended {mem.eq6_cycles:g})")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=3)
    ap.add_argument("--evict", action="store_true", default=True)
    # --model flips to the streaming-graph path; brings --device/--mode/
    # --channel/--channel-gbps along (docs/MEMORY.md), and --torch-device
    # (where both paths' tensors live)
    add_compile_args(ap, default_model=None, default_mode="pipelined",
                     models=EXEC_MODELS, modes=("staged", "pipelined"))
    ap.add_argument("--onchip-kbits", type=float, default=None,
                    help="graph path: shrink the on-chip view so the DSE "
                         "evicts/streams (as in quickstart)")
    args = ap.parse_args(argv)

    if args.model is not None:
        serve_graph(args)
        return

    dev = args.torch_device
    cfg = ARCHS[args.arch].reduced()
    print(f"serving {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) "
          f"with {args.batch_slots} decode slots")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dtype=torch.float32)
    eng = ServingEngine(cfg, params, max_batch=args.batch_slots, s_max=128,
                        evict_to_host=args.evict, device=dev)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8 + 4 * (i % 3))
        reqs.append(eng.submit(prompt, max_new_tokens=args.max_new))

    t0 = time.time()
    eng.run_until_drained()
    _sync(dev)
    dt = time.time() - t0

    st = eng.stats
    print(f"\ndrained in {dt:.2f}s")
    print(f"  prefills      : {st.prefills}")
    print(f"  decode steps  : {st.decode_steps} "
          f"(continuous batching: {st.generated} tokens through "
          f"{args.batch_slots} slots)")
    print(f"  tokens/s      : {st.generated / dt:.1f}")
    if st.evicted_pages:
        print(f"  evicted pages : {st.evicted_pages} "
              f"({st.evicted_bytes_raw / 1e6:.2f} MB -> "
              f"{st.evicted_bytes_compressed / 1e6:.2f} MB, "
              f"ratio {st.evicted_bytes_compressed / st.evicted_bytes_raw:.2f}"
              f" — paper Eq. 2's c_bar)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {len(r.out_tokens)} tokens "
              f"{r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
