"""Quickstart on the PyTorch port: the one compile façade, from model name
to running design.

    PYTHONPATH=src python examples/torch_quickstart.py [--device u200] \
        [--batch 1]
    PYTHONPATH=src python examples/torch_quickstart.py --model unet_exec \
        --mode pipelined --execute [--save unet.smof.json]
    PYTHONPATH=src python examples/torch_quickstart.py --model unet_exec \
        --mode pipelined --execute --torch-device cpu   # no GPU

Everything goes through ``repro_torch.compile``: ``CompileSpec`` names the
model (one registry: ``EXEC_MODELS`` for executable graphs,
``PAPER_MODELS`` for paper-scale cost-model graphs), the device sheet, the
plan strategy and the execution mode; the returned ``Compiled`` artifact
runs (``compiled(x)``), reports, and saves itself.  Prints the paper's
Fig. 4 design point (UNet on U200: ~21 fps, single partition, weights
mostly on-chip) and the decision vector the DSE produced — which edges
were evicted, which layers fragmented — the same block as the reference
package's ``examples/quickstart.py``.  Paper-scale models are costed only;
the ``*_exec`` models can additionally be *executed* with ``--execute``,
on the card (``--torch-device``, default ``cuda``) unless asked for the
CPU.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

import repro_torch
from repro_torch.api import add_compile_args, spec_from_args
from repro_torch.core import DSEConfig, EXEC_MODELS, get_model


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    add_compile_args(ap, default_model="unet", default_mode="staged")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--execute", action="store_true",
                    help="lower the plan and run it (needs a *_exec model)")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="with --execute: save the Compiled artifact")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="with --execute: run once traced and write a "
                         "Chrome trace-event JSON (open in Perfetto)")
    ap.add_argument("--onchip-kbits", type=float, default=None,
                    help="shrink the device's on-chip memory view to this "
                         "many kilobits — forces the DSE into eviction/"
                         "fragmentation, the streaming story the exec "
                         "models are otherwise too small to trigger")
    args = ap.parse_args(argv)

    spec = spec_from_args(
        args, strategy="dse",
        dse=DSEConfig(batch=args.batch, cut_kinds=("conv", "pool"),
                      codecs=("none", "rle"), word_bits=8))
    if args.onchip_kbits is not None:
        from repro_torch.core.resources import get_device
        spec = dataclasses.replace(spec, device=dataclasses.replace(
            get_device(args.device), onchip_bits=args.onchip_kbits * 1e3))
    g = get_model(args.model)()
    print(f"{args.model}: {g.total_macs() / 1e9:.1f} GMACs, "
          f"{g.total_weight_words() / 1e6:.1f} M params, "
          f"{g.g.number_of_nodes()} vertices")

    # the search half of the façade works for every model — executable or
    # costed-only — and the plan carries the whole decision vector
    # (mode="reference" is plan-free, so the design print uses "staged")
    plan_spec = (spec if spec.mode != "reference"
                 else dataclasses.replace(spec, mode="staged"))
    plan, _ = repro_torch.build_plan(plan_spec, g)
    fragged = [lp for lp in plan.layers.values()
               if lp.weight_static_fraction < 1.0]
    print(f"\nDSE result on {args.device} (paper Fig. 4 for unet/u200: "
          f"21 fps / 47 ms):")
    print(f"  throughput : {plan.est_throughput_fps:.2f} fps")
    print(f"  latency    : {plan.est_latency_s * 1e3:.1f} ms")
    print(f"  partitions : {plan.n_stages}")
    print(f"  evictions  : {sum(1 for s in plan.streams if s.evicted)} edges")
    if fragged:
        mean_m = sum(1.0 - lp.weight_static_fraction
                     for lp in fragged) / len(fragged)
        print(f"  fragmented : {len(fragged)} layers (mean m={mean_m:.2f})")
    else:
        print("  fragmented : 0 layers")
    for s in plan.streams:
        if s.evicted:
            print(f"    evicted: {s.src} -> {s.dst}  codec={s.codec}")
    print(f"\nExecutionPlan: {plan.n_stages} stage(s), "
          f"{len(plan.layers)} layers; est {plan.est_throughput_fps:.2f} fps; "
          f"provenance {plan.provenance}")

    if args.execute:
        if args.model not in EXEC_MODELS:
            raise SystemExit(f"--execute needs a *_exec model, not "
                             f"{args.model!r} (see EXEC_MODELS)")
        # same spec, same plan — just lowered per --mode this time
        compiled = repro_torch.compile(dataclasses.replace(
            spec, model=g, strategy="manual-plan", plan=plan))
        gen = torch.Generator(device=spec.torch_device).manual_seed(0)
        x = torch.randn(compiled.input_shape(), generator=gen,
                        device=spec.torch_device)
        y = compiled(x)
        print(f"\nexecuted ({compiled.mode}): output shape {tuple(y.shape)}")
        # --channel attaches the off-chip memory model (docs/MEMORY.md):
        # show how the arbiter divided the port and whether every weight
        # prefetch made its stage-start deadline
        mem = getattr(getattr(compiled.executor, "report", None),
                      "memory", None)
        if mem is not None:
            arb = mem.arbitration
            print(f"\noff-chip channel ({mem.config.policy}, "
                  f"{mem.channel.gbps:g} Gbps, "
                  f"utilization {arb.utilization:.0%}):")
            print(f"  {'stream':<28} {'kind':<20} {'demand':>9} "
                  f"{'granted':>9}  ok")
            for r in mem.stream_table():
                print(f"  {r['name']:<28} {r['kind']:<20} "
                      f"{r['demand_gbps']:>7.2f}G {r['granted_gbps']:>7.2f}G"
                      f"  {'yes' if r['satisfied'] else 'NO'}")
            misses = mem.prefetch.deadline_misses
            print(f"  prefetch deadline misses: {misses}"
                  + (f" {mem.prefetch.misses_by_stage()}" if misses else ""))
            print(f"  contended Eq.6: {mem.eq6_contended_cycles:g} cycles "
                  f"(uncontended {mem.eq6_cycles:g}); "
                  f"stalls/tick {mem.total_stall_cycles:g} cycles")
        if args.trace:
            _, mc = compiled.trace(x, path=args.trace)
            print(f"trace written: {args.trace}")
            if mc is not None:
                print(f"model check: ok={mc.ok} "
                      f"ticks={mc.ticks_measured}/{mc.ticks_predicted} "
                      f"steady={mc.steady_measured}/{mc.steady_predicted} "
                      f"max_stage_rel_err={mc.max_stage_rel_err}")
        print(f"unified report: {compiled.report()}")
        if args.save:
            print(f"saved artifact: {compiled.save(args.save)} "
                  f"(reload with repro_torch.Compiled.load)")


if __name__ == "__main__":
    main()
