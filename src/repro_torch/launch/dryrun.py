"""Dry-run: every (arch x shape) cell's step on the production mesh, with
no device — the counterpart of the reference package's
``launch/dryrun.py``, with its CLI and records.

The world is ``torch.distributed``'s ``fake`` backend over a ``FakeStore``:
this process is rank 0 of 256 (16x16, single pod) or 512 (2x16x16,
``--multi-pod``) ranks, and collectives return at once without moving a
byte.  ``make_production_mesh`` lays the mesh over that world, and
``input_specs`` gives every input of the cell's step as a DTensor over
rank 0's local shard on the meta device: nothing is allocated.  The step
(train, prefill or decode, as ``runtime/steps.py`` builds it on the mesh)
then runs once, eagerly, on the meta device, every kernel wrapper taking
its plain version there (whose operations stand for the kernel's in the
counts), under ``hlo_analysis.StepStats``, which counts rank 0's
operations, collective operand bytes and memory.  One default process
group runs in a process, so one mesh does: an invocation runs the cells of
one mesh, in turn (a sweep runs invocations side by side, a cell each).

A record keeps the reference's keys where the quantity is the same:
``lower_s`` is the step's eager run (there is no separate compilation, so
no ``compile_s``), ``memory`` / ``cost`` / ``collectives`` /
``trip_aware`` come from ``hlo_analysis``, ``per_device_bytes`` is the
arguments' local bytes plus the step's peak temporary bytes, and
``fits_hbm`` compares it with the H100's memory (``H100_HBM_BYTES``).  A
cell that errors is recorded with its error and counted in the exit code.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from ..configs import ARCHS, SHAPES, cell_applicable
from ..core.resources import H100_HBM_BYTES
from ..optim.adamw import AdamWConfig
from ..runtime.steps import (input_specs, make_decode_step,
                             make_prefill_step, make_train_step)
from .hlo_analysis import (StepStats, collective_stats, cost_stats,
                           memory_stats, trip_aware_stats)
from .mesh import PRODUCTION, make_production_mesh

# the reference's archs with quantised optimizer moments (grok-1, the
# largest; qwen2-vl-72b and jamba), kept so that the cells are the same
QUANTIZED_OPT_ARCHS = {"grok-1-314b", "qwen2-vl-72b", "jamba-v0.1-52b"}


def fake_world(multi_pod: bool) -> int:
    """Join (or find) the fake world of the production mesh as rank 0;
    returns its size.  A world of another size already running is
    refused: a process has one default process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, _ = PRODUCTION[multi_pod]
    need = 1
    for s in shape:
        need *= s
    if dist.is_initialized():
        if dist.get_world_size() != need:
            raise ValueError(f"this process runs a world of "
                             f"{dist.get_world_size()} ranks; the "
                             f"{'multi' if multi_pod else 'single'}-pod "
                             f"mesh needs {need}: one mesh a process")
        return need
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=need)
    return need


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, remat: str = "full") -> dict:
    cfg = ARCHS[arch_name]
    shape = SHAPES[shape_name]
    mesh_tag = "multipod" if multi_pod else "singlepod"
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
                 "remat": remat}
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = reason
        _write(out_dir, rec)
        return rec

    fake_world(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec["n_devices"] = mesh.size()
    opt_cfg = AdamWConfig(quantize_states=arch_name in QUANTIZED_OPT_ARCHS)
    specs = input_specs(cfg, shape, mesh, opt_cfg=opt_cfg)
    B, S = shape.global_batch, shape.seq_len
    kw = dict(device="meta", mesh=mesh, dtype=specs["params"]["embed"].dtype)
    if shape.kind == "train":
        step = make_train_step(cfg, opt_cfg, remat=remat, **kw)
        args = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, B, S, **kw)
        args = (specs["params"], specs["cache"], specs["batch"])
    else:
        step = make_decode_step(cfg, B, S, **kw)
        args = (specs["params"], specs["cache"], specs["token"],
                specs["pos"])

    t0 = time.time()
    with StepStats(args) as stats:
        out = step(*args)
    rec["lower_s"] = round(time.time() - t0, 1)
    mem = memory_stats(stats, out)
    cost = cost_stats(stats)
    coll = collective_stats(stats)
    print(f"[{arch_name}/{shape_name}/{mesh_tag}] memory:", mem)
    print(f"[{arch_name}/{shape_name}/{mesh_tag}] cost:", cost)
    per_device = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    rec.update({
        "memory": mem, "cost": cost, "collectives": coll.to_json(),
        "trip_aware": trip_aware_stats(stats),
        "per_device_bytes": per_device,
        "fits_hbm": per_device < H100_HBM_BYTES,
    })
    _write(out_dir, rec)
    return rec


def _write(out_dir: pathlib.Path, rec: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1))


def status(rec: dict) -> str:
    """One line of a record: its time, bytes, fit, operations and
    collective bytes (or why it was skipped, or its error)."""
    if "error" in rec:
        return "ERROR " + rec["error"]
    if "skipped" in rec:
        return "SKIP " + rec["skipped"]
    return (f"ok lower={rec['lower_s']}s "
            f"per_device_bytes={rec['per_device_bytes']} "
            f"fits={rec['fits_hbm']} flops={rec['cost']['flops']:.4e} "
            f"collective_bytes={rec['collectives']['total_bytes']:.4e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell for the chosen mesh")
    ap.add_argument("--remat", default="full", choices=("none", "dots", "full"))
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    tag = "multipod" if args.multi_pod else "singlepod"

    cells = ([(a, s) for a in sorted(ARCHS) for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in cells:
        path = out / f"{arch}__{shape}__{tag}.json"
        if args.skip_existing and path.exists():
            rec = json.loads(path.read_text())
            if "error" not in rec:
                print(f"skip {arch}/{shape}/{tag} (exists)")
                continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, out, remat=args.remat)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures += 1
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": tag,
                   "error": f"{type(e).__name__}: {e}"}
            _write(out, rec)
        print(f"{arch:18s} {shape:12s} {tag}: {status(rec)}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
