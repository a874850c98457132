"""Conformance fuzz driver of the port: generate -> check -> shrink ->
write repro.

    python -m repro_torch.testing.fuzz --budget 50 --seed 0
    python -m repro_torch.testing.fuzz --torch-device cpu --budget 2

runs 50 deterministic cases (seeded graphs + plans, see ``gen``; the
reference package's population, case for case) through every differential
oracle (see ``oracle``) on ``--torch-device`` (the card by default).  On a
violation the failing case is *shrunk* — streams unevicted, stages merged,
skip edges dropped, shape-preserving layers spliced out, the microbatch
reduced — keeping a candidate only while the **same oracle** still fails,
then written as a replayable JSON repro under ``--out`` (default
``tests/repros_torch/``: the reference package's suite replays every file
under ``tests/repros/`` with the reference package, so the port's repros
live apart).  The file format is the reference's, so either package
replays the other's repros.

``--inject-fault`` deliberately breaks one mechanism (``oracle.FAULTS``)
to prove the harness catches, shrinks and persists a planted bug; the
recorded fault is replayed too, so a fault repro keeps failing until the
fault (or the harness hole it found) is addressed.

Repro file format (version 1)::

    {"kind": "smof-fuzz-repro", "version": 1,
     "label": "<seed>-<index>", "seed": <weight/input seed>,
     "oracle": "<oracle name>", "message": "<violation text>",
     "inject_fault": null | "<fault name>",
     "shrunk": {"from_vertices": N, "to_vertices": M, "runs": K},
     "case": {"graph": <Graph.to_json_dict>, "plan": <ExecutionPlan JSON>,
              "seed": ..., "label": ...}}
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import traceback
from typing import Iterator

from ..core.plan import PlanValidationError, StreamPlan
from .gen import (FuzzCase, GenConfig, case_from_json_dict,
                  case_to_json_dict, random_case)
from .oracle import FAULTS, CaseReport, OracleViolation, check_case, \
    inject_fault

__all__ = ["run_case", "shrink", "write_repro", "replay", "fuzz", "main",
           "REPRO_KIND", "REPRO_VERSION", "DEFAULT_OUT"]

REPRO_KIND = "smof-fuzz-repro"
REPRO_VERSION = 1
DEFAULT_OUT = "tests/repros_torch"


def run_case(case: FuzzCase, fault: str | None = None, *,
             torch_device: str = "cuda") -> OracleViolation | None:
    """One case through every oracle; ``None`` when all pass.  Unexpected
    exceptions become an ``OracleViolation`` with oracle name ``crash`` —
    a lowering that dies on a valid generated case is a finding too."""
    try:
        with inject_fault(fault):
            check_case(case, torch_device=torch_device)
        return None
    except OracleViolation as v:
        return v
    except Exception as e:      # noqa: BLE001 - every crash is a finding
        tb = traceback.format_exc(limit=3).strip().splitlines()[-1]
        return OracleViolation("crash", f"{type(e).__name__}: {e} ({tb})")


# -----------------------------------------------------------------------------
# shrinking
# -----------------------------------------------------------------------------

def _copy(case: FuzzCase) -> FuzzCase:
    return case_from_json_dict(case_to_json_dict(case))


def _compress_stages(plan) -> None:
    used = sorted({lp.stage for lp in plan.layers.values()})
    remap = {s: i for i, s in enumerate(used)}
    for lp in plan.layers.values():
        lp.stage = remap[lp.stage]
    plan.n_stages = len(used)


def _shrink_candidates(case: FuzzCase) -> Iterator[FuzzCase]:
    """Simplified variants of ``case``, cheapest transformations first.
    Structurally invalid variants are silently skipped."""
    p, g = case.plan, case.graph
    # 1. unevict one stream (removes one eviction decision entirely)
    for i, s in enumerate(p.streams):
        if s.evicted:
            c = _copy(case)
            c.plan.streams[i].evicted = False
            c.plan.streams[i].codec = "none"
            yield c
    # 2. shallower stream: fewer microbatches
    if p.microbatch > 2:
        c = _copy(case)
        c.plan.microbatch = 2
        yield c
    # 3. merge each stage boundary
    for j in range(1, p.n_stages):
        c = _copy(case)
        for lp in c.plan.layers.values():
            if lp.stage >= j:
                lp.stage -= 1
        c.plan.n_stages -= 1
        yield c
    # 4. drop one input edge of a multi-input merge point
    for v in list(g.vertices()):
        if v.kind in ("add", "mul") and len(g.predecessors(v.name)) >= 2:
            for src in g.predecessors(v.name):
                try:
                    c = _copy(case)
                    c.graph.remove_edge(src, v.name)
                    c.graph.validate()
                    c.plan.streams = [s for s in c.plan.streams
                                      if (s.src, s.dst) != (src, v.name)]
                    c.plan.validate()
                except (ValueError, PlanValidationError):
                    continue
                yield c
    # 5. splice out one shape-preserving single-input layer
    for v in list(g.vertices()):
        spec = v.meta.get("exec", {})
        preserving = (v.kind in ("act", "dwconv")
                      or (v.kind == "conv"
                          and spec.get("cin") == spec.get("cout")))
        same_m = spec.get("m_out", spec.get("m")) == spec.get("m")
        if not (preserving and same_m
                and len(g.predecessors(v.name)) == 1):
            continue
        try:
            yield _drop_vertex(case, v.name)
        except (ValueError, PlanValidationError, KeyError):
            continue


def _drop_vertex(case: FuzzCase, name: str) -> FuzzCase:
    c = _copy(case)
    g, p = c.graph, c.plan
    pred = g.predecessors(name)[0]
    succs = g.successors(name)
    g.remove_vertex(name, reconnect=True)   # raises if not reconnectable
    g.validate()
    old = {(s.src, s.dst): s for s in p.streams}
    p.streams = [s for s in p.streams if name not in (s.src, s.dst)]
    for s2 in succs:                        # spliced edges keep their plan
        o = old.get((name, s2))
        if o is not None:
            p.streams.append(StreamPlan(pred, s2, o.evicted, o.codec))
    del p.layers[name]
    if name in p.topo_order:
        p.topo_order.remove(name)
    _compress_stages(p)
    p.validate()
    return c


def shrink(case: FuzzCase, violation: OracleViolation,
           fault: str | None = None, max_runs: int = 60, *,
           torch_device: str = "cuda"
           ) -> tuple[FuzzCase, OracleViolation, int]:
    """Greedy shrink: accept a candidate only while the *same* oracle
    still fails (a candidate that passes, fails differently, or is
    structurally invalid is rejected).  Returns the smallest failing
    case, its violation, and how many oracle runs the search spent."""
    target = violation.oracle
    best, best_v = case, violation
    runs = 0
    improved = True
    while improved and runs < max_runs:
        improved = False
        for cand in _shrink_candidates(best):
            if runs >= max_runs:
                break
            runs += 1
            v = run_case(cand, fault, torch_device=torch_device)
            if v is not None and v.oracle == target:
                best, best_v, improved = cand, v, True
                break                        # restart from the smaller case
    return best, best_v, runs


# -----------------------------------------------------------------------------
# repro files
# -----------------------------------------------------------------------------

def write_repro(out_dir, case: FuzzCase, violation: OracleViolation, *,
                fault: str | None = None,
                shrink_stats: dict | None = None) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "kind": REPRO_KIND,
        "version": REPRO_VERSION,
        "label": case.label,
        "seed": case.seed,
        "oracle": violation.oracle,
        "message": str(violation),
        "inject_fault": fault,
        "shrunk": shrink_stats or {},
        "case": case_to_json_dict(case),
    }
    stem = f"repro_{case.label}_{violation.oracle}"
    if fault:
        stem += f"_{fault}"
    path = out_dir / f"{stem}.json"
    path.write_text(json.dumps(payload, indent=1))
    return path


def load_repro(path) -> dict:
    d = json.loads(pathlib.Path(path).read_text())
    if d.get("kind") != REPRO_KIND:
        raise ValueError(f"{path}: not a {REPRO_KIND} file")
    if d.get("version", 0) > REPRO_VERSION:
        raise ValueError(f"{path}: repro version {d['version']} is newer "
                         f"than this harness (v{REPRO_VERSION})")
    return d


def replay(path, *, torch_device: str = "cuda") -> CaseReport:
    """Re-execute one repro file, honouring its recorded fault injection.
    Raises :class:`OracleViolation` while the bug (or planted fault)
    still reproduces; returns the passing :class:`CaseReport` once fixed."""
    d = load_repro(path)
    case = case_from_json_dict(d["case"])
    with inject_fault(d.get("inject_fault")):
        return check_case(case, torch_device=torch_device)


# -----------------------------------------------------------------------------
# CLI
# -----------------------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.fuzz",
        description="differential conformance fuzzer (see docs/TESTING.md)")
    ap.add_argument("--budget", type=int, default=50,
                    help="number of generated cases (default 50)")
    ap.add_argument("--seed", type=int, default=0,
                    help="population seed; (seed, index) fixes each case")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory for shrunk repro JSONs "
                         f"(default {DEFAULT_OUT})")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the cases run (default cuda)")
    ap.add_argument("--inject-fault", choices=FAULTS, default=None,
                    help="plant a known fault; the run must then FAIL "
                         "(harness self-test)")
    ap.add_argument("--keep-going", action="store_true",
                    help="keep fuzzing after a failure instead of stopping")
    ap.add_argument("--max-shrink-runs", type=int, default=60,
                    help="oracle-run budget for shrinking one failure")
    # population-bounding knobs (smaller => faster cases, e.g. in tests)
    ap.add_argument("--min-blocks", type=int, default=None)
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--max-stages", type=int, default=None)
    ap.add_argument("--max-microbatches", type=int, default=None)
    return ap


def _config_from_args(args) -> GenConfig:
    cfg = GenConfig()
    over = {k: getattr(args, k) for k in
            ("min_blocks", "max_blocks", "max_stages", "max_microbatches")
            if getattr(args, k) is not None}
    return dataclasses.replace(cfg, **over) if over else cfg


def fuzz(cfg: GenConfig, *, seed: int = 0, budget: int = 50,
         out=DEFAULT_OUT, fault: str | None = None,
         keep_going: bool = False, max_shrink_runs: int = 60,
         torch_device: str = "cuda") -> int:
    """Run ``budget`` cases of population ``(seed, cfg)``, shrinking and
    writing a repro for each violation (stopping at the first unless
    ``keep_going``); returns the number of violations."""
    failures = 0
    i = -1
    for i in range(budget):
        case = random_case(seed, i, cfg)
        v = run_case(case, fault, torch_device=torch_device)
        if v is None:
            # cheap progress stats without re-running the oracles
            n_v = len(list(case.graph.vertices()))
            n_e = sum(1 for s in case.plan.streams if s.evicted)
            print(f"case {case.label}: ok ({n_v} vertices, "
                  f"{case.plan.n_stages} stages, B{case.plan.microbatch}, "
                  f"{n_e} evicted)")
            continue
        failures += 1
        n0 = len(list(case.graph.vertices()))
        print(f"case {case.label}: FAIL {v}")
        small, sv, runs = shrink(case, v, fault, max_runs=max_shrink_runs,
                                 torch_device=torch_device)
        n1 = len(list(small.graph.vertices()))
        path = write_repro(
            out, small, sv, fault=fault,
            shrink_stats={"from_vertices": n0, "to_vertices": n1,
                          "runs": runs})
        print(f"  shrunk {n0} -> {n1} vertices "
              f"({len(small.plan.streams)} streams, "
              f"{small.plan.n_stages} stages) in {runs} runs")
        print(f"  repro written: {path}")
        print(f"  replay: python -c \"from repro_torch.testing.fuzz import "
              f"replay; replay('{path}', torch_device='{torch_device}')\"")
        if not keep_going:
            break
    verdict = "FAIL" if failures else "ok"
    print(f"fuzz: {verdict} — {failures} violation(s) in {i + 1} case(s) "
          f"(seed {seed}, {torch_device})")
    return failures


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    failures = fuzz(_config_from_args(args), seed=args.seed,
                    budget=args.budget, out=args.out,
                    fault=args.inject_fault, keep_going=args.keep_going,
                    max_shrink_runs=args.max_shrink_runs,
                    torch_device=args.torch_device)
    return 1 if failures else 0

if __name__ == "__main__":
    sys.exit(main())
