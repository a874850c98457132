"""Closed-loop DSE autotuner: measure plans through the pipelined streamer.

``core.dse.run_dse`` ranks designs with the *analytical* Eq. 5/Eq. 6 stage
latency model — cycles at the device's nominal frequency.  H2PIPE's lesson
(arXiv 2408.09209) is that such a search is only trustworthy once the
latency model is calibrated against the real pipeline.  This module closes
that loop:

1. **seed** — Algorithm 1 produces the default plan (the baseline);
2. **perturb** — SA-style moves mutate the plan genome, mirroring the
   knobs ``run_dse``'s allocator owns: stage split points
   (split / merge), the eviction edge set (evict / unevict, deep-buffer
   edges first, codec per ``AutotuneConfig.codecs``), per-layer weight
   fragmentation ratios (frag, ±``frag_step``), and, on the card's kernel
   route, the kernels' row and channel tiles (tile);
3. **measure** — every candidate is lowered by
   ``runtime.streamer.lower_plan_pipelined`` on ``cfg.torch_device`` and
   executed on a real microbatch stream; steady-state fps is recorded per
   candidate (plus per-stage latencies for accepted ones, as a
   diagnostic).  On the card both are CUDA-event times;
4. **calibrate** — in steady state one pipeline tick costs the slowest
   stage (Eq. 6), so a least-squares fit of each candidate's measured
   seconds-per-frame against its analytic ``eq6`` cycles yields
   ``s_per_cycle``, turning the ``schedule.stage_latencies`` model into a
   calibrated predictor (:func:`calibrated_latency_hook`); the
   :class:`CalibrationReport` quantifies prediction error before/after;
5. **re-rank** — the trajectory carries predicted-vs-measured fps per
   candidate, and the best *measured* plan wins (the seed is candidate 0,
   so the winner is never worse than the default DSE plan).

The port's copy of the reference package's ``optim/autotune.py``: the same
names, record fields, moves and random draws, so under one stub clock both
search the same trajectory.  Measurement is injectable (``measure_fps`` /
``measure_stages``) so tests can drive the whole loop with a deterministic
stub clock.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import random
import time
from typing import Callable

import torch

from ..core.builders import exec_input_shape
from ..core.dse import DSEConfig, run_dse
from ..core.graph import Graph
from ..core.pipeline import initiation_interval
from ..core.plan import ExecutionPlan, LayerPlan, StreamPlan, plan_from_dse
from ..core.resources import Device
from ..kernels.streaming_conv import TILE_BC_CHOICES, TILE_BM_CHOICES
from ..memory import ChannelConfig, build_memory_model
from ..obs.trace import NULL_RECORDER
from ..runtime.executor import (WEIGHT_KINDS, analyze_plan,
                                resolve_kernel_mode)
from ..runtime.streamer import (StreamingExecutor, eq5_sequential_time,
                                eq6_pipeline_time, lower_plan_pipelined,
                                measured_stage_latencies, stage_latencies,
                                stage_weight_bits)

MOVES = ("split", "merge", "evict", "unevict", "frag", "tile")


@dataclasses.dataclass
class AutotuneConfig:
    """Knobs of the measured-in-the-loop search.

    ``n_candidates`` counts *evaluated* plans including the seed; every
    candidate costs one pipelined lowering plus measurement, so smoke
    configs keep it small.  ``dse`` configures the seed plan's Algorithm 1
    run (default: eviction+fragmentation-friendly settings at 16-bit
    words).  ``torch_device`` is where every candidate runs (``"cuda"`` by
    default, as ``CompileSpec.torch_device``); the CPU runs only when asked
    for.
    """
    n_candidates: int = 12
    microbatches: int = 8
    seed: int = 0
    init_temperature: float = 0.2     # SA temperature, relative fps units
    cooling: float = 0.85
    codecs: tuple[str, ...] = ("bfp8",)
    frag_step: float = 0.125
    min_static_fraction: float = 0.25
    max_stages: int = 6
    repeats: int = 3
    warmup: int = 1
    kernel_mode: str = "auto"
    dse: DSEConfig | None = None
    #: opt-in off-chip channel model: candidates whose aggregate stream
    #: demand oversubscribes the channel are *pruned* (recorded with
    #: ``pruned=True``, fps 0, never lowered or measured), and the
    #: trajectory carries the contended Eq. 6 ranking alongside the
    #: uncontended one.
    channel: ChannelConfig | None = None
    torch_device: str = "cuda"


@dataclasses.dataclass
class CandidateRecord:
    """Predicted-vs-measured bookkeeping for one evaluated plan."""
    index: int
    move: str                  # "seed" or the SA move that produced it
    accepted: bool             # became the SA current point
    n_stages: int
    n_evicted: int
    n_fragged: int
    fps_measured: float        # steady-state frames/s through the streamer
    eq5_cycles: float          # analytic sequential frame time (cycles)
    eq6_cycles: float          # analytic slowest-stage frame time (cycles)
    stage_cycles: list[float]  # analytic L_j
    # measured L_j, stage-by-stage dispatch — a per-stage diagnostic
    # recorded for accepted candidates only (dispatch overhead the
    # pipeline amortises makes it unsuitable for the tick fit)
    stage_seconds: list[float] = dataclasses.field(default_factory=list)
    fps_eq6_pre: float = 0.0   # Eq. 6 at nominal frequency (uncalibrated)
    fps_eq6_cal: float = 0.0   # Eq. 6 with the fitted s_per_cycle
    best_so_far: bool = False
    # channel-model fields (cfg.channel set): contended Eq. 6 frame time,
    # whether aggregate stream demand fits the channel, and whether the
    # candidate was pruned before lowering (infeasible -> never measured)
    eq6_contended_cycles: float = 0.0
    feasible: bool = True
    pruned: bool = False

    @property
    def bottleneck_stage(self) -> int:
        """The stage setting Eq. 6's ``max_j(L_j)`` for this candidate —
        the attribution the search is otherwise blind to."""
        return max(range(len(self.stage_cycles)),
                   key=lambda j: self.stage_cycles[j])


@dataclasses.dataclass
class CalibrationReport:
    """Fit of the analytic stage-latency model to measured tick times.

    In steady state one pipeline tick costs the slowest stage — Eq. 6 —
    so ``s_per_cycle`` is the least-squares (through-origin) scale mapping
    each candidate's analytic ``eq6_cycles`` to its *measured* per-frame
    (per-tick) seconds through the streamer.  ``pre_err`` / ``post_err``
    are ``|log(t_pred / t_meas)|`` of the winning plan's Eq. 6 frame time
    before calibration (cycles at ``freq_mhz``) and after (cycles x
    ``s_per_cycle``); the closed loop is working when
    ``post_err < pre_err``.
    """
    s_per_cycle: float
    n_points: int
    freq_mhz: float
    pre_err: float
    post_err: float

    @property
    def improved(self) -> bool:
        return self.post_err < self.pre_err

    def summary(self) -> dict:
        return dataclasses.asdict(self) | {"improved": self.improved}


@dataclasses.dataclass
class AutotuneResult:
    model: str
    device: str
    best_plan: ExecutionPlan
    best_fps: float            # measured, pipelined
    baseline_fps: float        # measured fps of the seed (default DSE) plan
    trajectory: list[CandidateRecord]
    calibration: CalibrationReport
    microbatches: int
    recorder: object = None    # obs recorder the search narrated into

    def summary(self) -> dict:
        return {
            "model": self.model,
            "device": self.device,
            "candidates": len(self.trajectory),
            "microbatches": self.microbatches,
            "baseline_fps": self.baseline_fps,
            "best_fps": self.best_fps,
            "speedup": self.best_fps / max(self.baseline_fps, 1e-30),
            "best_n_stages": self.best_plan.n_stages,
            "best_evicted": sum(1 for s in self.best_plan.streams if s.evicted),
            "best_fragged": sum(1 for lp in self.best_plan.layers.values()
                                if lp.weight_static_fraction < 1.0),
            "calibration": self.calibration.summary(),
        }

    def trajectory_rows(self) -> list[dict]:
        """Flat per-candidate rows (the trajectory JSON schema)."""
        return [{
            "candidate": r.index, "move": r.move, "accepted": r.accepted,
            "best_so_far": r.best_so_far, "n_stages": r.n_stages,
            "evicted": r.n_evicted, "fragged": r.n_fragged,
            "fps_measured": r.fps_measured, "fps_eq6_pre": r.fps_eq6_pre,
            "fps_eq6_cal": r.fps_eq6_cal,
            "bottleneck_stage": r.bottleneck_stage,
            "eq6_contended_cycles": r.eq6_contended_cycles,
            "feasible": r.feasible, "pruned": r.pruned,
        } for r in self.trajectory]

    def to_json(self) -> str:
        return json.dumps({
            "summary": self.summary(),
            "trajectory": self.trajectory_rows(),
            "best_plan": json.loads(self.best_plan.to_json()),
        }, indent=1)


# =============================================================================
# Measurement hooks (injectable — tests stub these for determinism)
# =============================================================================

def measure_pipelined_fps(sx: StreamingExecutor, xs: torch.Tensor, *,
                          repeats: int = 3, warmup: int = 1) -> float:
    """Steady-state frames/s of one pipelined executor.

    Best-of-N time of the whole stream, normalised by the schedule's tick
    count ``T = B + S - 1`` rather than by ``B``: the run includes the
    fill/drain bubbles, but in steady state the pipeline retires one frame
    per tick, so ``T / time`` is the steady-state rate.  Dividing by ``B``
    instead would charge the S-1 bubble ticks to the frames and bias any
    cross-plan comparison against deeper pipelines.

    On a CUDA device the stream is timed by CUDA events recorded on the
    current stream of the executor's device around ``sx(xs)``, then
    synchronised (a ring's stage streams start after the first event, and
    the second waits on them); on the CPU by the host clock.
    """
    on_cuda = sx.device.type == "cuda"

    def once() -> float:
        if on_cuda:
            cur = torch.cuda.current_stream(sx.device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(cur)
            sx(xs)
            b.record(cur)
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        sx(xs)
        return time.perf_counter() - t0

    for _ in range(warmup):
        once()
    best = math.inf
    for _ in range(repeats):
        best = min(best, once())
    return sx.report.ticks / best


def calibrated_latency_hook(s_per_cycle: float):
    """A ``schedule.stage_latencies`` hook predicting measured *seconds*:
    the analytic initiation interval scaled by the fitted ``s_per_cycle``."""
    return lambda j, sg: s_per_cycle * initiation_interval(sg)


# =============================================================================
# Plan genome: the mutable decision vector the SA moves act on
# =============================================================================

@dataclasses.dataclass
class _Genome:
    bounds: list[int]                       # topo indices starting stages 1..
    evict: dict[tuple[str, str], str]       # edge -> codec
    frac: dict[str, float]                  # layer -> static weight fraction
    tile_bm: int = 0                        # kernel row block (0 = default)
    tile_bc: int = 0                        # kernel out-channel block

    def clone(self) -> "_Genome":
        return _Genome(list(self.bounds), dict(self.evict), dict(self.frac),
                       self.tile_bm, self.tile_bc)


def _genome_from_plan(plan: ExecutionPlan, topo: list[str]) -> _Genome:
    # stages must be contiguous along topo order; normalise with a cummax
    # so any valid plan (producers never after consumers) maps cleanly
    bounds, cur = [], 0
    for i, n in enumerate(topo):
        s = max(plan.layers[n].stage, cur)
        if s > cur:
            bounds.append(i)
            cur = s
    evict = {(s.src, s.dst): s.codec for s in plan.streams if s.evicted}
    frac = {n: lp.weight_static_fraction for n, lp in plan.layers.items()
            if lp.weight_static_fraction < 1.0}
    return _Genome(bounds=bounds, evict=evict, frac=frac,
                   tile_bm=plan.tile_bm, tile_bc=plan.tile_bc)


def _plan_from_genome(g: Graph, topo: list[str], genome: _Genome, *,
                      model: str, device: str,
                      microbatch: int) -> ExecutionPlan:
    bounds = sorted(genome.bounds)
    layers = {}
    for i, n in enumerate(topo):
        layers[n] = LayerPlan(
            name=n, stage=bisect.bisect_right(bounds, i),
            weight_static_fraction=genome.frac.get(n, 1.0))
    streams = [StreamPlan(e.src, e.dst,
                          evicted=(e.src, e.dst) in genome.evict,
                          codec=genome.evict.get((e.src, e.dst), "none"))
               for e in g.edges()]
    return ExecutionPlan(model=model, device=device,
                         n_stages=len(bounds) + 1, layers=layers,
                         streams=streams, microbatch=microbatch,
                         topo_order=topo, tile_bm=genome.tile_bm,
                         tile_bc=genome.tile_bc)


def _propose(genome: _Genome, g: Graph, topo: list[str],
             deep_edges: list[tuple[str, str]], weighty: list[str],
             rng: random.Random, cfg: AutotuneConfig, *,
             tile_moves: bool = False) -> tuple[_Genome, str] | None:
    """One SA move on a clone of ``genome``; None when no move applies.

    ``tile_moves`` gates the "tile" move: the tile genes only reach the
    CUDA kernels, so proposing them where the search runs the plain
    versions would measure pure noise."""
    moves = [m for m in MOVES if tile_moves or m != "tile"]
    rng.shuffle(moves)
    for move in moves:
        cand = genome.clone()
        if move == "split" and len(cand.bounds) + 1 < cfg.max_stages:
            options = [i for i in range(1, len(topo))
                       if i not in cand.bounds]
            if options:
                cand.bounds = sorted(cand.bounds + [rng.choice(options)])
                return cand, move
        elif move == "merge" and cand.bounds:
            cand.bounds.remove(rng.choice(cand.bounds))
            return cand, move
        elif move == "evict":
            options = [e for e in deep_edges if e not in cand.evict]
            if options:
                cand.evict[rng.choice(options)] = rng.choice(cfg.codecs)
                return cand, move
        elif move == "unevict" and cand.evict:
            del cand.evict[rng.choice(sorted(cand.evict))]
            return cand, move
        elif move == "frag" and weighty:
            name = rng.choice(weighty)
            cur = cand.frac.get(name, 1.0)
            new = min(1.0, max(cfg.min_static_fraction,
                               cur + rng.choice((-1, 1)) * cfg.frag_step))
            if new != cur:
                if new >= 1.0:
                    cand.frac.pop(name, None)
                else:
                    cand.frac[name] = new
                return cand, move
        elif move == "tile":
            if rng.random() < 0.5:
                options = [b for b in TILE_BM_CHOICES if b != cand.tile_bm]
                cand.tile_bm = rng.choice(options)
            else:
                options = [b for b in TILE_BC_CHOICES if b != cand.tile_bc]
                cand.tile_bc = rng.choice(options)
            return cand, move
    return None


# =============================================================================
# The autotuner
# =============================================================================

def autotune(g: Graph, dev: Device, cfg: AutotuneConfig | None = None, *,
             measure_fps: Callable[[StreamingExecutor, torch.Tensor], float]
             | None = None,
             measure_stages: Callable[[StreamingExecutor, torch.Tensor],
                                      list[float]] | None = None,
             recorder=NULL_RECORDER, metrics=None) -> AutotuneResult:
    """Measured-in-the-loop plan search over executable graph ``g``.

    The seed candidate is the default DSE plan (``run_dse`` under
    ``cfg.dse``); subsequent candidates are SA perturbations of the plan
    genome, each *executed* through the pipelined streamer on a
    ``cfg.microbatches``-deep stream on ``cfg.torch_device``.  Returns the
    best measured plan, the full predicted-vs-measured trajectory, and the
    latency-model calibration fitted from every measured stage.  Each
    candidate's executor (weights on the device, pinned host slots for its
    hops) is released before the next one is lowered; the winner is kept
    as a plan, which the caller lowers again.

    ``recorder`` (an ``obs`` recorder) narrates the search: one span per
    candidate on the ``autotune`` track, carrying the move, acceptance,
    measured fps and the bottleneck-stage attribution.  ``metrics`` (a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`) keeps live
    per-candidate accounting: ``smof_autotune_candidates_total`` by
    acceptance plus baseline/best-fps and calibration gauges.
    """
    cfg = cfg or AutotuneConfig()
    rng = random.Random(cfg.seed)
    m_cand = m_best = m_baseline = m_spc = None
    if metrics is not None:
        m_cand = metrics.counter(
            "smof_autotune_candidates_total",
            "evaluated SA candidates, by acceptance", ("accepted",))
        m_best = metrics.gauge(
            "smof_autotune_best_fps", "best measured pipelined fps so far")
        m_baseline = metrics.gauge(
            "smof_autotune_baseline_fps",
            "measured fps of the seed (default DSE) plan")
        m_spc = metrics.gauge(
            "smof_autotune_s_per_cycle",
            "calibrated seconds per model cycle (through-origin fit)")
    measure_fps = measure_fps or (
        lambda sx, xs: measure_pipelined_fps(sx, xs, repeats=cfg.repeats,
                                             warmup=cfg.warmup))
    measure_stages = measure_stages or (
        lambda sx, x: measured_stage_latencies(sx, x, repeats=cfg.repeats,
                                               warmup=cfg.warmup))

    # -- seed: the default DSE plan ------------------------------------------
    dse_cfg = cfg.dse or DSEConfig(batch=1, codecs=("none",) + cfg.codecs,
                                   word_bits=16, cut_kinds=("pool", "conv"))
    res = run_dse(g, dev, dse_cfg)
    seed_plan = plan_from_dse(g.name, dev.name, res,
                              microbatch=cfg.microbatches)
    topo = g.topo()
    genome = _genome_from_plan(seed_plan, topo)

    g.compute_buffer_depths()
    in_out = {n for n in topo if g.vertex(n).kind in ("input", "output")}
    ranked = sorted((e for e in g.edges()
                     if e.src not in in_out and e.dst not in in_out),
                    key=lambda e: e.buffer_depth, reverse=True)
    deep_edges = [(e.src, e.dst) for e in ranked[:max(len(ranked) // 2, 1)]]
    weighty = [n for n in topo if g.vertex(n).kind in WEIGHT_KINDS]
    # tile genes reach only the CUDA kernels: proposed exactly when the
    # search takes the kernel route on the card (the CPU's kernel route
    # runs the plain versions, which have no tiles)
    device = torch.device(cfg.torch_device)
    tile_moves = (resolve_kernel_mode(cfg.kernel_mode, device)
                  and device.type == "cuda")

    # the measured stream: one seeded frame repeated B times (a stride-0
    # view, which the streamer reads one (m, c) frame at a time).  Its
    # values are not the reference's jax.random draws; no result of the
    # search depends on them
    in_shape = exec_input_shape(g)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    x = torch.randn(in_shape, generator=gen, device=device)
    xs = x.expand((cfg.microbatches,) + in_shape)

    def channel_view(plan: ExecutionPlan) -> tuple[bool, float]:
        """(feasible, contended eq6 cycles) under ``cfg.channel`` — from
        the analytic models only, no lowering, so pruning an infeasible
        candidate costs a plan analysis instead of a lowering."""
        if cfg.channel is None:
            return True, 0.0
        an = analyze_plan(g, plan, use_kernels=False)
        mem = build_memory_model(
            spills=an.spills,
            weight_bits_by_stage=stage_weight_bits(g, an),
            stage_of=an.stage_of,
            base_latencies=stage_latencies(g, plan),
            gbps=dev.offchip_gbps, freq_mhz=dev.freq_mhz,
            config=cfg.channel, microbatches=cfg.microbatches)
        return mem.arbitration.feasible, mem.eq6_contended_cycles

    def evaluate(genome: _Genome, index: int, move: str, *,
                 prune: bool = True
                 ) -> tuple[CandidateRecord, ExecutionPlan,
                            StreamingExecutor | None]:
        plan = _plan_from_genome(g, topo, genome, model=g.name,
                                 device=dev.name,
                                 microbatch=cfg.microbatches)
        feasible, eq6c = channel_view(plan)
        cyc = stage_latencies(g, plan)               # analytic, cycles
        rec = CandidateRecord(
            index=index, move=move, accepted=False,
            n_stages=plan.n_stages,
            n_evicted=sum(1 for s in plan.streams if s.evicted),
            n_fragged=sum(1 for lp in plan.layers.values()
                          if lp.weight_static_fraction < 1.0),
            fps_measured=0.0,
            eq5_cycles=eq5_sequential_time(cyc),
            eq6_cycles=eq6_pipeline_time(cyc),
            stage_cycles=list(cyc),
            eq6_contended_cycles=eq6c, feasible=feasible)
        if prune and not feasible:
            rec.pruned = True
            if recorder.enabled:
                recorder.instant(f"prune:{move}", track="autotune",
                                 args={"candidate": index,
                                       "eq6_contended_cycles": eq6c})
            return rec, plan, None
        with recorder.span(f"candidate{index}", track="autotune", cat=move,
                           args={"candidate": index, "move": move}) as sa:
            sx = lower_plan_pipelined(g, plan, microbatches=cfg.microbatches,
                                      kernel_mode=cfg.kernel_mode,
                                      channel=cfg.channel, channel_device=dev,
                                      device=device)
            rec.fps_measured = measure_fps(sx, xs)
            sa.update({"fps_measured": rec.fps_measured,
                       "n_stages": rec.n_stages,
                       "bottleneck_stage": rec.bottleneck_stage})
        return rec, plan, sx

    trajectory: list[CandidateRecord] = []
    # the seed is always measured (prune=False): it anchors the baseline
    # fps, and an infeasible-but-measured seed is strictly better than no
    # plan at all — only *moves away* from it get pruned
    rec, plan, sx = evaluate(genome, 0, "seed", prune=False)
    rec.accepted = rec.best_so_far = True
    rec.stage_seconds = list(measure_stages(sx, x))
    del sx
    trajectory.append(rec)
    baseline_fps = cur_fps = best_fps = rec.fps_measured
    best_plan, best_rec = plan, rec
    if m_cand is not None:
        m_cand.labels(accepted="true").inc()
        m_baseline.set(baseline_fps)
        m_best.set(best_fps)

    temp = cfg.init_temperature
    for i in range(1, cfg.n_candidates):
        prop = _propose(genome, g, topo, deep_edges, weighty, rng, cfg,
                        tile_moves=tile_moves)
        if prop is None:
            break
        cand, move = prop
        rec, plan, sx = evaluate(cand, i, move)
        if rec.pruned:
            # bandwidth-infeasible: recorded, never accepted, never best
            trajectory.append(rec)
            if m_cand is not None:
                m_cand.labels(accepted="false").inc()
            temp *= cfg.cooling
            continue
        delta = (rec.fps_measured - cur_fps) / max(cur_fps, 1e-30)
        accept = delta >= 0 or rng.random() < math.exp(delta / max(temp, 1e-9))
        if accept:
            genome, cur_fps = cand, rec.fps_measured
            rec.accepted = True
            rec.stage_seconds = list(measure_stages(sx, x))
        # this candidate's weights and pinned slots go before the next
        # lowering: the search holds one executor at a time
        del sx
        if recorder.enabled:
            recorder.instant(f"{'accept' if accept else 'reject'}:{move}",
                             track="autotune",
                             args={"candidate": i,
                                   "fps_measured": rec.fps_measured})
        if m_cand is not None:
            m_cand.labels(accepted="true" if accept else "false").inc()
        if rec.fps_measured > best_fps:
            best_fps, best_plan, best_rec = rec.fps_measured, plan, rec
            rec.best_so_far = True
            if m_best is not None:
                m_best.set(best_fps)
        trajectory.append(rec)
        temp *= cfg.cooling

    # -- calibrate the latency model against measured tick times -------------
    # steady-state tick time == Eq. 6 slowest-stage time, so each candidate
    # contributes one (analytic eq6 cycles, measured seconds/frame) point
    pts = [(r.eq6_cycles, 1.0 / r.fps_measured) for r in trajectory
           if r.eq6_cycles > 0 and r.fps_measured > 0]
    denom = sum(a * a for a, _ in pts)
    s_per_cycle = (sum(a * m for a, m in pts) / denom) if denom else 0.0
    if m_spc is not None:
        m_spc.set(s_per_cycle)
    nominal = 1.0 / (dev.freq_mhz * 1e6)
    for r in trajectory:
        r.fps_eq6_pre = 1.0 / (r.eq6_cycles * nominal)
        # with a channel model the ranking estimate is the *contended*
        # Eq. 6 — the channel, not compute, may set the bottleneck
        eff = (max(r.eq6_contended_cycles, r.eq6_cycles)
               if cfg.channel is not None else r.eq6_cycles)
        if s_per_cycle > 0 and math.isfinite(eff) and eff > 0:
            r.fps_eq6_cal = 1.0 / (eff * s_per_cycle)

    t_meas = 1.0 / best_rec.fps_measured
    pre_err = abs(math.log((best_rec.eq6_cycles * nominal) / t_meas))
    post_err = (abs(math.log((best_rec.eq6_cycles * s_per_cycle) / t_meas))
                if s_per_cycle > 0 else math.inf)
    calib = CalibrationReport(s_per_cycle=s_per_cycle, n_points=len(pts),
                              freq_mhz=dev.freq_mhz, pre_err=pre_err,
                              post_err=post_err)

    best_plan.est_throughput_fps = best_rec.fps_eq6_cal
    best_plan.est_latency_s = best_rec.eq5_cycles * (s_per_cycle or nominal)
    return AutotuneResult(model=g.name, device=dev.name, best_plan=best_plan,
                          best_fps=best_fps, baseline_fps=baseline_fps,
                          trajectory=trajectory, calibration=calib,
                          microbatches=cfg.microbatches,
                          recorder=recorder if recorder.enabled else None)


# =============================================================================
# CLI entry point — routed through the compile façade (repro_torch.api)
# =============================================================================

def main(argv: list[str] | None = None) -> None:
    """``python -m repro_torch.optim.autotune``: closed-loop search via the
    façade.  Compiles ``strategy="autotune"`` and prints the summary; with
    ``--save`` the winning design lands as a versioned ``Compiled``
    artifact any fresh process can ``repro_torch.Compiled.load`` and serve.
    The search runs on ``--torch-device`` (the card by default) with
    ``--kernel-mode``."""
    import argparse

    from ..api import add_compile_args, compile as smof_compile, \
        spec_from_args
    from ..core.builders import EXEC_MODELS
    from ..obs.trace import ObsConfig

    ap = argparse.ArgumentParser(prog="repro_torch.optim.autotune")
    # "reference" is plan-free — nothing to autotune — so it is not offered
    add_compile_args(ap, models=EXEC_MODELS, default_model="unet_exec",
                     default_mode="pipelined",
                     modes=("staged", "pipelined"))
    ap.add_argument("--candidates", type=int, default=12,
                    help="evaluated plans incl. the seed")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the AutotuneResult trajectory as JSON")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="save the compiled winner as a Compiled artifact")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace of the search (one span per "
                         "candidate, with bottleneck-stage attribution)")
    args = ap.parse_args(argv)

    cfg = AutotuneConfig(n_candidates=args.candidates,
                         microbatches=args.microbatches, seed=args.seed,
                         kernel_mode=args.kernel_mode,
                         torch_device=args.torch_device)
    compiled = smof_compile(spec_from_args(
        args, strategy="autotune", autotune_cfg=cfg, seed=args.seed,
        microbatches=args.microbatches,
        obs=ObsConfig(enabled=args.trace is not None,
                      trace_path=args.trace)))
    res = compiled.autotune_result
    print(json.dumps(res.summary(), indent=1))
    if args.json:
        with open(args.json, "w") as f:
            f.write(res.to_json())
    if args.trace and res.recorder is not None:
        print(f"trace: {res.recorder.save(args.trace)}")
    if args.save:
        print(f"saved: {compiled.save(args.save)}")


if __name__ == "__main__":
    main()
