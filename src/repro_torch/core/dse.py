"""Design Space Exploration (paper §IV-B, Algorithm 1).

Greedy, iterative optimisation of the per-vertex decision vector
``D_v = (s_i, s_o, p, a_i, a_o, m)`` to maximise throughput (Eq. 6) and
minimise latency (Eq. 5) under the device's on-chip resource and off-chip
bandwidth constraints (Eq. 7).  The five passes:

  1  resource-minimal initialisation — max partitions, min parallelism
  2  compute parallelism allocation  — speed up the slowest vertex
  3  on-chip memory allocation       — balance BRAM/URAM utilisation
  4  off-chip bandwidth allocation   — greedy by  L * delta_d / delta_BW
  5  partition merging               — merge when estimated perf improves
"""
from __future__ import annotations

import dataclasses
import math

from . import eviction, fragmentation
from .graph import Graph
from .partition import (Partitioning, fits, initial_partition, latency_s,
                        merge, subgraph_cost, throughput_fps)
from .resources import BRAM18K_BITS, URAM_BITS, Device


@dataclasses.dataclass
class DSEConfig:
    batch: int = 1
    codecs: tuple[str, ...] = ("none",)
    allow_eviction: bool = True
    allow_fragmentation: bool = True
    allow_merging: bool = True
    sparsity: float = 0.5            # calibration for c_bar (activations)
    alpha: float = 1.0               # read-order penalty (Eq. 2)
    frag_step: float = 0.125
    cut_kinds: tuple[str, ...] | None = None   # user partition-point filter
    max_iters: int = 400
    word_bits: int = 16


@dataclasses.dataclass
class DSEResult:
    partitioning: Partitioning
    throughput_fps: float
    latency_s: float
    history: list[dict]
    feasible: bool

    def summary(self) -> dict:
        g = self.partitioning.graph
        n_evicted = sum(1 for e in g.edges() if e.evicted)
        fragged = [(v.name, v.frag_ratio) for v in g.vertices() if v.frag_ratio > 0]
        return {
            "n_partitions": self.partitioning.n,
            "throughput_fps": self.throughput_fps,
            "latency_s": self.latency_s,
            "n_evicted_edges": n_evicted,
            "n_fragmented": len(fragged),
            "mean_frag_ratio": (sum(m for _, m in fragged) / len(fragged)) if fragged else 0.0,
            "feasible": self.feasible,
        }


def pack_onchip(weight_bits: float, buffer_bits: float, dev: Device) -> dict:
    """Pass 3 — balance BRAM/URAM utilisation (AMD devices).

    Weights prefer the deeper URAMs, buffers prefer BRAMs; overflow spills
    to the other type so the two utilisation ratios stay balanced.  Returns
    block counts and a feasibility flag.  Devices without discrete memory
    types (TPU views) pass through on total bits.
    """
    if dev.bram18k == 0 and dev.uram == 0:
        total = weight_bits + buffer_bits
        return {"feasible": total <= dev.onchip_bits, "bram": 0, "uram": 0,
                "util": total / max(dev.onchip_bits, 1.0)}
    uram_blocks = math.ceil(weight_bits / URAM_BITS) if dev.uram else 0
    bram_blocks = math.ceil(buffer_bits / BRAM18K_BITS)
    if uram_blocks > dev.uram:                      # spill weights to BRAM
        spill = (uram_blocks - dev.uram) * URAM_BITS
        uram_blocks = dev.uram
        bram_blocks += math.ceil(spill / BRAM18K_BITS)
    if dev.uram == 0:
        bram_blocks = math.ceil((weight_bits + buffer_bits) / BRAM18K_BITS)
    # balance: move weight blocks to URAM while BRAM util exceeds URAM util
    while (dev.uram and uram_blocks < dev.uram
           and bram_blocks / max(dev.bram18k, 1) > uram_blocks / dev.uram
           and bram_blocks >= URAM_BITS // BRAM18K_BITS):
        bram_blocks -= URAM_BITS // BRAM18K_BITS
        uram_blocks += 1
    return {
        "feasible": bram_blocks <= dev.bram18k and uram_blocks <= dev.uram,
        "bram": bram_blocks, "uram": uram_blocks,
        "util": max(bram_blocks / max(dev.bram18k, 1),
                    uram_blocks / max(dev.uram, 1)),
    }


def _snapshot(g: Graph) -> dict:
    """Capture all mutable design state (for candidate rollback)."""
    return {
        "v": {v.name: (v.par, v.frag_ratio, dict(v.meta)) for v in g.vertices()},
        "e": {(e.src, e.dst): (e.evicted, e.codec, e.buffer_depth) for e in g.edges()},
    }


def _restore(g: Graph, snap: dict) -> None:
    for v in g.vertices():
        v.par, v.frag_ratio, meta = snap["v"][v.name]
        v.meta = dict(meta)
    for e in g.edges():
        e.evicted, e.codec, e.buffer_depth = snap["e"][(e.src, e.dst)]


def _sg_feasible(p: Partitioning, i: int, dev: Device, cfg: DSEConfig) -> bool:
    c = subgraph_cost(p, i, sparsity=cfg.sparsity, alpha=cfg.alpha)
    if not fits(c, dev, word_bits=cfg.word_bits):
        return False
    sg = p.graph.subgraph(p.parts[i])
    pk = pack_onchip(fragmentation.onchip_weight_bits(sg),
                     eviction.onchip_buffer_bits(sg), dev)
    return bool(pk["feasible"])


def _alloc_off_chip(p: Partitioning, i: int, dev: Device, cfg: DSEConfig,
                    history: list[dict]) -> bool:
    """Pass 4 — spend off-chip bandwidth to free on-chip memory.

    Candidates from both mechanisms are pooled and applied best-merit-first
    (``L * delta_d / delta_BW``) until the subgraph fits or bandwidth runs
    out.  Returns True if the subgraph is feasible afterwards.
    """
    sg = p.graph.subgraph(p.parts[i])
    budget = dev.words_per_cycle_offchip(cfg.word_bits)
    for _ in range(200):
        if _sg_feasible(p, i, dev, cfg):
            return True
        cost = subgraph_cost(p, i, sparsity=cfg.sparsity, alpha=cfg.alpha)
        if (cost.bw_words_per_cycle > budget
                or cost.compute_units > dev.compute_units):
            # bandwidth / compute infeasibility cannot be bought back by
            # spending MORE off-chip bandwidth — bail out.
            return False
        cands: list[tuple[float, str, object]] = []
        if cfg.allow_eviction:
            for o in eviction.candidate_evictions(sg, codecs=cfg.codecs,
                                                  sparsity=cfg.sparsity,
                                                  alpha=cfg.alpha):
                cands.append((o.merit, "evict", o))
        if cfg.allow_fragmentation:
            for o in fragmentation.candidate_fragmentations(
                    sg, codecs=cfg.codecs, ratio_step=cfg.frag_step):
                cands.append((o.merit, "frag", o))
        if not cands:
            return False
        cands.sort(key=lambda t: t[0], reverse=True)
        affordable = [t for t in cands
                      if cost.bw_words_per_cycle + t[2].delta_bw_words_per_cycle <= budget]
        if not affordable:
            return False
        merit, kind, opt = affordable[0]
        if kind == "evict":
            eviction.apply_eviction(sg, opt)
        else:
            fragmentation.apply_fragmentation(sg, opt)
        history.append({"pass": 4, "part": i, "action": kind,
                        "target": getattr(opt, "vertex", getattr(opt, "edge", None)),
                        "merit": merit})
    return _sg_feasible(p, i, dev, cfg)


def _sg_feasible_relaxed(p: Partitioning, i: int, dev: Device,
                         cfg: DSEConfig) -> bool:
    """Compute + bandwidth constraints only (no on-chip memory check)."""
    c = subgraph_cost(p, i, sparsity=cfg.sparsity, alpha=cfg.alpha)
    return (c.compute_units <= dev.compute_units
            and c.bw_words_per_cycle <= dev.words_per_cycle_offchip(cfg.word_bits))


def _alloc_parallel(p: Partitioning, i: int, dev: Device, cfg: DSEConfig,
                    history: list[dict]) -> bool:
    """Pass 2 — raise parallelism of the slowest vertex while budgets allow.

    If the part's memory infeasibility cannot be fixed even by pass 4 (e.g.
    one conv's weights exceed the whole device and fragmentation is
    disabled), parallelism is still allocated under the compute/bandwidth
    budgets — the design stays flagged infeasible, but its throughput
    estimate remains meaningful for the ablation comparisons.
    """
    sg = p.graph.subgraph(p.parts[i])
    check = _sg_feasible
    if not (_sg_feasible(p, i, dev, cfg)
            or _alloc_off_chip(p, i, dev, cfg, history)):
        check = _sg_feasible_relaxed
    improved = False
    for _ in range(4096):
        verts = sorted(sg.vertices(), key=lambda v: v.latency(), reverse=True)
        moved = False
        for v in verts:
            if v.par >= v.max_par:
                continue
            used = sum(u.compute_units() for u in sg.vertices())
            headroom = dev.compute_units - used
            # try doubling; if that overshoots the budget, exact-fill with
            # whatever headroom remains (power-of-2-only wastes up to 2x)
            new_par = min(v.par * 2, v.max_par, v.par + int(headroom))
            extra = v.compute_units(new_par) - v.compute_units()
            if new_par <= v.par or extra > headroom:
                continue
            snap = _snapshot(p.graph)
            v.par = new_par
            if not (check(p, i, dev, cfg)
                    or _alloc_off_chip(p, i, dev, cfg, history)):
                _restore(p.graph, snap)
                continue
            history.append({"pass": 2, "part": i, "action": "par",
                            "vertex": v.name, "par": new_par})
            moved = improved = True
            break
        if not moved:
            break
    return improved


def run_dse(g: Graph, dev: Device, cfg: DSEConfig | None = None) -> DSEResult:
    """Algorithm 1."""
    cfg = cfg or DSEConfig()
    history: list[dict] = []
    for v in g.vertices():          # resource-minimal start
        v.par = v.min_par
        v.frag_ratio = 0.0
    for e in g.edges():
        e.evicted = False
        e.codec = "none"
    g.compute_buffer_depths()
    p = initial_partition(g, cut_kinds=cfg.cut_kinds)          # pass 1
    history.append({"pass": 1, "n_partitions": p.n})

    feasible = True
    for i in range(p.n):
        if not (_sg_feasible(p, i, dev, cfg)
                or _alloc_off_chip(p, i, dev, cfg, history)):
            feasible = False
        _alloc_parallel(p, i, dev, cfg, history)               # passes 2-4

    if cfg.allow_merging:                                      # pass 5
        for _ in range(cfg.max_iters):
            best: tuple[float, int, dict] | None = None
            cur = throughput_fps(p, dev, cfg.batch,
                                 sparsity=cfg.sparsity, alpha=cfg.alpha)
            for i in range(p.n - 1):
                snap = _snapshot(g)
                cand = merge(p, i)
                # the union shares one compute budget: restart its parallelism
                for name in cand.parts[i]:
                    g.vertex(name).par = g.vertex(name).min_par
                ok = (_sg_feasible(cand, i, dev, cfg)
                      or _alloc_off_chip(cand, i, dev, cfg, []))
                if ok:
                    _alloc_parallel(cand, i, dev, cfg, [])
                    thr = throughput_fps(cand, dev, cfg.batch,
                                         sparsity=cfg.sparsity, alpha=cfg.alpha)
                    if thr > cur and (best is None or thr > best[0]):
                        best = (thr, i, _snapshot(g))
                _restore(g, snap)
            if best is None:
                break
            thr, i, state = best
            p = merge(p, i)
            _restore(g, state)
            history.append({"pass": 5, "merged": i, "n_partitions": p.n,
                            "throughput": thr})

    thr = throughput_fps(p, dev, cfg.batch, sparsity=cfg.sparsity, alpha=cfg.alpha)
    lat = latency_s(p, dev, cfg.batch, sparsity=cfg.sparsity, alpha=cfg.alpha)
    feasible = feasible and all(_sg_feasible(p, i, dev, cfg) for i in range(p.n))
    return DSEResult(partitioning=p, throughput_fps=thr, latency_s=lat,
                     history=history, feasible=feasible)
