"""ModelCheck: the paper's analytical models vs the measured pipeline.

SMOF's argument is analytical — Eq. 1 sizes the inter-stage buffers,
Eq. 5/6 predict frame time from per-stage latencies — and the telemetry
layer exists so those claims are *checkable* against a real run.  One
:class:`ModelCheck` compares, for one pipelined executor:

* **stage latencies** — the analytic per-stage ``L_j`` (initiation
  interval in cycles, the model the DSE ranks partitions with) against
  measured per-stage wall clock.  The two live in different units, so
  the check fits one through-origin scale ``s_per_cycle`` (exactly the
  autotuner's calibration regression) and reports the per-stage residual
  error — a stage whose measured share deviates is where the model is
  wrong;
* **schedule** — the measured tick count and steady-state tick count
  against the 1F1B diagram's ``T = B + S - 1`` / ``B - S + 1`` (the
  Eq. 6 regime is exactly the steady ticks);
* **queue depths** — each bounded ring's occupancy high-water mark and
  stall counts against its Eq. 1 capacity; a queue that stalls or rides
  its cap is mis-sized (the spill FIFO that would backpressure real
  hardware).

``check_stream`` builds one from a ``StreamReport``-like object plus the
measurements a traced run produced; ``Compiled.report()`` surfaces the
summary once ``Compiled.trace()`` has run.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["StageLatencyCheck", "QueueDepthCheck", "ContentionCheck",
           "ModelCheck", "check_stream", "check_contention"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class StageLatencyCheck:
    """One stage's predicted-vs-measured latency residual."""
    stage: int
    predicted_cycles: float        # analytic L_j (Eq. 5/6 input)
    measured_s: float | None       # per-stage wall clock (None: not measured)
    fitted_s: float | None         # predicted_cycles * s_per_cycle
    rel_err: float | None          # (measured - fitted) / fitted

    def summary(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class QueueDepthCheck:
    """One inter-stage ring vs its Eq. 1 capacity."""
    edge: str
    capacity: int
    high_water: int
    push_stalls: int
    pop_stalls: int

    @property
    def ok(self) -> bool:
        return (self.high_water <= self.capacity
                and self.push_stalls == 0 and self.pop_stalls == 0)

    def summary(self) -> dict:
        return dataclasses.asdict(self) | {"ok": self.ok}


@dataclasses.dataclass(frozen=True)
class ContentionCheck:
    """The off-chip channel model (``repro_torch.memory``) vs one plan's run.

    Gated invariants (deterministic, unit-free — they must hold whatever
    the host wall clock does):

    * ordering — every contended stage latency ``max(L_j, X_j)`` is >= its
      uncontended ``L_j``, hence contended Eq. 6 >= uncontended Eq. 6;
    * capacity — the arbiter's grants sum to at most the channel's
      bits-per-cycle budget, and no stream got more than it asked for
      (the invariant the planted ``oversubscribe-channel`` fault breaks);
    * conservation — the arbiter's per-kind bit totals equal the
      ``StreamReport``'s spill volumes and streamed weight bits exactly
      (integer equality, no tolerance).

    The measured chain (steady tick seconds <= contended bound <=
    uncontended bound at the fitted ``s_per_cycle`` scale) is *reported*
    — a fused CPU tick can legitimately beat the per-stage-dispatch
    model — and gated only by callers that control their measurement
    (the acceptance tests drive it with stub clocks).
    """
    eq6_cycles: float
    eq6_contended_cycles: float
    latency_ordering_ok: bool          # max(L, X) >= L pointwise
    capacity_ok: bool                  # sum(granted) <= capacity
    grants_bounded_ok: bool            # granted <= demand per stream
    evict_bits_ok: bool                # arbiter evict bits == report spills
    restore_bits_ok: bool
    weight_bits_ok: bool
    feasible: bool                     # total demand fits the channel
    stall_cycles_total: float
    prefetch_deadline_misses: int
    steady_tick_seconds: float | None  # measured (None: no traced run)
    eq6_seconds: float | None          # uncontended bound at s_per_cycle
    eq6_contended_seconds: float | None

    @property
    def bits_conserved(self) -> bool:
        return (self.evict_bits_ok and self.restore_bits_ok
                and self.weight_bits_ok)

    @property
    def measured_within_bounds(self) -> bool | None:
        """The throughput chain ``measured fps <= contended-Eq.6 fps <=
        uncontended-Eq.6 fps``, stated on frame time: the measured steady
        tick must take at least the contended bound's seconds (which are
        >= the uncontended bound's by the latency ordering).  ``None``
        without a measurement or a fitted scale."""
        if self.steady_tick_seconds is None or self.eq6_seconds is None:
            return None
        bound = self.eq6_contended_seconds
        if not math.isfinite(bound):
            # a starved stream (fixed-priority oversubscription) predicts
            # 0 fps — nothing finite to compare against
            return None
        return self.steady_tick_seconds >= bound * (1.0 - 1e-6) - _EPS

    @property
    def ok(self) -> bool:
        return (self.latency_ordering_ok and self.capacity_ok
                and self.grants_bounded_ok and self.bits_conserved)

    def violations(self) -> list[str]:
        out: list[str] = []
        if not self.latency_ordering_ok:
            out.append("contention: contended stage latency below the "
                       "uncontended L_j (max(L,X) ordering broken)")
        if not self.capacity_ok:
            out.append("contention: arbiter grants exceed channel "
                       "capacity (oversubscribed off-chip port)")
        if not self.grants_bounded_ok:
            out.append("contention: a stream was granted more bandwidth "
                       "than it demanded")
        if not self.evict_bits_ok:
            out.append("contention: evict stream bits != report spill "
                       "volume (byte conservation broken)")
        if not self.restore_bits_ok:
            out.append("contention: restore stream bits != report spill "
                       "volume (byte conservation broken)")
        if not self.weight_bits_ok:
            out.append("contention: weight-fetch stream bits != report "
                       "streamed_weight_bits (byte conservation broken)")
        return out

    def summary(self) -> dict:
        return dataclasses.asdict(self) | {
            "ok": self.ok,
            "bits_conserved": self.bits_conserved,
            "measured_within_bounds": self.measured_within_bounds,
        }


def check_contention(report, *, s_per_cycle: float = 0.0,
                     steady_tick_seconds: float | None = None
                     ) -> ContentionCheck | None:
    """Build the :class:`ContentionCheck` for a ``StreamReport`` carrying a
    ``repro_torch.memory.MemoryModel`` (``None`` when the plan was lowered
    without a channel config)."""
    mem = getattr(report, "memory", None)
    if mem is None:
        return None
    arb = mem.arbitration
    ordering = all(c >= l - _EPS for l, c in zip(mem.base_latencies,
                                                 mem.contended_latencies))
    capacity = (arb.total_granted_rate
                <= arb.capacity_bits_per_cycle * (1.0 + _EPS) + _EPS)
    bounded = all(s.granted_rate <= s.demand_rate + _EPS
                  for s in arb.streams)
    bits = arb.bits_by_kind()
    spill_bits = sum(int(r.offchip_bits) for r in report.spills)
    evict_ok = bits["activation-evict"] == spill_bits
    restore_ok = bits["activation-restore"] == spill_bits
    weight_ok = bits["weight-fetch"] == int(report.streamed_weight_bits)
    eq6_s = eq6c_s = None
    if s_per_cycle > 0:
        eq6_s = mem.eq6_cycles * s_per_cycle
        eq6c_s = (mem.eq6_contended_cycles * s_per_cycle
                  if math.isfinite(mem.eq6_contended_cycles) else math.inf)
    return ContentionCheck(
        eq6_cycles=mem.eq6_cycles,
        eq6_contended_cycles=mem.eq6_contended_cycles,
        latency_ordering_ok=ordering, capacity_ok=capacity,
        grants_bounded_ok=bounded, evict_bits_ok=evict_ok,
        restore_bits_ok=restore_ok, weight_bits_ok=weight_ok,
        feasible=arb.feasible,
        stall_cycles_total=mem.total_stall_cycles,
        prefetch_deadline_misses=mem.prefetch.deadline_misses,
        steady_tick_seconds=steady_tick_seconds,
        eq6_seconds=eq6_s, eq6_contended_seconds=eq6c_s)


@dataclasses.dataclass
class ModelCheck:
    """Measured-vs-model report for one pipelined run."""
    stages: list[StageLatencyCheck]
    queues: list[QueueDepthCheck]
    s_per_cycle: float             # fitted measured-seconds per analytic cycle
    ticks_predicted: int           # T = B + S - 1
    ticks_measured: int | None
    steady_predicted: int          # B - S + 1 (the Eq. 6 regime)
    steady_measured: int | None
    contention: ContentionCheck | None = None

    @property
    def ticks_ok(self) -> bool:
        return (self.ticks_measured is None
                or (self.ticks_measured == self.ticks_predicted
                    and self.steady_measured == self.steady_predicted))

    @property
    def queues_ok(self) -> bool:
        return all(q.ok for q in self.queues)

    @property
    def bottleneck_predicted(self) -> int:
        return max(range(len(self.stages)),
                   key=lambda j: self.stages[j].predicted_cycles)

    @property
    def bottleneck_measured(self) -> int | None:
        if any(s.measured_s is None for s in self.stages):
            return None
        return max(range(len(self.stages)),
                   key=lambda j: self.stages[j].measured_s)

    @property
    def bottleneck_agree(self) -> bool | None:
        m = self.bottleneck_measured
        return None if m is None else m == self.bottleneck_predicted

    @property
    def max_stage_rel_err(self) -> float | None:
        errs = [abs(s.rel_err) for s in self.stages if s.rel_err is not None]
        return max(errs) if errs else None

    @property
    def contention_ok(self) -> bool:
        """Channel-model invariants (vacuously true without a model)."""
        return self.contention is None or self.contention.ok

    @property
    def ok(self) -> bool:
        """Schedule walked as predicted, no queue is mis-sized, and the
        channel model (when present) holds its deterministic invariants.

        Stage-latency residuals are reported, not gated — wall clock on a
        shared host is noisy, and the residual's job is attribution."""
        return self.ticks_ok and self.queues_ok and self.contention_ok

    def violations(self) -> list[str]:
        """Every failed gated invariant, named — a conformance oracle
        attaches these to its failure reports so a fuzzed plan that breaks Eq. 1 / the 1F1B tick count says *which*
        queue or count broke, not just ``ok=False``."""
        out: list[str] = []
        if self.ticks_measured is not None:
            if self.ticks_measured != self.ticks_predicted:
                out.append(f"ticks: measured {self.ticks_measured} != "
                           f"predicted B+S-1 = {self.ticks_predicted}")
            if self.steady_measured != self.steady_predicted:
                out.append(f"steady ticks: measured {self.steady_measured} "
                           f"!= predicted B-S+1 = {self.steady_predicted}")
        for q in self.queues:
            if q.high_water > q.capacity:
                out.append(f"queue {q.edge}: high water {q.high_water} "
                           f"exceeds Eq.1 capacity {q.capacity}")
            if q.push_stalls or q.pop_stalls:
                out.append(f"queue {q.edge}: {q.push_stalls} push / "
                           f"{q.pop_stalls} pop stalls (Eq.1-sized rings "
                           f"must never stall)")
        if self.contention is not None:
            out.extend(self.contention.violations())
        return out

    def summary(self) -> dict:
        return {
            "ok": self.ok,
            "ticks_ok": self.ticks_ok,
            "queues_ok": self.queues_ok,
            "s_per_cycle": self.s_per_cycle,
            "ticks": {"predicted": self.ticks_predicted,
                      "measured": self.ticks_measured,
                      "steady_predicted": self.steady_predicted,
                      "steady_measured": self.steady_measured},
            "bottleneck": {"predicted": self.bottleneck_predicted,
                           "measured": self.bottleneck_measured,
                           "agree": self.bottleneck_agree},
            "max_stage_rel_err": self.max_stage_rel_err,
            "stages": [s.summary() for s in self.stages],
            "queues": [q.summary() for q in self.queues],
            "contention": (self.contention.summary()
                           if self.contention is not None else None),
        }


def check_stream(report, *, stage_seconds=None, queue_stats=None,
                 ticks_measured=None, steady_measured=None,
                 steady_tick_seconds=None) -> ModelCheck:
    """Build a :class:`ModelCheck` for one pipelined executor.

    report
        a ``StreamReport``-like: ``stage_latency`` (analytic cycles),
        ``n_stages``, ``microbatches``, ``ticks``, ``queue_stats``.
    stage_seconds
        measured per-stage wall clock (``measured_stage_latencies``), or
        ``None`` — latency checks then carry predictions only.
    queue_stats
        ``{edge: {capacity, high_water, push_stalls, pop_stalls}}`` from
        a traced run; defaults to the report's lowering-time simulation.
    ticks_measured / steady_measured
        tick counts a traced run actually walked (``None``: not run).
    steady_tick_seconds
        one measured steady-phase tick's wall clock (median), feeding the
        :class:`ContentionCheck`'s measured-vs-bound throughput chain.
    """
    pred = list(report.stage_latency)
    meas = list(stage_seconds) if stage_seconds is not None else None
    if meas is not None and len(meas) != len(pred):
        raise ValueError(f"{len(meas)} measured stages vs "
                         f"{len(pred)} predicted")
    # through-origin least squares: the calibration regression of
    # optim.autotune, one run's worth
    s_per_cycle = 0.0
    if meas is not None:
        denom = sum(p * p for p in pred)
        s_per_cycle = (sum(p * m for p, m in zip(pred, meas)) / denom
                       if denom else 0.0)
    stages = []
    for j, p in enumerate(pred):
        m = meas[j] if meas is not None else None
        fitted = p * s_per_cycle if meas is not None else None
        err = ((m - fitted) / fitted
               if fitted else None)
        stages.append(StageLatencyCheck(stage=j, predicted_cycles=p,
                                        measured_s=m, fitted_s=fitted,
                                        rel_err=err))
    qs = queue_stats if queue_stats is not None else report.queue_stats
    queues = [QueueDepthCheck(edge=e, capacity=st["capacity"],
                              high_water=st["high_water"],
                              push_stalls=st["push_stalls"],
                              pop_stalls=st["pop_stalls"])
              for e, st in sorted(qs.items())]
    S, B = report.n_stages, report.microbatches
    contention = check_contention(report, s_per_cycle=s_per_cycle,
                                  steady_tick_seconds=steady_tick_seconds)
    return ModelCheck(
        stages=stages, queues=queues, s_per_cycle=s_per_cycle,
        ticks_predicted=B + S - 1, ticks_measured=ticks_measured,
        steady_predicted=max(0, B - S + 1), steady_measured=steady_measured,
        contention=contention)
