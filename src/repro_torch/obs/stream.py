"""Per-tick telemetry for the pipelined streamer: the StreamTracer.

One :class:`StreamTracer` narrates one pipelined run — executed
(``StreamingExecutor.run_traced`` walks real ticks and feeds wall
clock in) or simulated (``schedule.simulate_schedule`` walks the 1F1B
diagram in model time, one unit per tick).  Per tick it emits:

* a **tick span** on the ``pipeline`` track, categorised by the 1F1B
  phase (``fill`` / ``steady`` / ``drain``);
* one **stage span** per active stage on its own ``stage{j}`` track,
  named by the microbatch it processes — stages overlap within a tick,
  so stage spans share the tick's interval (that overlap *is* the
  pipeline diagram);
* **queue accounting** through the bounded rings (consumers pop before
  producers push, the double-buffer ordering of
  ``schedule.simulate_schedule``) with per-queue occupancy counters and
  stall instants;
* **spill counters** per crossing/evicted edge: bytes evicted where the
  producer stage runs, bytes restored where the consumer stage runs,
  plus BFP8 encode/decode counts — so ``bytes evicted == bytes
  restored`` per edge over any complete run is an emitted, testable
  invariant.

This module is deliberately dependency-free (duck-typed schedule, queues
and spill records), so property tests can drive it over randomly
generated plans.
"""
from __future__ import annotations

from .trace import NULL_RECORDER

__all__ = ["StreamTracer", "emit_spill_counters"]


def emit_spill_counters(recorder, record, *, ts: float | None = None,
                        evict: bool = True, restore: bool = True) -> None:
    """Count one microbatch's off-chip round-trip on one spilled edge.

    The executor's spill path runs on the device, so counting happens at the
    host-side boundary from the static :class:`SpillRecord` accounting —
    ``offchip_bits`` is what actually crosses (bit-exact for BFP8).  Both
    executors call this: the sequential one per frame, the streamer's
    tracer at producer/consumer ticks.
    """
    if not recorder.enabled:
        return
    edge = f"{record.src}->{record.dst}"
    nbytes = record.offchip_bits // 8
    if evict:
        recorder.incr(f"spill:{edge}:bytes_evicted", nbytes, ts)
        if record.codec == "bfp8":
            recorder.incr(f"bfp8:{edge}:encodes", 1, ts)
    if restore:
        recorder.incr(f"spill:{edge}:bytes_restored", nbytes, ts)
        if record.codec == "bfp8":
            recorder.incr(f"bfp8:{edge}:decodes", 1, ts)


class StreamTracer:
    """Drives span/counter emission for one pipelined run, tick by tick.

    Parameters are duck-typed on purpose:

    schedule
        a ``PipelineSchedule``: ``ticks``, ``phase(t)``,
        ``microbatch_at(stage, t)``, ``n_stages``, ``steady_ticks``.
    queues
        ``{(src, dst): RingBuffer}`` bounded rings (may be ``{}``); the
        tracer pops/pushes them per the schedule and emits occupancy
        counters plus stall instants.
    stage_of
        vertex -> stage map; resolves each queue edge's producer/consumer
        stage and attributes spill records to ticks.
    spill_records
        iterable of ``SpillRecord``-likes (``src``/``dst``/``codec``/
        ``offchip_bits``); cross-stage records count eviction at the
        producer's tick and restore at the consumer's, same-stage evicted
        records count both where their stage runs.
    """

    def __init__(self, recorder=NULL_RECORDER, schedule=None, *,
                 queues=None, stage_of=None, spill_records=(),
                 track_prefix: str = ""):
        if schedule is None:
            raise ValueError("StreamTracer needs a schedule")
        self.rec = recorder
        self.sched = schedule
        self.queues = dict(queues or {})
        self.stage_of = dict(stage_of or {})
        self.records = list(spill_records)
        self.prefix = track_prefix
        self.ticks_run = 0
        self.phase_counts = {"fill": 0, "steady": 0, "drain": 0}
        for (u, w) in self.queues:
            if u not in self.stage_of or w not in self.stage_of:
                raise ValueError(f"queue edge {(u, w)} missing from stage_of")

    # -- per-tick emission ----------------------------------------------------
    def tick(self, t: int, ts: float | None = None,
             dur: float = 1.0) -> None:
        """Account tick ``t``: spans, queue movement, spill counters.

        ``ts``/``dur`` are the tick's host wall-clock interval when the
        run is executed; simulation callers omit them and get model time
        (one unit per tick).
        """
        if ts is None:
            ts = float(t)
        phase = self.sched.phase(t)
        self.ticks_run += 1
        self.phase_counts[phase] += 1
        rec = self.rec
        end = ts + dur
        if rec.enabled:
            rec.add_span("tick", ts, dur, track=self.prefix + "pipeline",
                         cat=phase, args={"tick": t, "phase": phase})
            for j in self.sched.active_stages(t):
                b = self.sched.microbatch_at(j, t)
                rec.add_span(f"mb{b}", ts, dur,
                             track=self.prefix + f"stage{j}", cat=phase,
                             args={"tick": t, "stage": j, "microbatch": b})

        # queues: consumers pop first, then producers push — within a tick
        # the two ends act on different entries (the double buffer).  The
        # rings own their occupancy/stall emission (queues.py hooks).
        for (u, w), q in self.queues.items():
            if self.sched.microbatch_at(self.stage_of[w], t) is not None:
                q.pop(ts=end)
        for (u, w), q in self.queues.items():
            b = self.sched.microbatch_at(self.stage_of[u], t)
            if b is not None:
                q.push(b, ts=end)

        # spill traffic: evict at the producer's tick, restore at the
        # consumer's (same tick for same-stage evictions)
        for r in self.records:
            p, c = self.stage_of[r.src], self.stage_of[r.dst]
            emit_spill_counters(
                rec, r, ts=end,
                evict=self.sched.microbatch_at(p, t) is not None,
                restore=self.sched.microbatch_at(c, t) is not None)

    def run_model(self) -> dict:
        """Walk every tick in model time (no execution) and finish."""
        for t in range(self.sched.ticks):
            self.tick(t)
        return self.finish()

    def finish(self) -> dict:
        """Final accounting: per-queue stats, phase tick counts, totals."""
        return {
            "ticks_run": self.ticks_run,
            "phase_ticks": dict(self.phase_counts),
            "queues": {f"{u}->{w}": q.stats()
                       for (u, w), q in self.queues.items()},
            "counter_totals": self.rec.totals,
        }
