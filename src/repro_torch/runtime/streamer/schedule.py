"""1F1B fill/steady/drain schedule and the per-stage latency model.

A plan with ``S`` stages processing ``B`` microbatches runs for
``T = B + S - 1`` ticks: tick ``t`` has stage ``j`` working on microbatch
``b = t - j`` whenever ``0 <= b < B``.  The first ``S - 1`` ticks are the
*fill* region (downstream stages idle), the last ``S - 1`` are the *drain*
(upstream stages idle), and everything between is *steady state* where all
stages overlap — H2PIPE's regime, where throughput is set by the slowest
stage:

  Eq. 5 (sequential)   t_frame = sum_j L_j      -> fps = 1 / sum_j(L_j)
  Eq. 6 (pipelined)    t_frame = max_j L_j      -> fps = 1 / max_j(L_j)

``stage_latencies`` provides ``L_j``: analytically (the stage subgraph's
initiation interval in cycles, the same model the DSE scores partitions
with) or through a user hook — e.g. measured per-stage wall-clock from
``pipeline.measured_stage_latencies`` — so the report and benchmarks can
place the *executed* throughput between the two estimates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from ...core.graph import Graph
from ...core.pipeline import initiation_interval
from ...core.plan import ExecutionPlan
from ...obs.stream import StreamTracer
from ...obs.trace import NULL_RECORDER


@dataclasses.dataclass(frozen=True)
class StageTask:
    """One (tick, stage, microbatch) cell of the pipeline diagram."""
    tick: int
    stage: int
    microbatch: int


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    n_stages: int
    n_microbatches: int

    def __post_init__(self) -> None:
        if self.n_stages < 1 or self.n_microbatches < 1:
            raise ValueError(
                f"need >= 1 stage and >= 1 microbatch, got "
                f"{self.n_stages} stages / {self.n_microbatches} microbatches")

    @property
    def ticks(self) -> int:
        return self.n_microbatches + self.n_stages - 1

    def microbatch_at(self, stage: int, tick: int) -> int | None:
        b = tick - stage
        return b if 0 <= b < self.n_microbatches else None

    def active_stages(self, tick: int) -> list[int]:
        return [j for j in range(self.n_stages)
                if self.microbatch_at(j, tick) is not None]

    def phase(self, tick: int) -> str:
        if tick < self.n_stages - 1:
            return "fill"
        if tick >= self.n_microbatches:
            return "drain"
        return "steady"

    # -- phase tick counts (the Eq. 6 regime is exactly the steady ticks) ----
    @property
    def fill_ticks(self) -> int:
        return min(self.n_stages - 1, self.ticks)

    @property
    def steady_ticks(self) -> int:
        return max(0, self.n_microbatches - self.n_stages + 1)

    @property
    def drain_ticks(self) -> int:
        return self.ticks - self.fill_ticks - self.steady_ticks

    def tasks(self) -> list[StageTask]:
        """All cells in tick order (stage-ascending within a tick)."""
        return [StageTask(t, j, self.microbatch_at(j, t))
                for t in range(self.ticks)
                for j in range(self.n_stages)
                if self.microbatch_at(j, t) is not None]

    # -- occupancy / stall accounting ---------------------------------------
    def stage_active_ticks(self, stage: int) -> int:
        return self.n_microbatches

    def stage_idle_ticks(self, stage: int) -> int:
        """Fill/drain bubbles seen by this stage (the 1F1B stall count)."""
        return self.ticks - self.n_microbatches

    def stage_occupancy(self, stage: int) -> float:
        return self.n_microbatches / self.ticks


def build_schedule(n_stages: int, n_microbatches: int) -> PipelineSchedule:
    return PipelineSchedule(n_stages=n_stages, n_microbatches=n_microbatches)


# =============================================================================
# Per-stage latency model (the hook Eq. 5/6 estimates are built from)
# =============================================================================

LatencyHook = Callable[[int, Graph], float]


def stage_latencies(g: Graph, plan: ExecutionPlan, *,
                    hook: LatencyHook | None = None) -> list[float]:
    """``L_j`` for every stage of ``plan`` over executable graph ``g``.

    Default model: the stage subgraph's initiation interval in cycles (the
    slowest vertex sets the stage's frame rate — the same model
    ``core.partition.subgraph_cost`` uses to score a partition).  ``hook``
    overrides it per stage: ``hook(stage_index, stage_subgraph) -> L_j`` in
    any consistent unit (cycles, seconds, ...).
    """
    n_stages = max((lp.stage for lp in plan.layers.values()), default=0) + 1
    out: list[float] = []
    for j in range(n_stages):
        names = plan.stage_layers(j)
        if not names:
            raise ValueError(f"stage {j} of plan {plan.model!r} is empty")
        sg = g.subgraph(names)
        out.append(hook(j, sg) if hook is not None
                   else initiation_interval(sg))
    return out


def eq5_sequential_time(latencies: Sequence[float]) -> float:
    """Eq. 5 frame time of the sequential schedule: the stage sum."""
    return float(sum(latencies))


def eq6_pipeline_time(latencies: Sequence[float]) -> float:
    """Eq. 6 steady-state frame time of the pipeline: the slowest stage."""
    return float(max(latencies))


def eq5_contended_time(latencies: Sequence[float],
                       transfer: Sequence[float]) -> float:
    """Eq. 5 over the contended stage latencies ``max(L_j, X_j)``, where
    ``X_j`` is stage ``j``'s off-chip transfer time from the channel
    arbiter (``repro_torch.memory``).  >= the uncontended Eq. 5, always."""
    from ...memory import contended_stage_latencies
    return eq5_sequential_time(
        contended_stage_latencies(list(latencies), list(transfer)))


def eq6_contended_time(latencies: Sequence[float],
                       transfer: Sequence[float]) -> float:
    """Eq. 6 over the contended stage latencies — the steady-state frame
    time when the shared off-chip channel, not compute, may set the
    bottleneck.  >= the uncontended Eq. 6, always."""
    from ...memory import contended_stage_latencies
    return eq6_pipeline_time(
        contended_stage_latencies(list(latencies), list(transfer)))


def simulate_schedule(schedule: PipelineSchedule,
                      queues: dict[tuple[str, str], "RingBuffer"],
                      producer_stage: dict[tuple[str, str], int],
                      consumer_stage: dict[tuple[str, str], int],
                      recorder=NULL_RECORDER) -> dict:
    """Walk the schedule through the bounded inter-stage queues.

    Producers push one (encoded) microbatch entry per active tick, consumers
    pop one (consumers first: a pop at tick ``t`` reads the entry pushed
    ``delay`` ticks earlier, so within a tick the two ends of a queue act on
    different entries — double buffering); the ring buffers record occupancy
    high-water marks and stall events (push against a full queue / pop from
    an empty one).  The stats show where Eq. 6's bottleneck sits: a queue
    that rides its capacity is the spill FIFO that would backpressure the
    pipeline on hardware.  With a ``recorder``, the walk also emits the full
    model-time trace (tick/stage spans, queue counters) via
    :class:`~repro_torch.obs.StreamTracer`.
    """
    stage_of: dict[str, int] = {}
    for (u, _w), s in producer_stage.items():
        stage_of[u] = s
    for (_u, w), s in consumer_stage.items():
        stage_of[w] = s
    tracer = StreamTracer(recorder, schedule, queues=queues,
                          stage_of=stage_of)
    for t in range(schedule.ticks):
        tracer.tick(t)
    per_queue = {e: q.stats() for e, q in queues.items()}
    return {
        "ticks": schedule.ticks,
        "stage_occupancy": [schedule.stage_occupancy(j)
                            for j in range(schedule.n_stages)],
        "stage_stalls": [schedule.stage_idle_ticks(j)
                         for j in range(schedule.n_stages)],
        "queues": per_queue,
    }
