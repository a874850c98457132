"""Bounded inter-stage ring buffers for the spilled/encoded representation.

On hardware, an evicted stream crosses between pipeline stages through two
DMA-burst FIFOs of total depth ``d_b'`` (Eq. 1) plus an off-chip spill
region; the FIFOs are what lets the spill of microbatch ``b`` overlap with
compute on microbatch ``b`` instead of blocking the stage (the
memory-efficient dataflow queues of Petrica et al.).  Here each cross-stage
edge of a plan gets a :class:`RingBuffer` whose capacity *in microbatch
entries* derives from the same ``d_b'`` word budget — never below the two
DMA FIFOs' double buffer, and never below the edge's stage distance: a
``d``-stage crossing is executed as a depth-``d`` shift register in the
tick loop's carry, so any smaller ring would mis-model the buffer the
pipeline actually allocates.  The Python objects are used by
``schedule.simulate_schedule`` and ``obs.StreamTracer`` to account
occupancy and stalls, and (given a recorder) emit per-queue occupancy
counters and stall instants into the trace.
"""
from __future__ import annotations

import collections
import dataclasses
import math

from ...core.eviction import DMA_FIFO_DEPTH
from ...core.graph import Graph
from ...obs.trace import NULL_RECORDER


@dataclasses.dataclass(frozen=True)
class QueueSpec:
    """Sizing of one inter-stage queue.

    ``capacity_words`` is Eq. 1's ``d_b' = 2 * DMA_FIFO_DEPTH`` word budget;
    ``capacity`` is that budget expressed in whole microbatch entries,
    floored at 2 (the two DMA-burst FIFOs always double-buffer one entry in
    flight while the next is being encoded) and at ``delay`` (the executed
    shift-register depth for the crossing).
    """
    src: str
    dst: str
    words_per_entry: int          # one encoded microbatch stripe
    word_bits: int
    codec: str
    delay: int                    # consumer stage - producer stage (>= 1)
    capacity_words: float
    capacity: int

    @property
    def entry_bits(self) -> int:
        return self.words_per_entry * self.word_bits


class RingBuffer:
    """Bounded FIFO with occupancy high-water and stall accounting.

    ``push`` against a full ring and ``pop`` from an empty one are counted
    as stalls — the events that would backpressure (resp. starve) a
    hardware pipeline stage.  The push still lands (the accounting model
    must keep the schedule moving), so stall counts are diagnostics, not
    flow control; ``high_water`` saturates at ``capacity``, the most the
    modelled ring can physically hold.

    With a ``recorder``, every push/pop emits a ``queue:{name}:occupancy``
    counter sample and every stall a ``queue:{name}:push_stall`` /
    ``:pop_stall`` instant, timestamped by the caller's ``ts`` (the tick
    boundary) so the trace shows queue pressure against the stage spans.
    With a ``metrics`` registry, the same events additionally keep the
    per-edge ``smof_queue_occupancy`` gauge and
    ``smof_queue_{push,pop}_stalls_total`` counters current (the scrape
    view of the Eq. 1 invariant: stall totals should stay 0).
    """

    def __init__(self, capacity: int, *, name: str = "",
                 recorder=NULL_RECORDER, metrics=None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.name = name
        self.rec = recorder
        self._q: collections.deque = collections.deque()
        self.high_water = 0
        self.push_stalls = 0
        self.pop_stalls = 0
        self._m_occ = self._m_push = self._m_pop = None
        if metrics is not None:
            edge = name or "?"
            self._m_occ = metrics.gauge(
                "smof_queue_occupancy",
                "inter-stage ring occupancy (entries, Eq. 1-capped)",
                ("edge",)).labels(edge=edge)
            self._m_push = metrics.counter(
                "smof_queue_push_stalls_total",
                "pushes against a full inter-stage ring",
                ("edge",)).labels(edge=edge)
            self._m_pop = metrics.counter(
                "smof_queue_pop_stalls_total",
                "pops from an empty inter-stage ring",
                ("edge",)).labels(edge=edge)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def occupancy(self) -> int:
        return len(self._q)

    def _emit(self, ts: float | None, stall: str | None = None) -> None:
        if self._m_occ is not None:
            self._m_occ.set(min(len(self._q), self.capacity))
            if stall == "push_stall":
                self._m_push.inc()
            elif stall == "pop_stall":
                self._m_pop.inc()
        if not self.rec.enabled:
            return
        self.rec.counter(f"queue:{self.name}:occupancy",
                         min(len(self._q), self.capacity), ts,
                         track="queues")
        if stall is not None:
            self.rec.instant(f"queue:{self.name}:{stall}", ts,
                             track="queues")

    def push(self, item, ts: float | None = None) -> bool:
        """Append; returns False (and counts a stall) if the ring was full."""
        ok = len(self._q) < self.capacity
        if not ok:
            self.push_stalls += 1
        self._q.append(item)
        self.high_water = max(self.high_water,
                              min(len(self._q), self.capacity))
        self._emit(ts, None if ok else "push_stall")
        return ok

    def pop(self, ts: float | None = None):
        if not self._q:
            self.pop_stalls += 1
            self._emit(ts, "pop_stall")
            return None
        item = self._q.popleft()
        self._emit(ts)
        return item

    def stats(self) -> dict:
        return {"capacity": self.capacity, "occupancy": len(self._q),
                "high_water": self.high_water,
                "push_stalls": self.push_stalls,
                "pop_stalls": self.pop_stalls}


def queue_specs(g: Graph, stage_of: dict[str, int],
                out_shape: dict[str, tuple[int, int]],
                codec_of: dict[tuple[str, str], str] | None = None,
                fifo_depth: float = DMA_FIFO_DEPTH,
                extra_delay: dict[tuple[str, str], int] | None = None
                ) -> dict[tuple[str, str], QueueSpec]:
    """One :class:`QueueSpec` per stage-crossing edge of the plan.

    ``extra_delay`` adds per-edge in-flight entries on top of the stage
    distance — the arbiter-derived crossing delay from
    ``repro_torch.memory.MemoryModel.extra_queue_delay`` (a spill round-trip
    slower than one tick needs a deeper ring to keep the pipeline fed).
    """
    codec_of = codec_of or {}
    extra_delay = extra_delay or {}
    specs: dict[tuple[str, str], QueueSpec] = {}
    for e in g.edges():
        d = stage_of[e.dst] - stage_of[e.src]
        if d <= 0:
            continue
        m, c = out_shape[e.src]
        d_b_prime = 2.0 * fifo_depth                      # Eq. 1
        cap = max(2, d + extra_delay.get((e.src, e.dst), 0),
                  math.floor(d_b_prime / max(m * c, 1)))
        specs[(e.src, e.dst)] = QueueSpec(
            src=e.src, dst=e.dst, words_per_entry=m * c,
            word_bits=e.word_bits, codec=codec_of.get((e.src, e.dst), "none"),
            delay=d, capacity_words=d_b_prime, capacity=cap)
    return specs


def build_queues(specs: dict[tuple[str, str], QueueSpec],
                 recorder=NULL_RECORDER,
                 metrics=None) -> dict[tuple[str, str], RingBuffer]:
    return {e: RingBuffer(s.capacity, name=f"{s.src}->{s.dst}",
                          recorder=recorder, metrics=metrics)
            for e, s in specs.items()}
