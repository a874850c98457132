"""Bandwidth arbitration over the shared off-chip channel.

Every per-frame off-chip flow of a plan registers as a *stream*:

``weight-fetch``
    one per stage with a streamed (non-static) weight fragment — the
    fragment is re-fetched every frame (SMOF's weight fragmentation);
``activation-evict`` / ``activation-restore``
    one pair per spill record: the producer stage writes the encoded
    stripe off-chip, the consumer stage reads it back (Eq. 2 traffic).

The arbiter divides the channel's per-cycle bit budget between the
registered streams under one of three policies:

``round-robin``
    equal-share water-filling: every stream gets the same rate until it
    is satisfied, leftover capacity re-divides among the still-hungry;
``fixed-priority``
    strict priority by stream kind (weight-fetch first — a late weight
    fragment stalls compute directly — then restore, then evict), grant
    order within a kind follows registration; low-priority streams can
    starve when the channel oversubscribes, which is the point;
``weighted-fair``
    water-filling with per-kind weights from :class:`ChannelConfig`.

Every policy is **work-conserving** (capacity is only left idle when all
demand is met), never grants a stream more than it asked for, and never
exceeds channel capacity — the hypothesis properties in
``tests/test_properties.py`` pin all three invariants.

From the allocation falls the **contended** extension of the Eq. 5/6
stage-latency model: stage ``j``'s streams need ``X_j = sum_s
quantized_bits_s / granted_rate_s`` model cycles of channel time per
frame; the DMA FIFOs double-buffer transfers behind compute, so

    L_j^cont = max(L_j, X_j)          (transfer hides behind compute,
                                       or compute hides behind transfer)

and Eq. 5/6 over ``L^cont`` give the contended sequential/pipelined
frame times.  ``max`` guarantees ``L^cont >= L`` pointwise, so the
contended bound can never beat the uncontended one — the ordering the
``ContentionCheck`` and the fuzz oracles gate on.
"""
from __future__ import annotations

import dataclasses
import math

from .channel import ChannelConfig, OffChipChannel

__all__ = ["STREAM_KINDS", "PRIORITY_ORDER", "StreamDemand",
           "StreamAllocation", "ArbiterReport", "ChannelArbiter",
           "contended_stage_latencies", "contention_stall_cycles"]

#: The three off-chip flow kinds a plan generates.
STREAM_KINDS = ("weight-fetch", "activation-evict", "activation-restore")

#: fixed-priority grant order: late weights stall compute directly, a
#: missing restore starves the consumer, an evict is buffered by the FIFO.
PRIORITY_ORDER = ("weight-fetch", "activation-restore", "activation-evict")

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class StreamDemand:
    """One registered off-chip stream (per-frame volume, exact bits)."""
    name: str
    kind: str
    stage: int
    bits_per_frame: int       # exact (SpillRecord.offchip_bits / weight sum)

    def __post_init__(self) -> None:
        if self.kind not in STREAM_KINDS:
            raise ValueError(f"unknown stream kind {self.kind!r}; "
                             f"pick one of {STREAM_KINDS}")
        if self.bits_per_frame < 0:
            raise ValueError(f"stream {self.name!r}: negative bits "
                             f"{self.bits_per_frame}")


@dataclasses.dataclass(frozen=True)
class StreamAllocation:
    """One stream's share of the channel after arbitration."""
    name: str
    kind: str
    stage: int
    bits_per_frame: int       # raw demand (exact)
    quantized_bits: int       # burst-rounded volume the port really moves
    bursts: int
    demand_rate: float        # quantized_bits / tick_cycles  [bits/cycle]
    granted_rate: float       # arbiter's grant               [bits/cycle]
    granted_gbps: float       # granted_rate at the device clock

    @property
    def satisfied(self) -> bool:
        return self.granted_rate >= self.demand_rate - _EPS

    @property
    def transfer_cycles(self) -> float:
        """Model cycles to move one frame's volume at the granted rate."""
        if self.quantized_bits == 0:
            return 0.0
        if self.granted_rate <= 0:
            return math.inf
        return self.quantized_bits / self.granted_rate

    def summary(self) -> dict:
        return dataclasses.asdict(self) | {
            "satisfied": self.satisfied,
            "transfer_cycles": self.transfer_cycles,
        }


def _water_fill(demands: list[float], weights: list[float],
                capacity: float) -> list[float]:
    """Weighted max-min fair allocation (water-filling).

    Repeatedly shares the remaining capacity in proportion to weight;
    streams whose demand falls below their share are granted exactly
    their demand and removed, freeing capacity for the rest.  Equal
    weights degrade to round-robin equal share.
    """
    n = len(demands)
    granted = [0.0] * n
    active = [i for i in range(n) if demands[i] > 0 and weights[i] > 0]
    cap = max(capacity, 0.0)
    while active and cap > _EPS:
        total_w = sum(weights[i] for i in active)
        share = cap / total_w
        sat = [i for i in active if demands[i] <= weights[i] * share + _EPS]
        if not sat:
            for i in active:
                granted[i] = weights[i] * share
            return granted
        for i in sat:
            granted[i] = demands[i]
            cap -= demands[i]
            active.remove(i)
    return granted


def _priority_fill(demands: list[float], order: list[int],
                   capacity: float) -> list[float]:
    """Strict-priority allocation: grant ``min(demand, remaining)`` in
    ``order``; later streams see only what is left (possibly nothing)."""
    granted = [0.0] * len(demands)
    cap = max(capacity, 0.0)
    for i in order:
        take = min(demands[i], cap)
        granted[i] = take
        cap -= take
    return granted


def _grant(policy: str, demands: list[float], weights: list[float],
           order: list[int], capacity: float) -> list[float]:
    """Dispatch one allocation round.  Module-level on purpose: the
    conformance harness's ``oversubscribe-channel`` fault monkeypatches
    this to skip the capacity cap, and the ``ContentionCheck`` /
    ``channel_model`` oracles must then catch the oversubscription."""
    if policy == "fixed-priority":
        return _priority_fill(demands, order, capacity)
    if policy == "round-robin":
        return _water_fill(demands, [1.0] * len(demands), capacity)
    if policy == "weighted-fair":
        return _water_fill(demands, weights, capacity)
    raise ValueError(f"unknown arbitration policy {policy!r}")


@dataclasses.dataclass
class ArbiterReport:
    """One arbitration round: per-stream grants + channel totals."""
    policy: str
    capacity_bits_per_cycle: float
    tick_cycles: float
    streams: list[StreamAllocation]

    @property
    def total_demand_rate(self) -> float:
        return sum(s.demand_rate for s in self.streams)

    @property
    def total_granted_rate(self) -> float:
        return sum(s.granted_rate for s in self.streams)

    @property
    def feasible(self) -> bool:
        """Aggregate demand fits the channel budget (no stream slowed)."""
        return self.total_demand_rate <= (self.capacity_bits_per_cycle
                                          * (1.0 + _EPS) + _EPS)

    @property
    def utilization(self) -> float:
        if self.capacity_bits_per_cycle <= 0:
            return 0.0
        return self.total_granted_rate / self.capacity_bits_per_cycle

    def by_kind(self) -> dict[str, list[StreamAllocation]]:
        out: dict[str, list[StreamAllocation]] = {k: [] for k in STREAM_KINDS}
        for s in self.streams:
            out[s.kind].append(s)
        return out

    def granted_gbps_by_kind(self) -> dict[str, float]:
        """Per-kind effective bandwidth — the SLO layer's per-stream
        budgets (what each direction was actually granted, not the flat
        device number)."""
        out = {k: 0.0 for k in STREAM_KINDS}
        for s in self.streams:
            out[s.kind] += s.granted_gbps
        return out

    def transfer_cycles_by_stage(self, n_stages: int) -> list[float]:
        """``X_j``: channel cycles stage ``j``'s streams need per frame."""
        out = [0.0] * n_stages
        for s in self.streams:
            if 0 <= s.stage < n_stages:
                out[s.stage] += s.transfer_cycles
        return out

    def bits_by_kind(self) -> dict[str, int]:
        """Exact per-frame bit volume per kind (conservation checks)."""
        out = {k: 0 for k in STREAM_KINDS}
        for s in self.streams:
            out[s.kind] += s.bits_per_frame
        return out

    def summary(self) -> dict:
        return {
            "policy": self.policy,
            "capacity_bits_per_cycle": self.capacity_bits_per_cycle,
            "tick_cycles": self.tick_cycles,
            "n_streams": len(self.streams),
            "total_demand_rate": self.total_demand_rate,
            "total_granted_rate": self.total_granted_rate,
            "feasible": self.feasible,
            "utilization": self.utilization,
            "granted_gbps_by_kind": self.granted_gbps_by_kind(),
            "streams": [s.summary() for s in self.streams],
        }


class ChannelArbiter:
    """Registers a plan's off-chip streams and divides the channel.

    Registration order is deterministic (callers register weight-fetch
    streams stage-ascending, then spills in record order) so allocations
    — including fixed-priority tie-breaks — are reproducible.
    """

    def __init__(self, channel: OffChipChannel,
                 config: ChannelConfig | None = None) -> None:
        self.channel = channel
        self.config = config or ChannelConfig()
        self._demands: list[StreamDemand] = []

    def register(self, name: str, kind: str, *, stage: int,
                 bits_per_frame: int) -> StreamDemand:
        d = StreamDemand(name=name, kind=kind, stage=stage,
                         bits_per_frame=int(bits_per_frame))
        self._demands.append(d)
        return d

    @property
    def demands(self) -> list[StreamDemand]:
        return list(self._demands)

    def allocate(self, tick_cycles: float) -> ArbiterReport:
        """Divide the channel for one steady-state tick of ``tick_cycles``
        model cycles: each stream demands ``quantized_bits /
        tick_cycles`` bits/cycle, the policy grants rates summing to at
        most the channel's ``bits_per_cycle``."""
        if tick_cycles <= 0:
            raise ValueError(f"tick_cycles must be > 0, got {tick_cycles}")
        ch, cfg = self.channel, self.config
        q = [ch.quantized_bits(d.bits_per_frame) for d in self._demands]
        demand = [qi / tick_cycles for qi in q]
        weights = [cfg.kind_weight(d.kind) for d in self._demands]
        prio = {k: i for i, k in enumerate(PRIORITY_ORDER)}
        order = sorted(range(len(self._demands)),
                       key=lambda i: (prio.get(self._demands[i].kind,
                                               len(prio)), i))
        granted = _grant(cfg.policy, demand, weights, order,
                         ch.bits_per_cycle)
        allocs = [
            StreamAllocation(
                name=d.name, kind=d.kind, stage=d.stage,
                bits_per_frame=d.bits_per_frame, quantized_bits=q[i],
                bursts=ch.n_bursts(d.bits_per_frame),
                demand_rate=demand[i],
                granted_rate=min(granted[i], demand[i]),
                granted_gbps=(min(granted[i], demand[i])
                              * ch.cycles_per_s / 1e9))
            for i, d in enumerate(self._demands)]
        return ArbiterReport(policy=cfg.policy,
                             capacity_bits_per_cycle=ch.bits_per_cycle,
                             tick_cycles=tick_cycles, streams=allocs)


# =============================================================================
# The contended Eq. 5/6 extension
# =============================================================================

def contended_stage_latencies(base: list[float],
                              transfer: list[float]) -> list[float]:
    """``L_j^cont = max(L_j, X_j)``: the DMA FIFOs overlap transfer with
    compute, so a stage pays whichever is longer, never the sum."""
    if len(base) != len(transfer):
        raise ValueError(f"{len(base)} stage latencies vs "
                         f"{len(transfer)} transfer times")
    return [max(l, x) for l, x in zip(base, transfer)]


def contention_stall_cycles(base: list[float],
                            transfer: list[float]) -> list[float]:
    """Per-stage cycles the pipeline stalls on the channel per frame:
    the part of ``X_j`` compute cannot hide (0 when transfer fits)."""
    if len(base) != len(transfer):
        raise ValueError(f"{len(base)} stage latencies vs "
                         f"{len(transfer)} transfer times")
    return [max(0.0, x - l) for l, x in zip(base, transfer)]
