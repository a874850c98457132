"""MemoryModel: one plan's complete off-chip channel picture.

``build_memory_model`` assembles the subsystem for one lowered plan:

1. every spill record becomes an ``activation-evict`` stream at its
   producer stage and an ``activation-restore`` stream at its consumer
   stage (``bits_per_frame = SpillRecord.offchip_bits`` — the exact
   compile-time volume, so byte conservation against the
   ``StreamReport`` is bit-exact);
2. every stage with streamed weight bits registers one ``weight-fetch``
   stream;
3. the :class:`~repro_torch.memory.arbiter.ChannelArbiter` divides the channel
   for one steady-state tick (``tick_cycles = max_j L_j``, the
   uncontended Eq. 6 frame time — the tick the pipeline actually runs
   at when the channel is not the bottleneck);
4. per-stage transfer times ``X_j`` extend Eq. 5/6 to the contended
   ``L_j^cont = max(L_j, X_j)``, with ``max(0, X_j - L_j)`` the
   contention-stall cycles compute cannot hide;
5. the weight-fetch grants feed the double-buffered
   :func:`~repro_torch.memory.prefetch.prefetch_schedule`, whose deadline
   misses say which stage would stall on weights.

The resulting :class:`MemoryModel` travels on ``StreamReport.memory``
and is what ``obs.modelcheck.ContentionCheck``, the SLO layer's
per-stream budgets, autotune's feasibility pruning and the benchmark
columns all read.
"""
from __future__ import annotations

import dataclasses
import math

from .arbiter import (ArbiterReport, ChannelArbiter,
                      contended_stage_latencies, contention_stall_cycles)
from .channel import ChannelConfig, OffChipChannel
from .prefetch import PrefetchReport, prefetch_schedule

__all__ = ["MemoryModel", "build_memory_model"]


@dataclasses.dataclass
class MemoryModel:
    """The contended channel view of one plan (see module docstring)."""
    config: ChannelConfig
    channel: OffChipChannel
    arbitration: ArbiterReport
    prefetch: PrefetchReport
    base_latencies: list[float]          # L_j (Eq. 5/6 input, cycles)
    transfer_cycles: list[float]         # X_j per stage
    contended_latencies: list[float]     # max(L_j, X_j)
    stall_cycles: list[float]            # max(0, X_j - L_j)
    weight_bits_by_stage: dict[int, int]
    spill_evict_bits: int                # sum of evict stream volumes
    spill_restore_bits: int              # sum of restore stream volumes
    microbatches: int

    # -- the contended Eq. 5/6 ------------------------------------------------
    @property
    def tick_cycles(self) -> float:
        """The uncontended Eq. 6 tick the arbitration was solved for."""
        return self.arbitration.tick_cycles

    @property
    def eq5_cycles(self) -> float:
        return float(sum(self.base_latencies))

    @property
    def eq6_cycles(self) -> float:
        return float(max(self.base_latencies))

    @property
    def eq5_contended_cycles(self) -> float:
        return float(sum(self.contended_latencies))

    @property
    def eq6_contended_cycles(self) -> float:
        return float(max(self.contended_latencies))

    @property
    def contention_bound_stage(self) -> int:
        """The stage setting the contended Eq. 6 bound."""
        return max(range(len(self.contended_latencies)),
                   key=lambda j: self.contended_latencies[j])

    @property
    def total_stall_cycles(self) -> float:
        return float(sum(self.stall_cycles))

    def fps_bound_uncontended(self, s_per_cycle: float) -> float:
        """Eq. 6 throughput roofline at a seconds-per-cycle scale."""
        t = self.eq6_cycles * s_per_cycle
        return 1.0 / t if t > 0 else math.inf

    def fps_bound_contended(self, s_per_cycle: float) -> float:
        """Contended Eq. 6 roofline — <= the uncontended one, always."""
        t = self.eq6_contended_cycles * s_per_cycle
        return 1.0 / t if t > 0 else math.inf

    # -- downstream consumers -------------------------------------------------
    def budget_gbps_by_kind(self) -> dict[str, float]:
        """Per-kind granted bandwidth (the SLO per-stream budgets)."""
        return self.arbitration.granted_gbps_by_kind()

    def weight_rate_by_stage(self) -> dict[int, float]:
        """Granted weight-fetch rate per stage [bits/cycle]."""
        return _weight_rates(self.arbitration)

    def extra_queue_delay(self) -> dict[tuple[str, str], int]:
        """Per crossing edge, extra in-flight ticks its spill round-trip
        needs beyond one tick at the granted rates — the arbiter-derived
        crossing delay the queue capacity floors consume.  Capped at the
        microbatch count (a ring deeper than the stream is moot)."""
        per_edge: dict[tuple[str, str], float] = {}
        for s in self.arbitration.streams:
            if s.kind == "weight-fetch" or "->" not in s.name:
                continue
            edge = tuple(s.name.split(":", 1)[1].split("->", 1))
            per_edge[edge] = per_edge.get(edge, 0.0) + s.transfer_cycles
        out: dict[tuple[str, str], int] = {}
        for edge, cyc in per_edge.items():
            if not math.isfinite(cyc):
                out[edge] = self.microbatches
                continue
            extra = max(0, math.ceil(cyc / self.tick_cycles) - 1)
            out[edge] = min(extra, self.microbatches)
        return out

    def stream_table(self) -> list[dict]:
        """Flat per-stream rows (the examples' bandwidth table)."""
        return [{
            "name": s.name, "kind": s.kind, "stage": s.stage,
            "bits_per_frame": s.bits_per_frame, "bursts": s.bursts,
            "demand_gbps": s.demand_rate * self.channel.cycles_per_s / 1e9,
            "granted_gbps": s.granted_gbps,
            "satisfied": s.satisfied,
        } for s in self.arbitration.streams]

    def summary(self) -> dict:
        return {
            "policy": self.config.policy,
            "channel": self.channel.summary(),
            "arbitration": self.arbitration.summary(),
            "prefetch": self.prefetch.summary(),
            "transfer_cycles": list(self.transfer_cycles),
            "stall_cycles": list(self.stall_cycles),
            "eq6_cycles": self.eq6_cycles,
            "eq6_contended_cycles": self.eq6_contended_cycles,
            "eq5_contended_cycles": self.eq5_contended_cycles,
            "contention_bound_stage": self.contention_bound_stage,
            "feasible": self.arbitration.feasible,
            "spill_evict_bits": self.spill_evict_bits,
            "spill_restore_bits": self.spill_restore_bits,
            "streamed_weight_bits": sum(self.weight_bits_by_stage.values()),
            "prefetch_deadline_misses": self.prefetch.deadline_misses,
        }


def build_memory_model(*, spills, weight_bits_by_stage: dict[int, int],
                       stage_of: dict[str, int],
                       base_latencies: list[float],
                       gbps: float, freq_mhz: float,
                       config: ChannelConfig | None = None,
                       microbatches: int = 1) -> MemoryModel:
    """Assemble the channel/arbiter/prefetch model for one plan.

    spills
        ``SpillRecord``-likes (``src``/``dst``/``offchip_bits``); each
        contributes an evict stream at ``stage_of[src]`` and a restore
        stream at ``stage_of[dst]``.
    weight_bits_by_stage
        exact streamed weight bits per stage (see
        ``runtime.executor.analyze_plan``'s per-layer rounding).
    base_latencies
        the uncontended ``L_j`` in model cycles
        (``schedule.stage_latencies``); must be non-empty.
    """
    cfg = config or ChannelConfig()
    gbps = cfg.gbps if cfg.gbps is not None else gbps
    channel = OffChipChannel(gbps, freq_mhz=freq_mhz,
                             word_bits=cfg.word_bits)
    if not base_latencies:
        raise ValueError("need >= 1 stage latency")
    n_stages = len(base_latencies)
    tick_cycles = float(max(base_latencies))

    arb = ChannelArbiter(channel, cfg)
    for stage in sorted(weight_bits_by_stage):
        bits = int(weight_bits_by_stage[stage])
        if bits > 0:
            arb.register(f"weights:stage{stage}", "weight-fetch",
                         stage=stage, bits_per_frame=bits)
    evict_bits = restore_bits = 0
    for r in spills:
        bits = int(r.offchip_bits)
        arb.register(f"evict:{r.src}->{r.dst}", "activation-evict",
                     stage=stage_of[r.src], bits_per_frame=bits)
        arb.register(f"restore:{r.src}->{r.dst}", "activation-restore",
                     stage=stage_of[r.dst], bits_per_frame=bits)
        evict_bits += bits
        restore_bits += bits

    arbitration = arb.allocate(tick_cycles)
    transfer = arbitration.transfer_cycles_by_stage(n_stages)
    contended = contended_stage_latencies(list(base_latencies), transfer)
    stalls = contention_stall_cycles(list(base_latencies), transfer)
    pf = prefetch_schedule(
        {k: int(v) for k, v in weight_bits_by_stage.items()},
        _weight_rates(arbitration), tick_cycles=tick_cycles,
        microbatches=microbatches, channel=channel)
    return MemoryModel(
        config=cfg, channel=channel, arbitration=arbitration, prefetch=pf,
        base_latencies=list(base_latencies), transfer_cycles=transfer,
        contended_latencies=contended, stall_cycles=stalls,
        weight_bits_by_stage={int(k): int(v)
                              for k, v in weight_bits_by_stage.items()},
        spill_evict_bits=evict_bits, spill_restore_bits=restore_bits,
        microbatches=microbatches)


def _weight_rates(arbitration: ArbiterReport) -> dict[int, float]:
    out: dict[int, float] = {}
    for s in arbitration.streams:
        if s.kind == "weight-fetch":
            out[s.stage] = out.get(s.stage, 0.0) + s.granted_rate
    return out
