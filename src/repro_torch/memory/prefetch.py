"""Double-buffered weight prefetch scheduling with stage-start deadlines.

SMOF's weight fragmentation keeps a static fraction of each layer's
weights pinned on-chip and streams the rest from off-chip **every
frame**.  For the pipeline not to stall, stage ``j``'s streamed fragment
for microbatch ``b`` must be resident before the stage starts computing
``b`` — a hard deadline set by the 1F1B diagram (stage ``j`` runs
microbatch ``b`` at tick ``j + b``).

The prefetcher models the classic double-buffer: two weight slots per
stage, one being computed from while the other fills.  Per (stage,
microbatch) it emits one :class:`PrefetchSlot`:

* the **initial fill** (``b = 0``) may start one tick before the stream
  (the warmup tick every DMA pipeline gets), so its budget is
  ``(j + 1) * tick_cycles`` — deeper stages get more slack, exactly the
  fill-phase bubbles of the 1F1B schedule;
* every **steady slot** (``b >= 1``) starts when the previous microbatch
  starts computing and must land one tick later: budget =
  ``tick_cycles``.

A slot whose transfer (at the arbiter's granted rate, burst-quantised)
exceeds its budget is a **deadline miss** — the stage would stall on
weights.  Misses are counted, not failed: the contended latency model
already prices the slowdown; the miss count is the attribution ("which
stage's fragment is too big for its share").

``tick_cycles`` is injectable, so unit tests drive the deadline math
with a stub clock.  Like the rest of ``repro_torch.memory``, no JAX.
"""
from __future__ import annotations

import dataclasses
import math

from .channel import OffChipChannel

__all__ = ["PrefetchSlot", "PrefetchReport", "prefetch_schedule"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class PrefetchSlot:
    """One double-buffer fill: stage ``j``'s streamed fragment for one
    microbatch, with its start tick, deadline and cycle budget."""
    stage: int
    microbatch: int
    bits: int                 # streamed fragment volume (exact)
    quantized_bits: int       # burst-rounded (what the port moves)
    start_tick: int           # fetch may begin here (-1: warmup tick)
    deadline_tick: int        # stage-start tick of this microbatch
    budget_cycles: float      # (deadline - start) * tick_cycles
    transfer_cycles: float    # at the arbiter's granted rate

    @property
    def slack_cycles(self) -> float:
        """Budget minus transfer; negative slack is a miss."""
        return self.budget_cycles - self.transfer_cycles

    @property
    def missed(self) -> bool:
        return self.transfer_cycles > self.budget_cycles + _EPS

    def summary(self) -> dict:
        return dataclasses.asdict(self) | {
            "slack_cycles": self.slack_cycles,
            "missed": self.missed,
        }


@dataclasses.dataclass
class PrefetchReport:
    """The whole stream's prefetch schedule + deadline accounting."""
    slots: list[PrefetchSlot]
    tick_cycles: float

    @property
    def deadline_misses(self) -> int:
        return sum(1 for s in self.slots if s.missed)

    @property
    def worst_slack_cycles(self) -> float:
        """Most negative slack across slots (0.0 when no slots)."""
        return min((s.slack_cycles for s in self.slots), default=0.0)

    def misses_by_stage(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for s in self.slots:
            if s.missed:
                out[s.stage] = out.get(s.stage, 0) + 1
        return out

    def summary(self) -> dict:
        return {
            "n_slots": len(self.slots),
            "tick_cycles": self.tick_cycles,
            "deadline_misses": self.deadline_misses,
            "worst_slack_cycles": (self.worst_slack_cycles
                                   if math.isfinite(self.worst_slack_cycles)
                                   else None),
            "misses_by_stage": {str(k): v
                                for k, v in self.misses_by_stage().items()},
        }


def prefetch_schedule(weight_bits_by_stage: dict[int, int],
                      granted_rate_by_stage: dict[int, float], *,
                      tick_cycles: float, microbatches: int,
                      channel: OffChipChannel) -> PrefetchReport:
    """Build the double-buffered prefetch schedule for one stream run.

    weight_bits_by_stage
        exact streamed-fragment bits per stage (stages with 0 bits get no
        slots — their weights are fully static).
    granted_rate_by_stage
        the stage's weight-fetch stream rate from the arbiter
        [bits/cycle]; a starved stage (rate 0) gets infinite transfer
        time and misses every deadline.
    tick_cycles
        one pipeline tick in model cycles (Eq. 6's ``max_j L_j`` in
        production; a stub constant in unit tests).
    """
    if tick_cycles <= 0:
        raise ValueError(f"tick_cycles must be > 0, got {tick_cycles}")
    if microbatches < 1:
        raise ValueError(f"need >= 1 microbatch, got {microbatches}")
    slots: list[PrefetchSlot] = []
    for stage in sorted(weight_bits_by_stage):
        bits = int(weight_bits_by_stage[stage])
        if bits <= 0:
            continue
        rate = granted_rate_by_stage.get(stage, 0.0)
        xfer = channel.transfer_cycles(bits, rate)
        q = channel.quantized_bits(bits)
        for b in range(microbatches):
            start = -1 if b == 0 else stage + b - 1
            deadline = stage + b
            budget = (deadline - start) * tick_cycles
            slots.append(PrefetchSlot(
                stage=stage, microbatch=b, bits=bits, quantized_bits=q,
                start_tick=start, deadline_tick=deadline,
                budget_cycles=budget, transfer_cycles=xfer))
    return PrefetchReport(slots=slots, tick_cycles=tick_cycles)
