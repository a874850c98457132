"""The shared off-chip channel: burst-granular bandwidth accounting.

SMOF's eviction story assumes off-chip memory is *there* — Eq. 2 prices
each evicted stream's bandwidth, the device sheet caps the total — but
until this subsystem every stream enjoyed a private, infinite channel.
H2PIPE's measurement is that the shared HBM/DDR port is the first-order
effect: streams contend, and the channel moves data in DMA bursts, not
single words.

:class:`OffChipChannel` is the physical model everything else in
``repro_torch.memory`` prices against:

* capacity is ``Device.offchip_gbps`` converted to **bits per model
  cycle** at the device clock — the same cycle unit as the Eq. 5/6 stage
  latency model, so transfer times and compute latencies subtract
  directly;
* transactions are whole DMA bursts of ``DMA_FIFO_DEPTH`` words (the
  FIFO the paper sizes Eq. 1's ``d_b'`` from): a stream moving
  ``bits_per_frame`` bits pays for ``ceil(bits / burst_bits)`` bursts —
  small stripes round *up* to a burst, exactly the quantisation a DDR
  controller imposes;
* a pipeline tick of ``tick_cycles`` model cycles gives the channel a
  budget of ``bits_per_cycle * tick_cycles`` bits to move — the cycle
  budget the arbiter divides between streams.

:class:`ChannelConfig` is the user-facing knob set (policy + gbps
override) that travels on ``CompileSpec.channel`` and round-trips through
``Compiled.save``/``load`` with the same forward-compat policy as
``ObsConfig``: unknown keys from a newer writer are ignored.

This module is deliberately dependency-free (no JAX) so property tests
and the fuzz generator can drive it standalone.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.eviction import DMA_FIFO_DEPTH

__all__ = ["POLICIES", "ChannelConfig", "OffChipChannel"]

#: Arbitration policies the arbiter implements (see ``arbiter.py``).
POLICIES = ("round-robin", "fixed-priority", "weighted-fair")


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """User-facing channel knobs (``CompileSpec.channel``).

    ``policy`` picks the arbiter's sharing discipline; ``gbps`` overrides
    the device sheet's ``offchip_gbps`` (``None``: use the device);
    ``word_bits`` sets the burst word width (DMA bursts move
    ``DMA_FIFO_DEPTH`` such words).  The three ``*_weight`` fields are the
    weighted-fair shares per stream kind — ignored by the other policies.
    """
    policy: str = "round-robin"
    gbps: float | None = None
    word_bits: int = 16
    weight_fetch_weight: float = 1.0
    evict_weight: float = 1.0
    restore_weight: float = 1.0

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"unknown channel policy {self.policy!r}; "
                             f"pick one of {POLICIES}")
        if self.gbps is not None and self.gbps <= 0:
            raise ValueError(f"channel gbps must be > 0, got {self.gbps}")
        if self.word_bits < 1:
            raise ValueError(f"word_bits must be >= 1, got {self.word_bits}")
        for f in ("weight_fetch_weight", "evict_weight", "restore_weight"):
            if getattr(self, f) < 0:
                raise ValueError(
                    f"{f} must be >= 0, got {getattr(self, f)}")

    def kind_weight(self, kind: str) -> float:
        return {"weight-fetch": self.weight_fetch_weight,
                "activation-evict": self.evict_weight,
                "activation-restore": self.restore_weight}.get(kind, 1.0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChannelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class OffChipChannel:
    """One shared off-chip port, priced in model cycles and DMA bursts.

    gbps
        the port's raw bandwidth (``Device.offchip_gbps`` or the config's
        override).
    freq_mhz
        the device clock the Eq. 5/6 cycle counts are expressed in; the
        conversion ``bits_per_cycle = gbps * 1e9 / (freq_mhz * 1e6)``
        puts channel capacity and stage latency in the same unit.
    word_bits / fifo_depth
        one DMA burst moves ``fifo_depth`` words of ``word_bits`` each —
        the transaction granularity all transfers round up to.
    """

    def __init__(self, gbps: float, *, freq_mhz: float,
                 word_bits: int = 16,
                 fifo_depth: float = DMA_FIFO_DEPTH) -> None:
        if gbps <= 0 or freq_mhz <= 0:
            raise ValueError(f"need gbps > 0 and freq_mhz > 0, got "
                             f"{gbps=} {freq_mhz=}")
        self.gbps = float(gbps)
        self.freq_mhz = float(freq_mhz)
        self.word_bits = int(word_bits)
        self.fifo_depth = float(fifo_depth)

    @property
    def cycles_per_s(self) -> float:
        return self.freq_mhz * 1e6

    @property
    def bits_per_cycle(self) -> float:
        """Channel capacity per model cycle (the arbiter's budget unit)."""
        return self.gbps * 1e9 / self.cycles_per_s

    @property
    def burst_bits(self) -> int:
        """One DMA transaction: ``DMA_FIFO_DEPTH`` words."""
        return int(self.fifo_depth * self.word_bits)

    def n_bursts(self, bits: int) -> int:
        """Whole DMA bursts needed to move ``bits`` (0 bits -> 0 bursts)."""
        if bits <= 0:
            return 0
        return math.ceil(bits / self.burst_bits)

    def quantized_bits(self, bits: int) -> int:
        """``bits`` rounded up to whole bursts — what the port really moves."""
        return self.n_bursts(bits) * self.burst_bits

    def cycle_budget(self, tick_cycles: float) -> float:
        """Bits the channel can move during one ``tick_cycles`` tick."""
        return self.bits_per_cycle * max(tick_cycles, 0.0)

    def transfer_cycles(self, bits: int, rate_bits_per_cycle: float) -> float:
        """Model cycles to move ``bits`` (burst-quantised) at a granted
        rate; ``inf`` when the stream was starved (rate 0 but bits > 0)."""
        q = self.quantized_bits(bits)
        if q == 0:
            return 0.0
        if rate_bits_per_cycle <= 0:
            return math.inf
        return q / rate_bits_per_cycle

    def summary(self) -> dict:
        return {
            "gbps": self.gbps,
            "freq_mhz": self.freq_mhz,
            "bits_per_cycle": self.bits_per_cycle,
            "burst_bits": self.burst_bits,
        }
