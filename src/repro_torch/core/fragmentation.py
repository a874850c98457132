"""Weight fragmentation (paper §III-B, Eq. 3-4).

A weighty vertex's parameter memory of depth ``d`` is fragmented into a
static on-chip region and a dynamic region streamed from off-chip through a
shared time-multiplexed buffer, with fragmentation ratio ``m in [0,1]``:

  Eq. 3   delta_d  = m * d
  Eq. 4   delta_BW = m * r * c

``r`` is the rate at which the pipeline consumes weights (words/cycle) and
``c`` the compile-time-known weight compression ratio (weights are static,
so unlike activations there is no runtime variability and no read-order
penalty: the stream is sequential, alpha = 0).
"""
from __future__ import annotations

import dataclasses

from . import compression
from .graph import Graph, Vertex, WEIGHTY


@dataclasses.dataclass
class FragmentationOption:
    vertex: str
    ratio: float                    # proposed *additional* m
    codec: str
    delta_depth_words: float        # Eq. 3
    delta_bw_words_per_cycle: float # Eq. 4
    onchip_bits_saved: float
    lut_cost: float

    @property
    def merit(self) -> float:
        if self.delta_bw_words_per_cycle <= 0:
            return float("inf")
        return self.onchip_bits_saved / self.delta_bw_words_per_cycle


def weight_consumption_rate(v: Vertex) -> float:
    """Words/cycle at which the compute pipeline reads this vertex's weights.

    A fully-pipelined engine re-reads the whole weight set once per frame:
    r = weight_words / lambda_v.
    """
    return v.weight_words / max(v.latency(), 1.0)


def evaluate_fragmentation(g: Graph, name: str, ratio_step: float = 0.125,
                           codec: str = "none") -> FragmentationOption | None:
    v = g.vertex(name)
    if v.kind not in WEIGHTY or v.weight_words <= 0:
        return None
    new_m = min(v.frag_ratio + ratio_step, 1.0)
    step = new_m - v.frag_ratio
    if step <= 0:
        return None
    c = compression.estimate_ratio(codec, v.weight_bits, sparsity=0.3)
    r = weight_consumption_rate(v)
    delta_d = step * v.weight_words          # Eq. 3
    delta_bw = step * r * c                  # Eq. 4
    return FragmentationOption(
        vertex=name, ratio=step, codec=codec,
        delta_depth_words=delta_d,
        delta_bw_words_per_cycle=delta_bw,
        onchip_bits_saved=delta_d * v.weight_bits,
        lut_cost=compression.CODEC_LUT_COST[codec],
    )


def candidate_fragmentations(g: Graph, codecs: tuple[str, ...] = ("none",),
                             ratio_step: float = 0.125) -> list[FragmentationOption]:
    opts: list[FragmentationOption] = []
    for v in g.vertices():
        per_v = [o for c in codecs
                 if (o := evaluate_fragmentation(g, v.name, ratio_step, c)) is not None]
        if per_v:
            opts.append(max(per_v, key=lambda o: o.merit))
    opts.sort(key=lambda o: o.merit, reverse=True)
    return opts


def apply_fragmentation(g: Graph, opt: FragmentationOption) -> None:
    v = g.vertex(opt.vertex)
    v.frag_ratio = min(v.frag_ratio + opt.ratio, 1.0)
    v.meta["frag_codec"] = opt.codec


def onchip_weight_bits(g: Graph) -> float:
    return sum(v.static_weight_bits() for v in g.vertices())


def fragmentation_bw_words(g: Graph) -> float:
    """Aggregate Eq. 4 bandwidth (words/cycle) of all applied fragmentation."""
    total = 0.0
    for v in g.vertices():
        if v.frag_ratio > 0:
            codec = v.meta.get("frag_codec", "none")
            c = compression.estimate_ratio(codec, v.weight_bits, sparsity=0.3)
            total += weight_consumption_rate(v) * v.frag_ratio * c
    return total
