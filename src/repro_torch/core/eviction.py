"""Activation eviction (paper §III-A, Eq. 1-2).

A deep on-chip buffer of depth ``d_b`` on an edge is replaced by two small
DMA-burst FIFOs of total depth ``d_b'`` plus an off-chip spill region.  The
saving and cost:

  Eq. 1   delta_d = d_b - d_b'     valid iff d_b > max(d_b', t_db)
  Eq. 2   delta_BW = r * c_bar * (1 + alpha)

``r`` is the stream's average data rate (words/cycle), ``c_bar`` the average
compression ratio of the chosen codec, and ``alpha >= 1`` penalises the read
bandwidth when the read order differs from the write order (random access).
"""
from __future__ import annotations

import dataclasses

from . import compression
from .graph import Graph

# Two DMA-burst FIFOs; sized for a 64-beat burst each (words).
DMA_FIFO_DEPTH = 128.0
# DMA round-trip delay ``t_db`` in cycles (queue + DDR/PCIe latency).
DMA_DELAY_CYCLES = 256.0


@dataclasses.dataclass
class EvictionOption:
    """One candidate eviction with its Eq. 1/2 terms."""
    edge: tuple[str, str]
    codec: str
    delta_depth_words: float        # Eq. 1 (in words)
    delta_bw_words_per_cycle: float # Eq. 2 (words/cycle, read+write)
    onchip_bits_saved: float        # L * delta_d
    lut_cost: float
    feasible: bool

    @property
    def merit(self) -> float:
        """The DSE ordering heuristic ``L * delta_d / delta_BW`` (§IV-B pass 4)."""
        if self.delta_bw_words_per_cycle <= 0:
            return float("inf")
        return self.onchip_bits_saved / self.delta_bw_words_per_cycle


def evaluate_eviction(g: Graph, src: str, dst: str, codec: str = "none",
                      sparsity: float = 0.5, alpha: float = 1.0,
                      fifo_depth: float = DMA_FIFO_DEPTH,
                      dma_delay: float = DMA_DELAY_CYCLES) -> EvictionOption:
    """Evaluate evicting the (src, dst) stream to off-chip memory."""
    e = g.edge(src, dst)
    sv = g.vertex(src)
    d_b = e.buffer_depth
    d_b_prime = 2.0 * fifo_depth
    feasible = d_b > max(d_b_prime, dma_delay)          # Eq. 1 constraint
    delta_d = max(d_b - d_b_prime, 0.0)
    c_bar = compression.estimate_ratio(codec, e.word_bits, sparsity=sparsity)
    r = sv.rate_out()
    delta_bw = r * c_bar * (1.0 + alpha)                # Eq. 2
    return EvictionOption(
        edge=(src, dst), codec=codec,
        delta_depth_words=delta_d,
        delta_bw_words_per_cycle=delta_bw,
        onchip_bits_saved=delta_d * e.word_bits,
        lut_cost=compression.CODEC_LUT_COST[codec] * 2,  # encode + decode
        feasible=feasible,
    )


def candidate_evictions(g: Graph, codecs: tuple[str, ...] = ("none",),
                        sparsity: float = 0.5, alpha: float = 1.0) -> list[EvictionOption]:
    """All feasible evictions on all edges, best codec per edge first."""
    opts: list[EvictionOption] = []
    for e in g.edges():
        if e.evicted:
            continue
        per_edge = [evaluate_eviction(g, e.src, e.dst, codec=c,
                                      sparsity=sparsity, alpha=alpha)
                    for c in codecs]
        per_edge = [o for o in per_edge if o.feasible and o.delta_depth_words > 0]
        if per_edge:
            opts.append(max(per_edge, key=lambda o: o.merit))
    opts.sort(key=lambda o: o.merit, reverse=True)
    return opts


def apply_eviction(g: Graph, opt: EvictionOption,
                   fifo_depth: float = DMA_FIFO_DEPTH) -> None:
    e = g.edge(*opt.edge)
    e.evicted = True
    e.codec = opt.codec
    e.buffer_depth = 2.0 * fifo_depth


def onchip_buffer_bits(g: Graph) -> float:
    """Total on-chip FIFO storage currently required by the graph's edges."""
    return sum(e.buffer_depth * e.word_bits for e in g.edges())


def eviction_bw_words(g: Graph, sparsity: float = 0.5, alpha: float = 1.0) -> float:
    """Aggregate Eq. 2 bandwidth (words/cycle) of all applied evictions."""
    total = 0.0
    for e in g.edges():
        if e.evicted:
            c_bar = compression.estimate_ratio(e.codec, e.word_bits, sparsity=sparsity)
            total += g.vertex(e.src).rate_out() * c_bar * (1.0 + alpha)
    return total
