"""Subgraph partitioning & reconfiguration (paper §III-C, Eq. 5-6).

The DAG is cut into N subgraphs scheduled sequentially on one device through
reconfiguration.  Each subgraph processes the whole batch ``b`` in streaming
mode, then the device is reprogrammed (``t_ri``):

  Eq. 5   t = sum_i (b * II_i + d_pi) / f  +  N * t_ri        [seconds]
  Eq. 6   Theta = b / t                                        [frames/s]

Constraints (Eq. 7): per-subgraph on-chip resources, off-chip bandwidth, and
compute dependency (producers of any vertex are in the same or an earlier
subgraph — guaranteed here by cutting along a topological order).
"""
from __future__ import annotations

import dataclasses

from . import eviction, fragmentation
from .graph import Graph
from .pipeline import initiation_interval, pipeline_depth
from .resources import Device


@dataclasses.dataclass
class Partitioning:
    """An ordered list of subgraphs, each a list of vertex names."""
    graph: Graph
    parts: list[list[str]]

    def __post_init__(self) -> None:
        self.validate()

    @property
    def n(self) -> int:
        return len(self.parts)

    def subgraphs(self) -> list[Graph]:
        return [self.graph.subgraph(p) for p in self.parts]

    def validate(self) -> None:
        """Compute-dependency constraint: producers same-or-earlier subgraph."""
        where: dict[str, int] = {}
        for i, p in enumerate(self.parts):
            for v in p:
                if v in where:
                    raise ValueError(f"vertex {v!r} assigned twice")
                where[v] = i
        missing = set(self.graph.g.nodes) - set(where)
        if missing:
            raise ValueError(f"unassigned vertices: {sorted(missing)[:5]}")
        for u, w in self.graph.g.edges:
            if where[u] > where[w]:
                raise ValueError(
                    f"dependency violation: {u!r} (part {where[u]}) feeds "
                    f"{w!r} (part {where[w]})")

    def boundary_words(self, i: int) -> tuple[float, float]:
        """(input, output) stream words crossing subgraph ``i``'s boundary."""
        mine = set(self.parts[i])
        w_in = w_out = 0.0
        for u, w in self.graph.g.edges:
            e = self.graph.edge(u, w)
            if u not in mine and w in mine:
                w_in += e.words
            elif u in mine and w not in mine:
                w_out += e.words
        return w_in, w_out


@dataclasses.dataclass
class SubgraphCost:
    ii_cycles: float
    depth_cycles: float
    compute_units: float
    onchip_bits: float
    bw_words_per_cycle: float    # eviction + fragmentation + boundary I/O
    lut_cost: float


def subgraph_cost(p: Partitioning, i: int, sparsity: float = 0.5,
                  alpha: float = 1.0) -> SubgraphCost:
    sg = p.graph.subgraph(p.parts[i])
    ii = initiation_interval(sg)
    # boundary streams always cross off-chip (subgraphs run one at a time)
    b_in, b_out = p.boundary_words(i)
    bw = (eviction.eviction_bw_words(sg, sparsity=sparsity, alpha=alpha)
          + fragmentation.fragmentation_bw_words(sg)
          + (b_in + b_out) / max(ii, 1.0))
    lut = sum(2 * _codec_lut(e.codec) for e in sg.edges() if e.evicted)
    lut += sum(_codec_lut(v.meta.get("frag_codec", "none"))
               for v in sg.vertices() if v.frag_ratio > 0)
    return SubgraphCost(
        ii_cycles=ii,
        depth_cycles=pipeline_depth(sg),
        compute_units=sum(v.compute_units() for v in sg.vertices()),
        onchip_bits=(fragmentation.onchip_weight_bits(sg)
                     + eviction.onchip_buffer_bits(sg)),
        bw_words_per_cycle=bw,
        lut_cost=lut,
    )


def _codec_lut(codec: str) -> float:
    from .compression import CODEC_LUT_COST
    return CODEC_LUT_COST.get(codec, 0)


def fits(cost: SubgraphCost, dev: Device, word_bits: int = 16,
         base_lut_frac: float = 0.55) -> bool:
    """Eq. 7 feasibility of one subgraph on ``dev``.

    ``base_lut_frac`` models the logic consumed by the compute pipeline
    itself; codecs charge on top of it (FPGA mode only — TPU views have
    ``luts == 0`` and skip the check).
    """
    if cost.compute_units > dev.compute_units:
        return False
    if cost.onchip_bits > dev.onchip_bits:
        return False
    if cost.bw_words_per_cycle > dev.words_per_cycle_offchip(word_bits):
        return False
    if dev.luts > 0 and cost.lut_cost > dev.luts * (1.0 - base_lut_frac):
        return False
    return True


def latency_s(p: Partitioning, dev: Device, batch: int,
              sparsity: float = 0.5, alpha: float = 1.0) -> float:
    """Eq. 5 — total latency of one batch through all subgraphs."""
    f = dev.cycles_per_s
    total = 0.0
    for i in range(p.n):
        c = subgraph_cost(p, i, sparsity=sparsity, alpha=alpha)
        total += (batch * c.ii_cycles + c.depth_cycles) / f
    # Eq. 5's N*t_ri term: a single-subgraph design keeps its bitstream
    # resident (Table V marks these "-"), so reconfiguration only costs
    # when the device is actually time-multiplexed.
    if p.n > 1:
        total += p.n * dev.reconfig_s
    return total


def throughput_fps(p: Partitioning, dev: Device, batch: int,
                   sparsity: float = 0.5, alpha: float = 1.0) -> float:
    """Eq. 6."""
    return batch / latency_s(p, dev, batch, sparsity=sparsity, alpha=alpha)


def initial_partition(g: Graph, cut_kinds: tuple[str, ...] | None = None) -> Partitioning:
    """DSE pass 1 seed: as many subgraphs as possible (resource-minimal).

    Cut after every vertex whose kind is in ``cut_kinds`` (None = cut
    everywhere), walking a topological order so dependencies hold.
    """
    topo = g.topo()
    parts: list[list[str]] = []
    cur: list[str] = []
    for v in topo:
        cur.append(v)
        if cut_kinds is None or g.vertex(v).kind in cut_kinds:
            parts.append(cur)
            cur = []
    if cur:
        parts.append(cur)
    return Partitioning(g, parts)


def merge(p: Partitioning, i: int) -> Partitioning:
    """Merge subgraphs i and i+1 (DSE pass 5 candidate)."""
    if not (0 <= i < p.n - 1):
        raise IndexError(i)
    parts = [list(x) for x in p.parts]
    parts[i] = parts[i] + parts[i + 1]
    del parts[i + 1]
    return Partitioning(p.graph, parts)
