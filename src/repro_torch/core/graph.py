"""Layer-graph IR for SMOF.

The CNN / LM workload is abstracted to a DAG (paper §III-A): vertices are
operations (conv, pool, matmul, attention, ...) and edges are data streams
between them.  Every quantity the SMOF cost models need lives here:

* per-vertex: work (MACs), weight footprint, streaming rates, parallelism,
  latency ``lambda_v`` and pipeline depth ``rho_v``;
* per-edge: stream volume per frame, word width, and the *buffer depth*
  ``d_b`` required to synchronise branches (the quantity activation eviction
  attacks).

Units are kept abstract — "words" and "cycles" — so the same IR drives both
the FPGA-faithful reproduction (words = 8/16-bit fixed point, cycles at
200-250 MHz) and the TPU adaptation (words = bf16 elements, f = 940 MHz).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import networkx as nx

# Operation categories.  ``WEIGHTY`` ops own parameters and are candidates for
# weight fragmentation; ``BRANCH`` points create the deep buffers that
# activation eviction targets.
OP_KINDS = (
    "input", "output",
    "conv", "dwconv", "deconv", "pool", "upsample", "act", "norm",
    "add", "mul", "concat", "split", "matmul", "attention", "kv_append",
    "router", "expert", "ssm_scan", "embed", "reshape",
)
WEIGHTY = {"conv", "dwconv", "deconv", "matmul", "expert", "embed", "norm", "ssm_scan"}


@dataclasses.dataclass
class Vertex:
    """One streaming operation.

    Attributes
    ----------
    work_macs:       multiply-accumulates per frame (0 for data-movement ops).
    weight_words:    parameter words owned by this vertex.
    in_words:        input stream volume per frame (``sigma_v^in``).
    out_words:       output stream volume per frame.
    word_bits:       stream word width ``L`` (Eq. 4 heuristic uses it).
    base_depth:      intrinsic pipeline depth at parallelism 1 (``rho_v``
                     before rate scaling), e.g. a conv line buffer.
    min_par/max_par: legal parallelism range (``p`` in ``D_v``).
    """
    name: str
    kind: str
    work_macs: float = 0.0
    weight_words: float = 0.0
    in_words: float = 1.0
    out_words: float = 1.0
    word_bits: int = 16
    weight_bits: int = 8
    base_depth: float = 1.0
    min_par: int = 1
    max_par: int = 1
    # mutable design state (filled by the DSE) ------------------------------
    par: int = 1
    frag_ratio: float = 0.0          # m in [0,1], Eq. 3/4
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r} for vertex {self.name!r}")
        self.par = max(self.par, self.min_par)

    # -- performance models (fpgaConvNet-style, simplified) -----------------
    def latency(self, par: int | None = None) -> float:
        """``lambda_v``: cycles to stream one frame through this vertex."""
        p = self.par if par is None else par
        # Work-dominated ops are limited by MACs/cycle; movement ops by words.
        cycles_work = self.work_macs / max(p, 1)
        cycles_io = max(self.in_words, self.out_words) / max(p, 1)
        return max(cycles_work, cycles_io, 1.0)

    def depth(self, par: int | None = None) -> float:
        """``rho_v``: pipeline depth (cycles before the first output word)."""
        p = self.par if par is None else par
        return max(self.base_depth / max(p, 1), 1.0)

    def rate_in(self, par: int | None = None) -> float:
        """Standard input rate ``r_v^in`` in words/cycle."""
        return self.in_words / self.latency(par)

    def rate_out(self, par: int | None = None) -> float:
        return self.out_words / self.latency(par)

    # -- resource models ------------------------------------------------------
    def compute_units(self, par: int | None = None) -> float:
        """DSPs (FPGA) / MXU lanes (TPU) consumed at parallelism ``p``."""
        p = self.par if par is None else par
        return float(p) if self.work_macs > 0 else 0.0

    def static_weight_bits(self) -> float:
        """On-chip weight storage after fragmentation (Eq. 3 applied)."""
        return self.weight_words * (1.0 - self.frag_ratio) * self.weight_bits

    def weight_stream_words_per_frame(self) -> float:
        """Dynamic-region words fetched from off-chip per frame (Eq. 4's m*r)."""
        return self.weight_words * self.frag_ratio


@dataclasses.dataclass
class Edge:
    """A stream between two vertices.

    ``buffer_depth`` is ``d_b`` — the on-chip FIFO depth needed to absorb the
    latency mismatch between the two endpoints (deep for long skips).  It is
    computed by :func:`Graph.compute_buffer_depths` from the pipeline-depth
    model, and activation eviction replaces it with ``d_b'`` (two DMA FIFOs).
    """
    src: str
    dst: str
    words: float = 1.0               # stream volume per frame
    word_bits: int = 16
    buffer_depth: float = 1.0        # d_b
    # mutable design state ---------------------------------------------------
    evicted: bool = False            # a_i/a_o flags materialise here
    codec: str = "none"              # none | rle | huffman | bfp8


class Graph:
    """DAG of :class:`Vertex` linked by :class:`Edge` (networkx-backed)."""

    def __init__(self, name: str = "g") -> None:
        self.name = name
        self.g = nx.DiGraph()

    # -- construction ---------------------------------------------------------
    def add(self, v: Vertex) -> Vertex:
        if v.name in self.g:
            raise ValueError(f"duplicate vertex {v.name!r}")
        self.g.add_node(v.name, v=v)
        return v

    def connect(self, src: str, dst: str, words: float | None = None,
                word_bits: int | None = None) -> Edge:
        sv, dv = self.vertex(src), self.vertex(dst)
        e = Edge(src=src, dst=dst,
                 words=float(sv.out_words if words is None else words),
                 word_bits=word_bits or sv.word_bits)
        self.g.add_edge(src, dst, e=e)
        return e

    # -- access ---------------------------------------------------------------
    def vertex(self, name: str) -> Vertex:
        return self.g.nodes[name]["v"]

    def edge(self, src: str, dst: str) -> Edge:
        return self.g.edges[src, dst]["e"]

    def vertices(self) -> Iterator[Vertex]:
        for n in self.g.nodes:
            yield self.g.nodes[n]["v"]

    def edges(self) -> Iterator[Edge]:
        for u, vn in self.g.edges:
            yield self.g.edges[u, vn]["e"]

    def topo(self) -> list[str]:
        return list(nx.topological_sort(self.g))

    def predecessors(self, name: str) -> list[str]:
        return list(self.g.predecessors(name))

    def in_edges(self, name: str) -> list[Edge]:
        """Incoming edges in predecessor (insertion) order — the order
        multi-input ops (concat, add) consume their operands, which the
        executable lowering must preserve."""
        return [self.edge(p, name) for p in self.predecessors(name)]

    def successors(self, name: str) -> list[str]:
        return list(self.g.successors(name))

    def sources(self) -> list[str]:
        return [n for n in self.g.nodes if self.g.in_degree(n) == 0]

    def sinks(self) -> list[str]:
        return [n for n in self.g.nodes if self.g.out_degree(n) == 0]

    # -- surgery (generator / shrinker hooks) ---------------------------------
    def remove_edge(self, src: str, dst: str) -> None:
        """Drop one edge (the shrinker's cheapest simplification)."""
        self.g.remove_edge(src, dst)

    def remove_vertex(self, name: str, reconnect: bool = False) -> None:
        """Drop a vertex and its incident edges.

        With ``reconnect=True`` (single-predecessor vertices only), every
        successor is re-wired to the predecessor — how the fuzz shrinker
        deletes a shape-preserving op from a failing case without breaking
        the surrounding topology.  Re-wired edges keep the successor-side
        edge's attributes, so eviction flags survive the splice.
        """
        if reconnect:
            preds = self.predecessors(name)
            if len(preds) != 1:
                raise ValueError(
                    f"cannot reconnect around {name!r}: it has "
                    f"{len(preds)} predecessors (need exactly 1)")
            p = preds[0]
            for s in self.successors(name):
                if self.g.has_edge(p, s):
                    raise ValueError(
                        f"cannot reconnect around {name!r}: edge "
                        f"{(p, s)} already exists")
                e = self.edge(name, s)
                self.g.add_edge(p, s, e=dataclasses.replace(e, src=p))
        self.g.remove_node(name)

    def validate(self) -> None:
        """Structural invariants every lowerable graph must satisfy.

        The fuzz generator and shrinker call this after every construction
        or surgery step: the graph must be a DAG, its unique source must be
        the ``input`` vertex, its sinks must all be ``output`` vertices,
        and every multi-input op must actually have inputs.  Violations
        raise ``ValueError`` with all problems listed.
        """
        errs: list[str] = []
        if not nx.is_directed_acyclic_graph(self.g):
            errs.append("graph has a cycle")
        srcs = self.sources()
        if len(srcs) != 1 or (srcs and self.vertex(srcs[0]).kind != "input"):
            errs.append(f"expected one 'input' source, got {srcs}")
        for n in self.sinks():
            if self.vertex(n).kind != "output":
                errs.append(f"sink {n!r} is {self.vertex(n).kind!r}, "
                            f"not 'output'")
        for v in self.vertices():
            if v.kind not in ("input",) and not self.predecessors(v.name):
                errs.append(f"non-input vertex {v.name!r} has no inputs")
        if errs:
            raise ValueError(f"invalid graph {self.name!r}: " + "; ".join(errs))

    def first_node(self) -> str:
        """``N_G^in`` — the first node of the graph (unique source expected)."""
        srcs = self.sources()
        return srcs[0]

    # -- serialisation --------------------------------------------------------
    def to_json_dict(self) -> dict:
        """JSON-able structural dump: vertices and edges in insertion order.

        Order matters beyond aesthetics: ``in_edges`` feeds multi-input ops
        (concat, add) their operands in predecessor insertion order, so the
        round-trip must preserve it — ``from_json_dict`` re-adds nodes and
        edges in exactly this order.  Mutable design state (``par``,
        ``frag_ratio``, eviction flags) is included, so a dump taken after
        a DSE run reproduces the explored graph, not the pristine one.
        """
        return {
            "name": self.name,
            "vertices": [dataclasses.asdict(self.g.nodes[n]["v"])
                         for n in self.g.nodes],
            # grouped by destination, predecessors in insertion order:
            # re-adding in this sequence reproduces each node's operand
            # order exactly (nx stores pred adjacency by insertion)
            "edges": [dataclasses.asdict(e)
                      for n in self.g.nodes for e in self.in_edges(n)],
        }

    @staticmethod
    def from_json_dict(d: dict) -> "Graph":
        g = Graph(name=d["name"])
        for vd in d["vertices"]:
            g.add(Vertex(**vd))
        for ed in d["edges"]:
            e = Edge(**ed)
            g.g.add_edge(e.src, e.dst, e=e)
        return g

    # -- aggregate stats ------------------------------------------------------
    def total_macs(self) -> float:
        return sum(v.work_macs for v in self.vertices())

    def total_weight_words(self) -> float:
        return sum(v.weight_words for v in self.vertices())

    def subgraph(self, names: Iterable[str]) -> "Graph":
        names = list(names)
        sg = Graph(name=f"{self.name}:sub")
        for n in names:
            sg.g.add_node(n, v=self.g.nodes[n]["v"])
        for u, vn in self.g.edges:
            if u in sg.g and vn in sg.g:
                sg.g.add_edge(u, vn, e=self.g.edges[u, vn]["e"])
        return sg

    # -- buffer-depth computation (what eviction attacks) ---------------------
    def compute_buffer_depths(self) -> None:
        """Fill ``Edge.buffer_depth`` for every edge.

        Sequential edges get a small rate-mismatch buffer.  Branch edges
        (src has >1 consumer, or paths re-converge) must hold the data
        produced while the *slower* sibling path catches up: depth equals the
        path-delay difference (in cycles) times the stream rate — the deep
        buffers on long skip connections in UNet-like topologies (paper
        §III-A).
        """
        from .pipeline import vertex_delays  # local import to avoid a cycle
        delay = vertex_delays(self)
        for u, w in self.g.edges:
            e: Edge = self.g.edges[u, w]["e"]
            uv, wv = self.vertex(u), self.vertex(w)
            # base: double-buffer one burst of the producer
            base = max(2.0 * uv.rate_out() * min(uv.latency(), 64.0), 2.0)
            mismatch = 0.0
            preds = self.predecessors(w)
            if len(preds) > 1:
                # merge point: this edge must buffer until the slowest branch
                # arrives — difference between the slowest sibling's delay and
                # the producer's own delay, at the producer's output rate.
                slowest = max(delay[p] for p in preds)
                mismatch = max(slowest - delay[u], 0.0) * uv.rate_out()
            e.buffer_depth = max(base, mismatch, 2.0)
