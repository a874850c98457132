"""Refined pipeline-depth estimation (paper §IV-C, Eq. 8-11).

The performance of a streaming design depends on the pipeline depth
``d_pG`` of the computation graph — the cycles elapsed before the pipeline
is fully primed.  fpgaConvNet's original model used a flat sum of vertex
depths; SMOF refines it by recognising that during the *pipeline-depth
region* a vertex consumes at its **initiation rate** ``r^st`` (set by how
fast its ancestors can feed it), which differs from its steady-state input
rate ``r^in`` (Fig. 5).

Implemented faithfully:

  Eq. 8   Interval_prev(v) = max_{a in ancestors(v)} (lambda_a + rho_a)
  Eq. 9   r^st(v) = r_v^in                        if ancestors(v) is empty
                  = sigma_v^in / Interval_prev(v) otherwise
  Eq. 10  Delay(G, v) = sum_{n in argmax path P_G(N_G^in, v)} rho_n / r^st(n)
  Eq. 11  d_pG = max_v Delay(G, v)

``ancestors`` means *direct* predecessors (the paper: "all nodes in graph G
that have direct connection to the node v").
"""
from __future__ import annotations

from .graph import Graph


def interval_prev(g: Graph, v: str, _memo: dict | None = None) -> float:
    """Eq. 8 — the interval leading up to vertex ``v``."""
    preds = g.predecessors(v)
    if not preds:
        return 0.0
    out = 0.0
    for a in preds:
        av = g.vertex(a)
        out = max(out, av.latency() + av.depth())
    return out


def initiation_rate(g: Graph, v: str) -> float:
    """Eq. 9 — ``r^st(v)`` in words/cycle."""
    vv = g.vertex(v)
    preds = g.predecessors(v)
    if not preds:
        return vv.rate_in()
    iv = interval_prev(g, v)
    return vv.in_words / max(iv, 1.0)


def vertex_delays(g: Graph) -> dict[str, float]:
    """Eq. 10 for every vertex, via one topological DP.

    ``Delay(G, v)`` sums ``rho_n / r^st(n)`` along the *longest* (max-delay)
    path from the graph input to ``v`` — a longest-path DP over the DAG
    rather than the exponential path enumeration ``P_G`` suggests.
    """
    delays: dict[str, float] = {}
    rates = {v: initiation_rate(g, v) for v in g.g.nodes}
    for n in g.topo():
        vv = g.vertex(n)
        own = vv.depth() / max(rates[n], 1e-12)
        preds = g.predecessors(n)
        best = max((delays[p] for p in preds), default=0.0)
        delays[n] = best + own
    return delays


def pipeline_depth(g: Graph) -> float:
    """Eq. 11 — ``d_pG`` in cycles."""
    d = vertex_delays(g)
    return max(d.values(), default=0.0)


def initiation_interval(g: Graph) -> float:
    """``II`` of the whole pipeline: the slowest vertex sets the frame rate."""
    return max((v.latency() for v in g.vertices()), default=1.0)
