"""Seeded random generator for executable graphs and execution plans.

The generator covers the full lowerable op vocabulary of the executable
runtime (``runtime/executor.apply_vertex``): 1x1 channel-mixing ``conv``,
depthwise temporal ``dwconv``, ``pool``/global-pool, ``upsample``,
``act``, residual ``add``, broadcast ``mul`` (squeeze-excitation), and
``concat`` — composed into the block patterns whose deep synchronisation
buffers SMOF's eviction attacks: residual/SE side branches and long
encoder->decoder / feature-bank skips.

Everything is driven by one ``random.Random`` instance, so a (seed, index)
pair fully determines a case; the fuzz driver and the committed repro files
both rely on that.
"""
from __future__ import annotations

import dataclasses
import json
import random

from ..core.builders import _XB, exec_input_shape
from ..core.graph import WEIGHTY, Graph
from ..core.plan import ExecutionPlan, LayerPlan, StreamPlan
from ..memory import POLICIES, ChannelConfig

__all__ = ["GenConfig", "FuzzCase", "random_exec_graph", "random_plan",
           "mutate_plan", "random_case", "case_to_json_dict",
           "case_from_json_dict"]


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Knobs bounding the generated case population.

    Positions are powers of two so pool/upsample chains always land on
    integral extents; channels need not be multiples of the BFP8 block
    (32) — odd widths exercise the codec's block padding path.
    """
    min_blocks: int = 3
    max_blocks: int = 8
    positions: tuple[int, ...] = (16, 32)
    max_positions: int = 64
    channels: tuple[int, ...] = (16, 32, 64)
    p_snapshot: float = 0.5        # block output becomes a skip candidate
    p_feature_bank: float = 0.8    # force one graph-spanning concat skip
    max_stages: int = 4
    p_evict_deep: float = 0.8      # eviction bias for deep/crossing streams
    p_evict: float = 0.25
    p_bfp8: float = 0.75
    frag_choices: tuple[float, ...] = (1.0, 1.0, 0.75, 0.5)
    min_microbatches: int = 2
    max_microbatches: int = 5
    max_mutations: int = 2
    # off-chip channel model draws (repro_torch.memory): probability a case
    # gets a ChannelConfig at all, then policy/bandwidth/weight vocabularies.
    # The gbps menu deliberately includes starvation-grade bandwidths
    # (0.5/1.0) so oversubscribed channels appear within a smoke budget.
    p_channel: float = 0.5
    channel_policies: tuple[str, ...] = POLICIES
    channel_gbps: tuple[float, ...] = (0.5, 1.0, 8.0, 64.0)
    channel_weights: tuple[float, ...] = (0.5, 1.0, 2.0)
    #: probability a case draws kernel_mode="pallas" (the kernel route: the
    #: CUDA kernels on the card, their plain versions on the CPU), arming
    #: the kernel_parity oracle against the reference dispatch
    p_pallas: float = 0.5


# -----------------------------------------------------------------------------
# graph generation
# -----------------------------------------------------------------------------

def random_exec_graph(rng: random.Random, cfg: GenConfig = GenConfig(),
                      name: str = "fuzz") -> Graph:
    """One random executable graph: a chain of blocks drawn from the op
    menu, with skip connections into ``add``/``mul``/``concat`` merge
    points and (usually) one long feature-bank skip spanning the whole
    body — the deepest buffer in the graph, like UNet's outermost skip."""
    g = Graph(name)
    b = _XB(g, word_bits=16, weight_bits=16)
    m = rng.choice(list(cfg.positions))
    c = rng.choice(list(cfg.channels))
    prev = b.xsimple(None, "input", c, m)
    # skip snapshots: (name, channels, positions) of earlier block outputs
    snaps: list[tuple[str, int, int]] = []
    bank: tuple[str, int, int] | None = None

    def menu() -> list[tuple[str, int]]:
        ops = [("conv", 3), ("act", 2), ("dwconv", 2), ("se", 1)]
        if m % 2 == 0 and m >= 4:
            ops.append(("pool", 2))
        if m * 2 <= cfg.max_positions:
            ops.append(("upsample", 1))
        if any(sc == c and sm == m and s != prev for s, sc, sm in snaps):
            ops.append(("add_skip", 2))
        if any(sm == m and s != prev for s, _, sm in snaps):
            ops.append(("concat_skip", 2))
        return ops

    n_blocks = rng.randint(cfg.min_blocks, cfg.max_blocks)
    for _ in range(n_blocks):
        ops = menu()
        kinds = [k for k, _ in ops]
        weights = [w for _, w in ops]
        kind = rng.choices(kinds, weights=weights, k=1)[0]
        if kind == "conv":
            cout = rng.choice(list(cfg.channels))
            prev = b.xconv(prev, c, cout, m)
            c = cout
        elif kind == "act":
            prev = b.xsimple(prev, "act", c, m)
        elif kind == "dwconv":
            prev = b.xdwconv(prev, c, m, taps=rng.choice((3, 5)))
        elif kind == "se":
            # squeeze-excitation: global pool -> bottleneck convs ->
            # broadcast mul; the side branch re-converges after the whole
            # excitation chain (a deep buffer on the trunk edge)
            se = b.xsimple(prev, "pool", c, m, m_out=1)
            se = b.xconv(se, c, 32, 1)
            se = b.xsimple(se, "act", 32, 1)
            se = b.xconv(se, 32, c, 1)
            prev = b.xsimple([prev, se], "mul", c, m)
        elif kind == "pool":
            prev = b.xsimple(prev, "pool", c, m, m_out=m // 2)
            m //= 2
        elif kind == "upsample":
            prev = b.xsimple(prev, "upsample", c, m, m_out=m * 2)
            m *= 2
        elif kind == "add_skip":
            skip = rng.choice([s for s, sc, sm in snaps
                               if sc == c and sm == m and s != prev])
            prev = b.xsimple([skip, prev], "add", c, m)
        elif kind == "concat_skip":
            skip, sc, _ = rng.choice([t for t in snaps
                                      if t[2] == m and t[0] != prev])
            prev = b.xsimple([skip, prev], "concat", sc + c, m)
            c += sc
        if rng.random() < cfg.p_snapshot:
            snaps.append((prev, c, m))
            if bank is None:
                bank = snaps[-1]

    # graph-spanning feature bank: the earliest snapshot skips the whole
    # body, pooled/upsampled to the final extent, fusing by concat
    if bank is not None and bank[0] != prev and rng.random() < cfg.p_feature_bank:
        bname, bc, bm = bank
        while bm > m:
            bname = b.xsimple(bname, "pool", bc, bm, m_out=bm // 2)
            bm //= 2
        while bm < m:
            bname = b.xsimple(bname, "upsample", bc, bm, m_out=bm * 2)
            bm *= 2
        if bname != prev:
            prev = b.xsimple([bname, prev], "concat", bc + c, m)
            c += bc
    prev = b.xconv(prev, c, rng.choice(list(cfg.channels)), m)
    b.xsimple(prev, "output", g.vertex(prev).meta["exec"]["cout"], m)
    g.validate()
    return g


# -----------------------------------------------------------------------------
# plan generation / mutation
# -----------------------------------------------------------------------------

def _edge_depth(topo: list[str], src: str, dst: str) -> int:
    pos = {n: i for i, n in enumerate(topo)}
    return pos[dst] - pos[src]


def random_plan(g: Graph, rng: random.Random,
                cfg: GenConfig = GenConfig()) -> ExecutionPlan:
    """A random valid plan for ``g``: contiguous topo-order stage cuts
    (stage bounds are then monotonic along every edge by construction),
    eviction biased towards deep and stage-crossing streams, random
    fragmentation on weighty layers, random microbatch count."""
    topo = g.topo()
    n_stages = rng.randint(1, min(cfg.max_stages, len(topo)))
    cuts = sorted(rng.sample(range(1, len(topo)), n_stages - 1))
    stage_of: dict[str, int] = {}
    s = 0
    for i, n in enumerate(topo):
        while s < len(cuts) and i >= cuts[s]:
            s += 1
        stage_of[n] = s
    layers = {
        n: LayerPlan(
            name=n, stage=stage_of[n],
            weight_static_fraction=(rng.choice(cfg.frag_choices)
                                    if g.vertex(n).kind in WEIGHTY else 1.0))
        for n in topo}
    streams = []
    for e in g.edges():
        deep = (_edge_depth(topo, e.src, e.dst) > 2
                or stage_of[e.src] != stage_of[e.dst])
        evicted = rng.random() < (cfg.p_evict_deep if deep else cfg.p_evict)
        codec = ("bfp8" if evicted and rng.random() < cfg.p_bfp8 else "none")
        streams.append(StreamPlan(e.src, e.dst, evicted=evicted, codec=codec))
    plan = ExecutionPlan(
        model=g.name, device="u200", n_stages=n_stages, layers=layers,
        streams=streams,
        microbatch=rng.randint(cfg.min_microbatches, cfg.max_microbatches),
        topo_order=topo)
    plan.validate()
    return plan


def _copy_plan(plan: ExecutionPlan) -> ExecutionPlan:
    return ExecutionPlan.from_json(plan.to_json())


def _stage_bounds(plan: ExecutionPlan) -> list[int] | None:
    """Per-layer stage ids along topo order, or None if not contiguous
    non-decreasing (mutations only operate on contiguous plans)."""
    stages = [plan.layers[n].stage for n in plan.ordered_layers()]
    if any(b < a for a, b in zip(stages, stages[1:])):
        return None
    return stages


def mutate_plan(g: Graph, plan: ExecutionPlan, rng: random.Random,
                cfg: GenConfig = GenConfig()) -> ExecutionPlan:
    """One random plan mutation: split/merge a stage, flip an eviction,
    change a codec/fragmentation fraction, or rescale the microbatch.
    Always returns a *valid* plan (falls back to a fresh random plan if
    the drawn move is inapplicable)."""
    p = _copy_plan(plan)
    order = p.ordered_layers()
    move = rng.choice(("split", "merge", "evict", "unevict", "frag",
                       "microbatch"))
    if move == "split":
        stages = _stage_bounds(p)
        if stages is not None and p.n_stages < cfg.max_stages:
            # cut one stage segment in two at a random internal boundary
            cands = [i for i in range(1, len(order))
                     if stages[i] == stages[i - 1]]
            if cands:
                cut = rng.choice(cands)
                for i in range(cut, len(order)):
                    p.layers[order[i]].stage += 1
                p.n_stages += 1
    elif move == "merge":
        if p.n_stages > 1:
            j = rng.randint(1, p.n_stages - 1)   # merge stage j into j-1
            for lp in p.layers.values():
                if lp.stage >= j:
                    lp.stage -= 1
            p.n_stages -= 1
    elif move == "evict":
        cands = [s for s in p.streams if not s.evicted]
        if cands:
            s = rng.choice(cands)
            s.evicted = True
            s.codec = "bfp8" if rng.random() < cfg.p_bfp8 else "none"
    elif move == "unevict":
        cands = [s for s in p.streams if s.evicted]
        if cands:
            s = rng.choice(cands)
            s.evicted, s.codec = False, "none"
    elif move == "frag":
        cands = [n for n in order if g.vertex(n).kind in WEIGHTY]
        if cands:
            p.layers[rng.choice(cands)].weight_static_fraction = \
                rng.choice(cfg.frag_choices)
    elif move == "microbatch":
        p.microbatch = rng.randint(cfg.min_microbatches,
                                   cfg.max_microbatches)
    p.validate()
    return p


# -----------------------------------------------------------------------------
# cases
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class FuzzCase:
    """One conformance case: a graph, a plan for it, the seed that
    derives its weights and input frames, and (optionally) an off-chip
    channel model the pipelined compile arbitrates under."""
    graph: Graph
    plan: ExecutionPlan
    seed: int
    label: str = "case"
    channel: ChannelConfig | None = None
    #: kernel dispatch for the case's compiles ("reference" | "pallas", the
    #: reference package's name of the kernel route); "pallas" additionally
    #: arms the kernel_parity oracle
    kernel_mode: str = "reference"

    @property
    def input_shape(self) -> tuple[int, int]:
        return exec_input_shape(self.graph)


def random_case(seed: int, index: int,
                cfg: GenConfig = GenConfig()) -> FuzzCase:
    """The fully deterministic case for (seed, index): graph, plan, and
    0..max_mutations plan mutations, all from one seeded stream."""
    rng = random.Random(f"smof-fuzz:{seed}:{index}")
    g = random_exec_graph(rng, cfg, name=f"fuzz_{seed}_{index}")
    plan = random_plan(g, rng, cfg)
    for _ in range(rng.randint(0, cfg.max_mutations)):
        plan = mutate_plan(g, plan, rng, cfg)
    # channel draw LAST: earlier draws are byte-identical to the
    # pre-channel generator, so old (seed, index) pairs still name the
    # same graph+plan and committed repro shrinks stay valid.
    channel = None
    if rng.random() < cfg.p_channel:
        channel = ChannelConfig(
            policy=rng.choice(list(cfg.channel_policies)),
            gbps=rng.choice(list(cfg.channel_gbps)),
            weight_fetch_weight=rng.choice(list(cfg.channel_weights)),
            evict_weight=rng.choice(list(cfg.channel_weights)),
            restore_weight=rng.choice(list(cfg.channel_weights)))
    # kernel_mode draw after the channel draw, same reasoning: every
    # earlier draw stays byte-identical to the pre-kernel-mode generator.
    kernel_mode = "pallas" if rng.random() < cfg.p_pallas else "reference"
    return FuzzCase(graph=g, plan=plan, seed=seed * 1000 + index,
                    label=f"{seed}-{index}", channel=channel,
                    kernel_mode=kernel_mode)


def case_to_json_dict(case: FuzzCase) -> dict:
    return {
        "graph": case.graph.to_json_dict(),
        "plan": json.loads(case.plan.to_json()),
        "seed": case.seed,
        "label": case.label,
        "channel": (case.channel.to_dict()
                    if case.channel is not None else None),
        "kernel_mode": case.kernel_mode,
    }


def case_from_json_dict(d: dict) -> FuzzCase:
    return FuzzCase(
        graph=Graph.from_json_dict(d["graph"]),
        plan=ExecutionPlan.from_json(json.dumps(d["plan"])),
        seed=int(d["seed"]),
        label=d.get("label", "case"),
        # pre-channel repro payloads have no "channel" key -> None
        channel=(ChannelConfig.from_dict(d["channel"])
                 if d.get("channel") else None),
        # pre-kernel-mode payloads replay on the reference dispatch
        kernel_mode=d.get("kernel_mode", "reference"),
    )
