"""Executable lowering: DSE plan -> a streaming pipeline over PyTorch tensors.

The counterpart of the reference package's ``runtime/executor.py``: the
DSE (``core.dse``) decides *where* data lives and ``core.plan.ExecutionPlan``
records the decision vector; this module makes those decisions happen:

* **evicted streams** (``StreamPlan.evicted``) round-trip through an
  off-chip spill buffer.  BFP8 streams are really quantised on the way out
  and dequantised on the way back in (``kernels/bfp8.py``), so the executed
  numerics carry the codec's error exactly as hardware would; RLE/Huffman
  are lossless, so their numerical effect is identity and only the traffic
  accounting changes.  On a CUDA device the spill also crosses to pinned
  host memory when its producer runs and comes back for each consumer
  (:class:`OffchipHop`); the device copies are dropped in between, so an
  evicted stream holds no device memory while it waits.  On the CPU the
  hop is identity.
* **fragmented weights** (``LayerPlan.weight_static_fraction < 1``)
  dispatch to ``kernels/streamed_matmul.py``, split at the plan's ``1 - m``.
* **stage boundaries** (``LayerPlan.stage`` changes across an edge) hop
  off-chip uncompressed (the sequential subgraph schedule of Eq. 5).

Executable graphs come from ``core.builders.build_*_exec``: every vertex
carries ``meta["exec"] = {cin, cout, m[, m_out]}`` and activations flow as
``(positions, channels)`` f32 stripes.  The op vocabulary and its semantics
are the reference's: input, conv/matmul/deconv (``y = x @ W``), dwconv,
act (relu), pool (mean to m_out rows), upsample, add, mul, concat, output.

Kernel modes: ``"auto"`` routes every op through the kernel wrappers
(``kernels/``), which launch the CUDA kernels on CUDA tensors and run their
plain versions on CPU tensors; ``"cuda"`` is ``"auto"`` that refuses a
non-CUDA device; ``"reference"`` runs the plain bodies directly and
round-trips every spilled edge through its codec.  Both routes compute the
same composition.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import zlib
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch

from ..core.graph import Graph
from ..core.plan import ExecutionPlan
from ..kernels import ref as kref
from ..kernels import streaming_conv as SC
from ..kernels.bfp8 import bfp8_dequant, bfp8_quant
from ..kernels.streamed_matmul import _round_up, streamed_matmul_padded

WEIGHT_KINDS = ("conv", "deconv", "matmul")
TEMPORAL_KINDS = ("dwconv",)
LOSSLESS_CODECS = ("none", "rle", "huffman")
BFP8_BLOCK = 32
KERNEL_MODES = ("auto", "cuda", "reference")


# =============================================================================
# Spill accounting
# =============================================================================

@dataclasses.dataclass(frozen=True)
class SpillRecord:
    """Off-chip traffic of one spilled stream (per frame)."""
    src: str
    dst: str
    codec: str
    reason: str            # "evicted" | "stage_boundary"
    raw_bits: int          # words * word_bits before the codec
    offchip_bits: int      # bits actually crossing the off-chip boundary
    exact: bool            # True when offchip_bits is compile-time exact

    @property
    def ratio(self) -> float:
        return self.offchip_bits / max(self.raw_bits, 1)


@dataclasses.dataclass
class SpillReport:
    spills: list[SpillRecord]
    streamed_weight_bits: int     # dynamic-region weight traffic per frame
    static_weight_bits: int       # pinned on-chip weight residency

    @property
    def total_offchip_bits(self) -> int:
        return (sum(s.offchip_bits for s in self.spills)
                + self.streamed_weight_bits)

    def summary(self) -> dict:
        return {
            "n_spilled_edges": len(self.spills),
            "spill_offchip_bits": sum(s.offchip_bits for s in self.spills),
            "streamed_weight_bits": self.streamed_weight_bits,
            "static_weight_bits": self.static_weight_bits,
            "total_offchip_bits": self.total_offchip_bits,
        }


def _bfp8_offchip_bits(m: int, c: int, block: int = BFP8_BLOCK) -> int:
    """Mantissa + shared-exponent bits of a (m, c) stripe, after padding the
    channel axis to the codec block (same rounding as _bfp8_roundtrip)."""
    c_pad = _round_up(c, block)
    return m * c_pad * 8 + m * (c_pad // block) * 8


# =============================================================================
# Vertex semantics
# =============================================================================

def _exec_spec(g: Graph, name: str) -> dict:
    v = g.vertex(name)
    spec = v.meta.get("exec")
    if spec is None:
        raise ValueError(
            f"vertex {name!r} has no meta['exec'] — executable lowering "
            f"needs graphs built by core.builders.build_*_exec")
    return spec


def _weight_shape(g: Graph, name: str) -> tuple[int, int]:
    spec = _exec_spec(g, name)
    if g.vertex(name).kind in TEMPORAL_KINDS:
        return (spec.get("taps", 3), spec["cout"])
    return (spec["cin"], spec["cout"])


def _device_of(device, name: str):
    """A vertex's device: ``device`` itself, or its entry for ``name`` where
    ``device`` maps vertices to devices (a ring's stage placement)."""
    return device[name] if isinstance(device, Mapping) else device


def init_params(g: Graph, seed: int = 0,
                device: str | torch.device | Mapping = "cpu"
                ) -> dict[str, torch.Tensor]:
    """Deterministic per-vertex weights for every weighty executable op.

    Each vertex draws from its own CPU ``torch.Generator`` seeded with the
    CRC32 of ``seed`` and its name, and the weights are then moved to
    ``device``, so the CPU and the card hold the same weights.  ``device``
    may map each vertex to its own device (a pipelined ring's
    ``StreamingExecutor.vertex_devices``: stage ``j``'s weights on stage
    ``j``'s device).  They differ from the reference package's
    ``jax.random`` weights; carry those over with :func:`params_from_numpy`.
    """
    params: dict[str, torch.Tensor] = {}
    for v in g.vertices():
        if v.kind not in WEIGHT_KINDS and v.kind not in TEMPORAL_KINDS:
            continue
        gen = torch.Generator().manual_seed(
            zlib.crc32(f"{seed}/{v.name}".encode()))
        shape = _weight_shape(g, v.name)
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        params[v.name] = (w * (1.0 / math.sqrt(shape[0]))).to(
            _device_of(device, v.name))
    return params


def params_from_numpy(arrays: dict,
                      device: str | torch.device | Mapping = "cpu"
                      ) -> dict[str, torch.Tensor]:
    """Weights made elsewhere (e.g. the reference package's ``init_params``,
    as numpy arrays) as f32 tensors on ``device``, or on each vertex's
    device where ``device`` maps vertices to devices (as in
    :func:`init_params`)."""
    return {k: torch.from_numpy(np.array(a, dtype=np.float32)).to(
                _device_of(device, k))
            for k, a in arrays.items()}


def bfp8_spill_encode(x: torch.Tensor, *, use_kernels: bool):
    """Encode a (m, c) stripe to (mantissas, exponents), its channel axis
    padded with zeros to the codec block — the spill buffers that cross
    off-chip.  The kernel quantises the stripe in place of a padded copy."""
    width = _round_up(x.shape[1], BFP8_BLOCK)
    if use_kernels:
        return bfp8_quant(x, block=BFP8_BLOCK, width=width)
    return kref.bfp8_quant_ref(x, block=BFP8_BLOCK, width=width)


def bfp8_spill_decode(payload, c: int, *, use_kernels: bool,
                      dtype=torch.float32) -> torch.Tensor:
    """Decode spill buffers back to a (m, c) stripe (drops block padding);
    the kernel writes the c channels alone, with no cut copy."""
    man, exp = payload
    if use_kernels:
        return bfp8_dequant(man, exp, block=BFP8_BLOCK, c=c, dtype=dtype)
    return kref.bfp8_dequant_ref(man, exp, block=BFP8_BLOCK, c=c,
                                 dtype=dtype)


def _bfp8_roundtrip(x: torch.Tensor, *, use_kernels: bool) -> torch.Tensor:
    """Quantise->dequantise a (m, c) stripe through the BFP8 codec, composed
    from the same encode/decode halves the kernel route uses."""
    payload = bfp8_spill_encode(x, use_kernels=use_kernels)
    return bfp8_spill_decode(payload, x.shape[1], use_kernels=use_kernels,
                             dtype=x.dtype)


# =============================================================================
# Static plan analysis
# =============================================================================

@dataclasses.dataclass
class PlanAnalysis:
    """Everything ``lower_plan`` derives from (graph, plan) before running."""
    topo: list[str]                               # deterministic vertex order
    out_shape: dict[str, tuple[int, int]]         # per-vertex (m, c)
    spills: list[SpillRecord]
    spill_fn: dict[tuple[str, str], Callable]     # per spilled edge numerics
    frac: dict[str, float]                        # weight_static_fraction
    stage_of: dict[str, int]                      # vertex -> stage index
    streamed_weight_bits: int
    static_weight_bits: int
    use_kernels: bool
    in_vertex: str
    in_shape: tuple[int, int]
    #: evicted edges carrying a BFP8 spill — the payload-routed set the
    #: kernel route encodes once per producer / decodes per consumer
    bfp8_edges: set = dataclasses.field(default_factory=set)
    #: the plan's kernel tiles (0 = kernel default): row block and, for the
    #: conv family, column block; launch parameters on the card, ignored by
    #: the plain versions (``kernels/streaming_conv.py``)
    tile_bm: int = 0
    tile_bc: int = 0

    @property
    def n_stages(self) -> int:
        return max(self.stage_of.values(), default=0) + 1

    def report(self) -> SpillReport:
        return SpillReport(spills=list(self.spills),
                           streamed_weight_bits=self.streamed_weight_bits,
                           static_weight_bits=self.static_weight_bits)


def analyze_plan(g: Graph, plan: ExecutionPlan | None, *,
                 use_kernels: bool) -> PlanAnalysis:
    """Static analysis: shapes, spill records/functions, weight traffic."""
    layers = plan.layers if plan is not None else {}
    stream_map = ({(s.src, s.dst): s for s in plan.streams}
                  if plan is not None else {})

    topo = g.topo()
    out_shape: dict[str, tuple[int, int]] = {}
    for name in topo:
        spec = _exec_spec(g, name)
        out_shape[name] = (spec.get("m_out", spec["m"]), spec["cout"])

    stage_of = {n: (layers[n].stage if n in layers else 0) for n in topo}

    spills: list[SpillRecord] = []
    spill_fn: dict[tuple[str, str], Callable] = {}
    bfp8_edges: set = set()
    for e in g.edges():
        u, w = e.src, e.dst
        s = stream_map.get((u, w))
        evicted = bool(s.evicted) if s is not None else False
        codec = s.codec if s is not None else "none"
        cross_stage = stage_of[u] != stage_of[w]
        if not (evicted or cross_stage):
            continue
        m, c = out_shape[u]
        raw_bits = m * c * e.word_bits
        if evicted and codec == "bfp8":
            off_bits, exact = _bfp8_offchip_bits(m, c), True
            fn = functools.partial(_bfp8_roundtrip, use_kernels=use_kernels)
            bfp8_edges.add((u, w))
        elif evicted and codec not in LOSSLESS_CODECS:
            raise ValueError(f"unsupported eviction codec {codec!r} "
                             f"on edge {(u, w)}")
        else:
            # lossless codecs: numerics are identity; traffic is the raw
            # volume (codec "none") — RLE/Huffman would shrink it by a
            # data-dependent ratio the DSE only estimates, so we report
            # the conservative raw volume and flag it non-exact.
            off_bits = raw_bits
            exact = codec == "none"
            fn = lambda x: x                                    # noqa: E731
        spills.append(SpillRecord(
            src=u, dst=w, codec=codec,
            reason="evicted" if evicted else "stage_boundary",
            raw_bits=raw_bits, offchip_bits=off_bits, exact=exact))
        spill_fn[(u, w)] = fn

    streamed_bits = static_bits = 0
    frac: dict[str, float] = {}
    for name in topo:
        v = g.vertex(name)
        if v.kind not in WEIGHT_KINDS and v.kind not in TEMPORAL_KINDS:
            continue
        lp = layers.get(name)
        f = lp.weight_static_fraction if lp is not None else 1.0
        frac[name] = f
        rows, cols = _weight_shape(g, name)
        wbits = rows * cols * v.weight_bits
        static_bits += int(round(f * wbits))
        streamed_bits += int(round((1.0 - f) * wbits))

    in_vertex = next(n for n in topo if g.vertex(n).kind == "input")
    return PlanAnalysis(
        topo=topo, out_shape=out_shape, spills=spills, spill_fn=spill_fn,
        frac=frac, stage_of=stage_of, streamed_weight_bits=streamed_bits,
        static_weight_bits=static_bits, use_kernels=use_kernels,
        in_vertex=in_vertex, in_shape=out_shape[in_vertex],
        bfp8_edges=bfp8_edges,
        tile_bm=(plan.tile_bm if plan is not None else 0),
        tile_bc=(plan.tile_bc if plan is not None else 0))


def apply_vertex(v, ins: list[torch.Tensor], params: dict,
                 x: torch.Tensor | None, analysis: PlanAnalysis
                 ) -> torch.Tensor:
    """Execute one vertex's semantics — the single source of truth for what
    each op kind *does*.

    On the kernel route, conv/matmul/deconv, dwconv, pool and act go
    through the ``kernels/streaming_conv`` wrappers, and fragmented weight
    layers through ``streamed_matmul``; data-movement and variadic kinds
    (upsample/add/mul/concat/output) run their plain bodies on both routes.
    """
    an = analysis
    if v.kind == "input":
        if x is None:
            raise ValueError("input vertex fed without a graph input")
        return x
    if v.kind in WEIGHT_KINDS:
        h = ins[0]
        f = an.frac.get(v.name, 1.0)
        if f < 1.0 and an.use_kernels:
            return streamed_matmul_padded(h, params[v.name],
                                          static_fraction=f)
        if an.use_kernels:
            return SC.conv2d(h, params[v.name], bm=an.tile_bm,
                             bc=an.tile_bc)
        return kref.conv2d_ref(h, params[v.name])
    if v.kind in TEMPORAL_KINDS:
        # the temporal split is not streamable through the matmul kernel;
        # a fragmented dwconv streams per the plan's traffic accounting but
        # executes the full (numerically identical) temporal mix.
        if an.use_kernels:
            return SC.dwconv(ins[0], params[v.name], bm=an.tile_bm)
        return kref.dwconv_ref(ins[0], params[v.name])
    if v.kind == "act":
        if an.use_kernels:
            return SC.act_relu(ins[0], bm=an.tile_bm)
        return kref.act_relu_ref(ins[0])
    if v.kind == "pool":
        if an.use_kernels:
            return SC.pool(ins[0], an.out_shape[v.name][0], bm=an.tile_bm)
        return kref.pool_ref(ins[0], an.out_shape[v.name][0])
    if v.kind == "upsample":
        return kref.upsample_ref(ins[0], an.out_shape[v.name][0])
    if v.kind == "add":
        return functools.reduce(torch.add, ins)
    if v.kind == "mul":
        return functools.reduce(torch.mul, ins)
    if v.kind == "concat":
        return torch.cat(ins, dim=1)
    if v.kind == "output":
        return torch.cat([i.reshape(-1) for i in ins])
    raise ValueError(f"op kind {v.kind!r} has no executable lowering")


# =============================================================================
# Kernel-level vertex lowering: fused BFP8 boundary codec
# =============================================================================

#: kinds whose kernel wrapper can fuse the BFP8 boundary codec (mirrors
#: kernels.ops.fusable_kinds())
FUSABLE_KINDS = ("conv", "deconv", "matmul", "dwconv", "pool", "act")


@dataclasses.dataclass(frozen=True)
class VertexLowering:
    """``_lower_vertex``'s decision record for one vertex under the
    resolved kernel mode."""
    fuse_in: tuple[str, str] | None  # bfp8 in-edge decoded inside the kernel
    fuse_out: bool                   # kernel also emits the spill payload
    needs_payload: bool              # some out-edge carries a bfp8 spill


def _lower_vertex(g: Graph, name: str, an: PlanAnalysis) -> VertexLowering:
    """Decide one vertex's kernel-level lowering: on the kernel route a
    fusable kind with an un-fragmented weight fuses a *single* BFP8-evicted
    input edge (ingress dequant inside its kernel) and/or emits its output's
    spill payload from the same launch (egress quant).  Multi-input
    consumers and fragmented weight layers use the standalone
    ``bfp8_spill_decode``/``bfp8_spill_encode`` instead."""
    v = g.vertex(name)
    needs_payload = an.use_kernels and any(
        (name, s) in an.bfp8_edges for s in g.successors(name))
    fusable = (an.use_kernels and v.kind in FUSABLE_KINDS
               and not (v.kind in WEIGHT_KINDS
                        and an.frac.get(name, 1.0) < 1.0))
    fuse_in = None
    if fusable:
        in_edges = g.in_edges(name)
        if len(in_edges) == 1 and (in_edges[0].src, name) in an.bfp8_edges:
            fuse_in = (in_edges[0].src, name)
    return VertexLowering(fuse_in=fuse_in,
                          fuse_out=fusable and needs_payload,
                          needs_payload=needs_payload)


def launch_table(g: Graph, plan: ExecutionPlan) -> dict[str, int]:
    """Launches per frame of each kernel on the kernel route of the staged
    executor, read from the lowering (``analyze_plan`` / ``_lower_vertex``)
    without running it: a vertex that decodes its input edge or encodes
    its output inside its own launch counts under ``<kernel>_decode``,
    ``<kernel>_encode`` or ``<kernel>_decode_encode``; ``plain_dot`` is the
    ``torch.matmul`` of a fragmented layer whose K pads to 128 or less,
    which launches no kernel.  Kernels that a frame does not launch are
    left out."""
    an = analyze_plan(g, plan, use_kernels=True)
    counts: collections.Counter = collections.Counter()
    for name in an.topo:
        v, lv = g.vertex(name), _lower_vertex(g, name, an)
        fused = (("_decode" if lv.fuse_in else "")
                 + ("_encode" if lv.fuse_out else ""))
        counts["bfp8_dequant"] += sum(
            (e.src, name) in an.bfp8_edges and (e.src, name) != lv.fuse_in
            for e in g.in_edges(name))
        if lv.needs_payload and not lv.fuse_out:
            counts["bfp8_quant"] += 1
        if v.kind in WEIGHT_KINDS and an.frac[name] < 1.0:
            counts["streamed_matmul" if v.meta["exec"]["cin"] > 128
                   else "plain_dot"] += 1
        elif v.kind in WEIGHT_KINDS:
            counts["conv2d" + fused] += 1
        elif v.kind in TEMPORAL_KINDS + ("pool",):
            counts[v.kind + fused] += 1
        elif v.kind == "act":
            counts["act_relu" + fused] += 1
    return dict(+counts)


def apply_vertex_fused(v, ins, params, x, analysis: PlanAnalysis, *,
                       payload_in=None, want_payload: bool = False):
    """``apply_vertex`` with the fused BFP8 boundary codec.

    ``payload_in`` is the (mantissa, exponent) spill payload of the
    vertex's single input edge, decoded inside the kernel;
    ``want_payload=True`` asks the same launch to also quantise and emit
    the output's spill payload.  Returns ``(y, payload | None)``.  Callers
    consult :func:`_lower_vertex` for legality; with neither flag this is
    exactly ``apply_vertex``.
    """
    an = analysis
    if payload_in is None and not want_payload:
        return apply_vertex(v, ins, params, x, an), None
    if not (an.use_kernels and v.kind in FUSABLE_KINDS):
        raise ValueError(f"{v.kind!r} cannot fuse the codec on this route")
    xin = ins[0] if payload_in is None else None
    kw = dict(payload=payload_in, encode=want_payload, block=BFP8_BLOCK,
              bm=an.tile_bm)
    if v.kind in WEIGHT_KINDS:
        out = SC.conv2d(xin, params[v.name], bc=an.tile_bc, **kw)
    elif v.kind in TEMPORAL_KINDS:
        out = SC.dwconv(xin, params[v.name], **kw)
    elif v.kind == "pool":
        out = SC.pool(xin, an.out_shape[v.name][0],
                      c=an.out_shape[v.name][1], **kw)
    else:                       # act
        out = SC.act_relu(xin, c=an.out_shape[v.name][1], **kw)
    return out if want_payload else (out, None)


def run_vertices(g: Graph, an: PlanAnalysis, params: dict,
                 x: torch.Tensor | None, hop: "OffchipHop", *,
                 names: list[str] | None = None, external=None,
                 keep_all: bool = True) -> tuple[dict, dict]:
    """The per-vertex execution loop both executors run, in topo order.

    ``names`` is the topo-ordered subset to run (the whole graph by
    default); ``external(edge)`` resolves in-edges whose producer lies
    outside it (the pipelined streamer's decoded crossing reads).  An
    out-edge whose consumer lies outside ``names`` is a crossing: the
    caller hands it on, so nothing here spills it.

    Payload-routed BFP8 eviction: on the kernel route the producer of a
    BFP8-evicted edge encodes the spill once (fused into its kernel when
    :func:`_lower_vertex` allows) and every consumer decodes it (fused
    likewise, else via ``bfp8_spill_decode``); on the reference route every
    spilled edge round-trips through ``spill_fn`` — numerically the same
    composition either way.

    Every spill leaves when its producer runs (``hop.evict``) and each
    consumer brings back its own copy (``hop.restore``).  With
    ``keep_all=False`` a vertex's output is dropped as soon as the last
    vertex that reads it on the device has run, so a spilled stream holds no
    device memory between its producer and its consumers; the graph's last
    vertex is kept, and so is an output that a crossing edge carries raw,
    until the caller has read it.  Returns ``(values, payloads)``: the
    outputs still held (with ``keep_all`` every vertex's, for naming the
    first vertex where two executors part) and, by producer, the BFP8
    payloads that a crossing edge carries on the kernel route.
    """
    names = an.topo if names is None else names
    internal = set(names)
    payload_routed = an.bfp8_edges if an.use_kernels else set()
    last_read: dict[str, int] = {}      # producer -> index of its last reader
    for i, name in enumerate(names):
        for e in g.in_edges(name):
            if e.src in internal and (e.src, name) not in an.spill_fn:
                last_read[e.src] = i
    for name in names:
        if any(s not in internal and (name, s) not in payload_routed
               for s in g.successors(name)):
            last_read[name] = len(names)            # read by the caller
    values: dict[str, torch.Tensor] = {}
    payloads: dict[str, tuple] = {}     # producer -> crossing BFP8 payload
    host: dict = {}                     # spill key -> off-chip handle
    for i, name in enumerate(names):
        v = g.vertex(name)
        lv = _lower_vertex(g, name, an)
        ins, payload_in = [], None
        for e in g.in_edges(name):      # predecessor order = operand order
            edge = (e.src, name)
            if e.src not in internal:
                ins.append(external(edge))
            elif edge in payload_routed:
                pay = hop.restore(host[e.src])
                if lv.fuse_in == edge:
                    payload_in = pay
                    ins.append(None)
                else:
                    ins.append(bfp8_spill_decode(
                        pay, an.out_shape[e.src][1], use_kernels=True))
            elif edge in an.spill_fn:
                ins.append(hop.restore(host[edge])[0])
            else:
                ins.append(values[e.src])
        y, pay = apply_vertex_fused(v, ins, params, x, an,
                                    payload_in=payload_in,
                                    want_payload=lv.fuse_out)
        # the inputs' restored and decoded copies end with the op, before
        # the output's encode allocates
        del ins, payload_in
        if lv.needs_payload:
            if pay is None:
                pay = bfp8_spill_encode(y, use_kernels=True)
            routed = [s for s in g.successors(name)
                      if (name, s) in payload_routed]
            if any(s in internal for s in routed):
                host[name] = hop.evict(name, pay)
            if any(s not in internal for s in routed):
                payloads[name] = pay
        for s in g.successors(name):
            edge = (name, s)
            if (s in internal and edge in an.spill_fn
                    and edge not in payload_routed):
                host[edge] = hop.evict(edge, (an.spill_fn[edge](y),))
        values[name] = y
        # drop this step's references, so only `values`, `host` and
        # `payloads` hold data
        del pay, y
        if not keep_all:
            for src in [e.src for e in g.in_edges(name)] + [name]:
                if last_read.get(src, -1) <= i and src != an.topo[-1]:
                    values.pop(src, None)
    return values, payloads


# =============================================================================
# Lowering
# =============================================================================

@dataclasses.dataclass
class LoweredPipeline:
    """An executable form of one ExecutionPlan.

    ``fn(params, x)`` runs the whole streaming pipeline; ``report`` is the
    static off-chip traffic accounting the lowering derived from the plan;
    ``graph`` and ``analysis`` are what the lowering ran on, so that a check
    can apply one vertex's plain version to another route's values
    (``testing.oracle.vertex_parity``).
    """
    fn: Callable[[dict, torch.Tensor], torch.Tensor]
    params: dict[str, torch.Tensor]
    report: SpillReport
    plan: ExecutionPlan | None
    graph_name: str
    device: torch.device
    values_fn: Callable[[dict, torch.Tensor], dict]
    graph: Graph
    analysis: PlanAnalysis

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.params, x)

    def run_intermediates(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every vertex's output for one frame, in topo order — for naming
        the *first* vertex where two executors' numerics part."""
        return self.values_fn(self.params, x)

    def run_traced(self, x: torch.Tensor, recorder=None) -> torch.Tensor:
        """Run one frame, recording a ``frame`` span plus spill counters.

        The staged executor has no tick structure, so the telemetry is one
        host-side wall-clock span per frame and one ``emit_spill_counters``
        round-trip per :class:`SpillRecord` (every evicted edge crosses
        off-chip exactly once per frame here).  On a CUDA device the span
        closes after a synchronise, so it measures the frame and not its
        launches.  With ``recorder=None`` this is exactly ``self(x)``.
        """
        from ..obs.stream import emit_spill_counters
        from ..obs.trace import NULL_RECORDER

        rec = NULL_RECORDER if recorder is None else recorder
        with rec.span("frame", track="host",
                      args={"graph": self.graph_name}):
            y = self.fn(self.params, x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        ts = rec.now()
        for r in self.report.spills:
            emit_spill_counters(rec, r, ts=ts)
        return y


def resolve_kernel_mode(kernel_mode: str, device: torch.device) -> bool:
    """Whether the pipeline takes the kernel route (``use_kernels``)."""
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}; pick one of "
                         f"{KERNEL_MODES}")
    if kernel_mode == "cuda" and device.type != "cuda":
        raise ValueError(f'kernel_mode="cuda" needs a CUDA device, got '
                         f'{device}')
    return kernel_mode != "reference"


class OffchipHop:
    """The off-chip crossing of spilled tensors.

    ``evict(key, tensors)`` sends one spill off the device when its producer
    runs and returns its off-chip handle; ``restore(handle)`` brings a copy
    back to the device for one consumer.  On a CUDA device the handle is a
    set of pinned host buffers, one set per spill key, allocated when the
    pipeline is lowered, and both copies are enqueued on the current stream.
    The producer's device copy may be freed once its eviction is enqueued:
    the caching allocator hands that memory only to work ordered after the
    copy.  A frame writes each buffer once and its consumers read it; the
    next frame's write is ordered after those reads on the same stream, and
    the host never touches the buffers.  Neither argument holds where
    producer and consumer run on two streams (the pipelined ring: a hop a
    stage, each stage on its own device and stream, a consumer restoring
    with its own hop a handle its producer's hop wrote): there the caller
    orders each eviction before its restore, and each restore before the
    next eviction into the same buffers, with events.  On the CPU a handle
    is the tensors themselves and both directions are identity."""

    def __init__(self, device: torch.device, slots: dict):
        self.device = device
        self._buffers = None
        if device.type == "cuda":
            self._buffers = {
                key: tuple(torch.empty(s, dtype=dt, pin_memory=True)
                           for s, dt in specs)
                for key, specs in slots.items()}

    def evict(self, key, tensors: tuple) -> tuple:
        if self._buffers is None:
            return tuple(tensors)
        bufs = self._buffers[key]
        for buf, t in zip(bufs, tensors, strict=True):
            buf.copy_(t, non_blocking=True)
        return bufs

    def restore(self, handle: tuple) -> tuple:
        if self._buffers is None:
            return handle
        return tuple(torch.empty(b.shape, dtype=b.dtype, device=self.device)
                     .copy_(b, non_blocking=True) for b in handle)


def _spill_slots(an: PlanAnalysis) -> dict:
    """(shape, dtype) of every tensor that crosses off-chip in one frame, by
    spill key: a producer's BFP8 payload on the kernel route (shared by its
    consumers), else the spilled edge."""
    slots: dict = {}
    for r in an.spills:
        m, c = an.out_shape[r.src]
        if an.use_kernels and (r.src, r.dst) in an.bfp8_edges:
            c_pad = _round_up(c, BFP8_BLOCK)
            slots[r.src] = [((m, c_pad), torch.int8),
                            ((m, c_pad // BFP8_BLOCK), torch.int8)]
        else:
            slots[(r.src, r.dst)] = [((m, c), torch.float32)]
    return slots


def lower_plan(g: Graph, plan: ExecutionPlan | None = None, *,
               kernel_mode: str = "auto", seed: int = 0,
               device: str | torch.device = "cuda") -> LoweredPipeline:
    """Lower ``plan`` over executable graph ``g`` to a runnable pipeline on
    ``device``.

    plan=None lowers the dense reference: no eviction, no fragmentation,
    one stage — the numerical baseline every plan must match (lossless
    codecs) or approximate (BFP8).  ``kernel_mode`` is described in the
    module docstring.  On a CUDA device the plain matmuls are pinned to full
    f32 (TF32 off), the precision of the reference package.
    """
    device = torch.device(device)
    use_kernels = resolve_kernel_mode(kernel_mode, device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    an = analyze_plan(g, plan, use_kernels=use_kernels)
    hop = OffchipHop(device, _spill_slots(an))

    @torch.no_grad()
    def forward_values(params: dict, x: torch.Tensor, keep_all: bool = True
                       ) -> dict[str, torch.Tensor]:
        if tuple(x.shape) != an.in_shape:
            # every op downstream is shape-agnostic on the position axis, so
            # a wrong-m input would execute silently while the SpillReport
            # described the declared shapes — refuse instead
            raise ValueError(
                f"input shape {tuple(x.shape)} does not match the graph's "
                f"input spec {an.in_shape} for {g.name!r}")
        return run_vertices(g, an, params, x, hop, keep_all=keep_all)[0]

    def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
        return forward_values(params, x, keep_all=False)[an.topo[-1]]

    return LoweredPipeline(fn=forward,
                           params=init_params(g, seed=seed, device=device),
                           report=an.report(), plan=plan, graph_name=g.name,
                           device=device, values_fn=forward_values,
                           graph=g, analysis=an)


def reference_pipeline(g: Graph, *, seed: int = 0,
                       device: str | torch.device = "cuda"
                       ) -> LoweredPipeline:
    """The dense, un-evicted, un-fragmented baseline pipeline."""
    return lower_plan(g, None, kernel_mode="reference", seed=seed,
                      device=device)
