"""ExecutionPlan — the contract between the SMOF DSE and the TPU runtime.

The DSE (core/dse.py) reasons about an abstract device; this module projects
its decisions onto concrete knobs the JAX runtime understands:

* partition list      -> staged-executor stages / PP stage boundaries
* eviction decisions  -> which long-lived streams (KV cache, encoder output,
                         1F1B stashes) are offloaded + their codec
* fragmentation m     -> per-layer static VMEM fraction for the
                         ``streamed_matmul`` kernel / host weight streaming
* parallelism p       -> per-layer sharding hints (TP width)
* remat policy        -> store / recompute / offload per activation class
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any

from .dse import DSEResult

_LOG = logging.getLogger(__name__)

# On-disk plan format version.  Bump when ExecutionPlan/LayerPlan/StreamPlan
# gain or change serialised fields; ``from_json`` migrates older payloads
# forward (v1 = pre-provenance plans, before schema_version existed).
PLAN_SCHEMA_VERSION = 2


class PlanValidationError(ValueError):
    """A structurally invalid :class:`ExecutionPlan`.

    Raised by :meth:`ExecutionPlan.validate` (and therefore by
    ``from_json`` and the compile façade for manual plans) instead of
    letting a malformed decision vector reach the lowering, where it
    would surface as an opaque crash deep inside the pipelined streamer
    (a backwards stage crossing, for example, would otherwise build a
    negative-depth shift register)."""


def _known_fields(cls) -> set[str]:
    return {f.name for f in dataclasses.fields(cls)}


def _shim_kwargs(cls, d: dict, dropped: list[str], scope: str) -> dict:
    """Migration shim: keep the keys ``cls`` knows, *collect* the rest.

    Plans serialised by newer versions of the toolflow still load (forward
    compatibility of the on-disk format), but unlike a silent filter every
    dropped key is recorded in ``dropped`` (and logged by ``from_json``), so
    forward-compat events are observable instead of invisible data loss."""
    known = _known_fields(cls)
    for k in d:
        if k not in known:
            dropped.append(f"{scope}.{k}")
    return {k: v for k, v in d.items() if k in known}


@dataclasses.dataclass
class LayerPlan:
    name: str
    stage: int = 0
    tp_parallelism: int = 1
    weight_static_fraction: float = 1.0    # 1 - m
    weight_stream_codec: str = "none"


@dataclasses.dataclass
class StreamPlan:
    src: str
    dst: str
    evicted: bool = False
    codec: str = "none"


@dataclasses.dataclass
class ExecutionPlan:
    model: str
    device: str
    n_stages: int
    layers: dict[str, LayerPlan]
    streams: list[StreamPlan]
    remat: str = "none"                    # none | dots | full | offload
    microbatch: int = 1
    est_throughput_fps: float = 0.0
    est_latency_s: float = 0.0
    # Deterministic schedule order: the graph's topological order at plan
    # time.  Dict-insertion order of ``layers`` is an accident of how the
    # partitioner walked the graph; the pipelined streamer needs a stable
    # stage-internal schedule, so ``stage_layers`` sorts by this list when
    # present (layers not in the list keep insertion order, appended last).
    topo_order: list[str] = dataclasses.field(default_factory=list)
    # Pallas kernel tile sizes for the streaming_conv bodies (0 = kernel
    # default): row block per grid step and, for the conv family, the
    # out-channel block.  Results are tile-independent (bit-exact for any
    # value — tests/test_properties.py), so these are pure performance
    # knobs the autotuner's "tile" move explores for pallas candidates.
    tile_bm: int = 0
    tile_bc: int = 0
    # On-disk format version + provenance of the decisions.  ``provenance``
    # is free-form JSON the toolflow stamps at compile time (strategy,
    # device name, calibration s_per_cycle, autotune trajectory digest, ...)
    # so a saved artifact explains where its decisions came from.
    schema_version: int = PLAN_SCHEMA_VERSION
    provenance: dict[str, Any] = dataclasses.field(default_factory=dict)

    # keys the from_json migration shim dropped (newer-writer forward
    # compat); instance attribute set by from_json, never serialised
    dropped_keys: tuple[str, ...] = dataclasses.field(
        default=(), repr=False, compare=False, metadata={"transient": True})

    # -- serialisation --------------------------------------------------------
    def to_json(self) -> str:
        def enc(o: Any):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            raise TypeError(type(o))
        d = dataclasses.asdict(self)
        d.pop("dropped_keys", None)            # transient, not on-disk format
        return json.dumps(d, default=enc, indent=1)

    @staticmethod
    def from_json(s: str) -> "ExecutionPlan":
        raw = json.loads(s)
        # v1 = pre-versioning plans (no schema_version field).  The loaded
        # plan is migrated to the *current* in-memory shape, so it carries
        # the current schema_version; the original is recorded in
        # provenance so the migration stays observable on re-serialise.
        orig_version = raw.get("schema_version", 1)
        raw["schema_version"] = PLAN_SCHEMA_VERSION
        dropped: list[str] = []
        d = _shim_kwargs(ExecutionPlan, raw, dropped, "plan")
        d["layers"] = {
            k: LayerPlan(**_shim_kwargs(LayerPlan, v, dropped, f"layers[{k}]"))
            for k, v in d["layers"].items()}
        d["streams"] = [
            StreamPlan(**_shim_kwargs(StreamPlan, v, dropped, f"streams[{i}]"))
            for i, v in enumerate(d["streams"])]
        plan = ExecutionPlan(**d)
        plan.dropped_keys = tuple(dropped)
        if orig_version != PLAN_SCHEMA_VERSION:
            plan.provenance.setdefault("migrated_from_schema_version",
                                       orig_version)
        if dropped:
            _LOG.warning(
                "ExecutionPlan.from_json (model=%r, schema v%s): dropped %d "
                "unknown key(s) written by a newer toolflow: %s",
                plan.model, orig_version, len(dropped), ", ".join(dropped))
        plan.validate()
        return plan

    # -- structural validation ------------------------------------------------
    def validate(self) -> None:
        """Reject decision vectors the lowering cannot execute.

        Checks the *plan-only* invariants (no graph needed): stage indices
        live in ``[0, n_stages)``, stage bounds are monotonic along every
        stream (an edge whose destination sits on an *earlier* stage than
        its source cannot be scheduled — the pipelined carry would need a
        negative delay), fragmentation fractions are in ``[0, 1]``, and the
        microbatch count is positive.  ``from_json`` calls this, so a
        corrupt or hand-edited artifact fails here with a typed
        :class:`PlanValidationError` instead of crashing the streamer.
        """
        errs: list[str] = []
        if self.n_stages < 1:
            errs.append(f"n_stages must be >= 1, got {self.n_stages}")
        if self.microbatch < 1:
            errs.append(f"microbatch must be >= 1, got {self.microbatch}")
        if self.tile_bm < 0:
            errs.append(f"tile_bm must be >= 0, got {self.tile_bm}")
        if self.tile_bc < 0:
            errs.append(f"tile_bc must be >= 0, got {self.tile_bc}")
        for name, lp in self.layers.items():
            if not 0 <= lp.stage < max(self.n_stages, 1):
                errs.append(f"layer {name!r} on stage {lp.stage}, outside "
                            f"[0, {self.n_stages})")
            if not 0.0 <= lp.weight_static_fraction <= 1.0:
                errs.append(f"layer {name!r} weight_static_fraction "
                            f"{lp.weight_static_fraction} outside [0, 1]")
            if lp.tp_parallelism < 1:
                errs.append(f"layer {name!r} tp_parallelism "
                            f"{lp.tp_parallelism} < 1")
        for s in self.streams:
            su, sv = self.layers.get(s.src), self.layers.get(s.dst)
            if su is not None and sv is not None and sv.stage < su.stage:
                errs.append(
                    f"stream {s.src}->{s.dst} crosses stages backwards "
                    f"({su.stage} -> {sv.stage}): stage bounds must be "
                    f"monotonic along every edge")
        if errs:
            raise PlanValidationError(
                f"invalid ExecutionPlan for model {self.model!r}: "
                + "; ".join(errs))

    def _order_key(self):
        pos = {n: i for i, n in enumerate(self.topo_order)}
        return lambda n: (pos.get(n, len(pos)),)

    def ordered_layers(self) -> list[str]:
        """All layer names in deterministic (topological) schedule order."""
        return sorted(self.layers, key=self._order_key())

    def stage_layers(self, stage: int) -> list[str]:
        return [n for n in self.ordered_layers()
                if self.layers[n].stage == stage]


def plan_from_dse(model: str, device: str, res: DSEResult,
                  remat: str = "none", microbatch: int = 1) -> ExecutionPlan:
    """Project a DSEResult into an ExecutionPlan."""
    g = res.partitioning.graph
    topo = g.topo()
    stage_of = {n: i for i, p in enumerate(res.partitioning.parts) for n in p}
    layers: dict[str, LayerPlan] = {}
    for n in topo:                         # deterministic insertion order too
        v = g.vertex(n)
        layers[n] = LayerPlan(
            name=n, stage=stage_of[n], tp_parallelism=v.par,
            weight_static_fraction=1.0 - v.frag_ratio,
            weight_stream_codec=v.meta.get("frag_codec", "none"),
        )
    streams = [StreamPlan(e.src, e.dst, e.evicted, e.codec) for e in g.edges()]
    return ExecutionPlan(
        model=model, device=device, n_stages=res.partitioning.n,
        layers=layers, streams=streams, remat=remat, microbatch=microbatch,
        est_throughput_fps=res.throughput_fps, est_latency_s=res.latency_s,
        topo_order=topo,
    )
