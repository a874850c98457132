"""The SMOF compile façade of the PyTorch port: ``CompileSpec`` ->
``Compiled``.

One entry point takes a CNN graph plus a DSE target sheet and returns a
runnable streaming design with the off-chip eviction decisions baked in:

    import repro_torch

    compiled = repro_torch.compile(repro_torch.CompileSpec(
        model="unet_exec", device="u200", mode="staged"))
    y = compiled.run(x)                    # one (m, c) frame -> (L,)
    print(compiled.report())               # traffic + plan provenance

    stream = repro_torch.compile(repro_torch.CompileSpec(
        model="yolo_head_exec", device="u200", mode="pipelined",
        microbatches=8))
    ys = stream.run(xs)                    # a (8, m, c) stream -> (8, L)

    compiled.save("unet.smof.json")        # the versioned plan artifact
    again = repro_torch.Compiled.load("unet.smof.json")   # on the card
    again.run(x)                           # bit-identical (seeded weights)

    srv = stream.serve(resident_limit=4)   # batched streaming front end
    t = srv.submit(frame); srv.flush(); y = srv.result(t)
    ys, mc = stream.trace(xs, path="yolo.trace.json")   # Chrome trace
    print(stream.metrics_text())           # Prometheus exposition

The artifact is the reference package's (``ARTIFACT_KIND``, schema 1, the
same keys), so each package loads the other's: see :meth:`Compiled.save`.

Spec knobs
----------
``device``       the DSE target sheet (``core.resources.ALL_DEVICES``), as
                 in the reference package.
``torch_device`` where the tensors live (``"cuda"`` by default).
``kernel_mode``  ``auto`` (kernels on a CUDA device, their plain versions
                 on the CPU), ``cuda`` (``auto`` that refuses the CPU) or
                 ``reference`` (plain bodies only).
``strategy``     ``dse`` (Algorithm 1) or ``manual-plan``.
``mode``         ``reference`` (dense baseline), ``staged`` (the
                 sequential executor, Eq. 5) or ``pipelined`` (the 1F1B
                 streamer over a microbatch stream, Eq. 6).
``microbatches`` recorded in the plan; the pipelined stream depth B.
``placement``    chooses nothing yet: it exists so that artifacts and the
                 reference façade stay in step until ROADMAP.md Queue 1,
                 item 10 ports the multi-GPU placement.  ``auto`` and
                 ``interleave`` both run every stage on one GPU;
                 ``shard_map`` (one stage per GPU) raises.
``channel``      opt-in off-chip channel model (``repro_torch.memory``):
                 the pipelined report then carries the contended Eq. 5/6
                 bounds and the prefetch deadline accounting.
``obs``          telemetry (:class:`~repro_torch.obs.trace.ObsConfig`): the
                 trace path, the SLO targets a server scores against, the
                 flight recorder.
``seed``         fixes the per-vertex weights.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from .core.builders import exec_input_shape, get_model
from .core.dse import DSEConfig, run_dse
from .core.graph import Graph
from .core.plan import ExecutionPlan, PLAN_SCHEMA_VERSION, plan_from_dse
from .core.resources import Device, get_device
from .memory import ChannelConfig
from .obs.metrics import MetricsRegistry
from .obs.trace import ObsConfig, TraceRecorder
from .runtime.executor import (KERNEL_MODES, LoweredPipeline, lower_plan,
                               reference_pipeline)
from .runtime.streamer import (PLACEMENTS, StreamingExecutor,
                               lower_plan_pipelined)

MODES = ("reference", "staged", "pipelined")
STRATEGIES = ("dse", "autotune", "manual-plan")

ARTIFACT_KIND = "smof-compiled"
ARTIFACT_SCHEMA_VERSION = 1
# kernel_mode in an artifact: the reference package's names.  Its "pallas"
# (the kernel route, in interpret mode off the TPU) is the port's "cuda" on
# the card and its "auto" on the CPU, where the kernel route runs the
# kernels' plain versions.
_ARTIFACT_KERNEL_MODE = {"auto": "auto", "cuda": "pallas",
                         "reference": "reference"}

# The default executable-path DSE configuration: eviction + fragmentation
# friendly settings at 16-bit stream words (the reference package's).
_DEFAULT_DSE = DSEConfig(batch=1, codecs=("none", "bfp8"), word_bits=16,
                         cut_kinds=("pool", "conv"))


def kernel_route(torch_device) -> str:
    """The port's ``kernel_mode`` for the reference's ``"pallas"`` (the
    kernel route) on ``torch_device``: ``"cuda"`` on the card, ``"auto"``
    on the CPU."""
    return "cuda" if torch.device(torch_device).type == "cuda" else "auto"


@dataclasses.dataclass
class CompileSpec:
    """Everything the toolflow needs to go graph + device -> executable.

    ``model`` is a registry name (``EXEC_MODELS`` / ``PAPER_MODELS``) or an
    already-built :class:`~repro_torch.core.graph.Graph`; ``device`` a
    registry name or a :class:`~repro_torch.core.resources.Device`.
    """
    model: str | Graph
    device: str | Device = "u200"
    strategy: str = "dse"              # dse | manual-plan
    mode: str = "staged"               # reference | staged | pipelined
    kernel_mode: str = "auto"          # auto | cuda | reference
    microbatches: int = 8              # pipelined stream depth B
    seed: int = 0
    plan: ExecutionPlan | None = None  # strategy="manual-plan" input
    dse: DSEConfig | None = None       # strategy="dse" knobs
    torch_device: str = "cuda"
    placement: str = "auto"            # chooses nothing yet (see above)
    #: opt-in off-chip channel model (``repro_torch.memory``): arbitration
    #: policy + optional gbps override; pipelined lowerings then carry the
    #: contended Eq. 5/6 bounds and prefetch deadline accounting.
    channel: ChannelConfig | None = None
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; pick one of "
                             f"{MODES}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; pick one "
                             f"of {STRATEGIES}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r}; pick "
                             f"one of {PLACEMENTS}")
        if self.mode == "pipelined" and self.placement == "shard_map":
            raise NotImplementedError(
                'placement="shard_map" (one stage per GPU) is not ported '
                "yet; see ROADMAP.md, Queue 1, item 10")
        if self.strategy == "autotune":
            raise NotImplementedError(
                'strategy="autotune" is not ported yet; see ROADMAP.md, '
                "Queue 1")
        if self.kernel_mode not in KERNEL_MODES:
            raise ValueError(f"unknown kernel_mode {self.kernel_mode!r}; "
                             f"pick one of {KERNEL_MODES}")
        if (self.strategy == "manual-plan" and self.plan is None
                and self.mode != "reference"):
            raise ValueError('strategy="manual-plan" needs spec.plan '
                             '(mode="reference" is the plan-free baseline)')
        if self.microbatches < 1:
            raise ValueError(f"need >= 1 microbatch, got {self.microbatches}")


def _resolve_graph(spec: CompileSpec) -> Graph:
    if isinstance(spec.model, Graph):
        return spec.model
    return get_model(spec.model)()


def _resolve_device(spec: CompileSpec) -> Device:
    if isinstance(spec.device, Device):
        return spec.device
    return get_device(spec.device)


def _device_name(spec: CompileSpec, plan: ExecutionPlan | None) -> str:
    if isinstance(spec.device, Device):
        return spec.device.name
    if spec.strategy == "manual-plan" and plan is not None and plan.device:
        return plan.device          # the plan's own record wins
    return spec.device


def build_plan(spec: CompileSpec, graph: Graph | None = None
               ) -> ExecutionPlan | None:
    """Resolve the spec's decision vector (``None`` for
    ``mode="reference"``), stamped with its provenance."""
    spec.validate()
    g = graph if graph is not None else _resolve_graph(spec)
    if spec.mode == "reference":
        return None
    if spec.strategy == "manual-plan":
        plan = spec.plan
        plan.validate()
    else:                                     # "dse": Algorithm 1
        dev = _resolve_device(spec)
        res = run_dse(g, dev, spec.dse or _DEFAULT_DSE)
        plan = plan_from_dse(g.name, dev.name, res,
                             microbatch=spec.microbatches)
    prov = {"compiled_by": "repro_torch.api.compile",
            "strategy": spec.strategy,
            "device": _device_name(spec, plan),
            "seed": spec.seed}
    for k, v in prov.items():
        plan.provenance.setdefault(k, v)
    return plan


def compile(spec: CompileSpec) -> "Compiled":
    """The toolflow entry point: resolve, search, lower — one call."""
    g = _resolve_graph(spec)
    plan = build_plan(spec, g)
    if spec.mode == "reference":
        executor = reference_pipeline(g, seed=spec.seed,
                                      device=spec.torch_device)
    elif spec.mode == "staged":
        executor = lower_plan(g, plan, kernel_mode=spec.kernel_mode,
                              seed=spec.seed, device=spec.torch_device)
    else:                                     # "pipelined"
        try:
            dev = _resolve_device(spec)
        except (KeyError, ValueError):
            dev = None
        executor = lower_plan_pipelined(
            g, plan, microbatches=spec.microbatches,
            kernel_mode=spec.kernel_mode, seed=spec.seed,
            placement=spec.placement, channel=spec.channel,
            channel_device=dev, device=spec.torch_device)
    return Compiled(spec=spec, graph=g, device=_device_name(spec, plan),
                    plan=plan, executor=executor)


@dataclasses.dataclass
class Compiled:
    """A runnable compiled design: executor + plan + provenance.

    ``run`` executes, ``serve`` wraps the pipelined executor in a
    :class:`~repro_torch.serving.GraphStreamServer`, ``trace`` runs once
    with telemetry on, ``metrics`` / ``metrics_text`` read the artifact's
    one metrics registry, and ``save`` / ``load`` round-trip the artifact.
    """
    spec: CompileSpec
    graph: Graph
    device: str
    plan: ExecutionPlan | None
    executor: LoweredPipeline | StreamingExecutor
    model_check: object = None       # obs.ModelCheck, set by trace()
    recorder: object = None          # obs.TraceRecorder, set by trace()
    # one scrape surface per artifact: trace() and serve() both feed it
    registry: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)

    @property
    def model(self) -> str:
        return self.graph.name

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def strategy(self) -> str:
        if self.plan is not None and "strategy" in self.plan.provenance:
            return self.plan.provenance["strategy"]
        return self.spec.strategy

    def _on_device(self, x) -> torch.Tensor:
        """A frame or stream (tensor or array) on the executor's device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return x.to(self.executor.device)

    def run(self, x) -> torch.Tensor:
        """Staged / reference: one ``(m, c)`` frame (tensor or array) ->
        the flat ``(L,)`` output.  Pipelined: a ``(B, m, c)`` stream ->
        ``(B, L)``, or one ``(m, c)`` frame, broadcast through the stream
        (every slot computes the same frame) -> ``(L,)``."""
        x = self._on_device(x)
        if self.mode == "pipelined" and x.dim() == 2:
            B = self.executor.microbatches
            return self.executor(x.expand((B,) + tuple(x.shape)))[0]
        return self.executor(x)

    def input_shape(self) -> tuple[int, int]:
        return exec_input_shape(self.graph)

    def report(self) -> dict:
        out = {
            "model": self.model,
            "device": self.device,
            "torch_device": str(self.executor.device),
            "mode": self.mode,
            "strategy": self.strategy,
            "kernel_mode": self.spec.kernel_mode,
            "schema_version": (self.plan.schema_version if self.plan
                               else PLAN_SCHEMA_VERSION),
            "n_stages": self.plan.n_stages if self.plan else 1,
            "traffic": self.executor.report.summary(),
        }
        if self.plan is not None:
            out["provenance"] = dict(self.plan.provenance)
        if self.model_check is not None:
            out["model_check"] = self.model_check.summary()
        return out

    def metrics(self) -> dict:
        """The artifact's metrics snapshot (``{sample_key: value}``).

        Every traced run (:meth:`trace`) and every server built by
        :meth:`serve` feeds the artifact's one
        :class:`~repro_torch.obs.metrics.MetricsRegistry`, so this is the
        whole design's scrape surface; :meth:`metrics_text` is the
        Prometheus exposition of the same registry.
        """
        return self.registry.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics`."""
        return self.registry.metrics_text()

    # -- tracing --------------------------------------------------------------
    def trace(self, x=None, *, path=None, recorder=None):
        """Execute once with telemetry on; returns ``(outputs, ModelCheck)``.

        Pipelined designs run tick by tick through
        ``StreamingExecutor.run_traced`` — per-tick wall-clock spans, queue
        counters, spill bytes, all into the artifact's registry too — and
        yield a full :class:`~repro_torch.obs.modelcheck.ModelCheck`
        (measured vs Eq. 5/6 latencies, Eq. 1 queue bounds), which later
        :meth:`report` calls include.  Staged and reference designs record
        one frame span plus spill counters and yield ``model_check=None``.

        ``x=None`` makes a seeded input (numpy, from ``spec.seed``);
        ``path`` (default: ``spec.obs.trace_path``) writes the Chrome
        trace-event JSON.  With ``spec.obs.flight_capacity > 0`` the
        default recorder is a bounded
        :class:`~repro_torch.obs.flight.FlightRecorder` ring instead, which
        dumps to ``spec.obs.flight_path`` if the run's ModelCheck comes
        back violated.
        """
        if recorder is not None:
            rec = recorder
        elif self.spec.obs.flight_capacity > 0:
            from .obs.flight import FlightRecorder
            rec = FlightRecorder(self.spec.obs.flight_capacity,
                                 path=self.spec.obs.flight_path)
        else:
            rec = TraceRecorder()
        if x is None:
            m, c = self.input_shape()
            rng = np.random.default_rng(self.spec.seed)
            x = rng.normal(size=(m, c)).astype(np.float32)
        x = self._on_device(x)
        mc = None
        if self.mode == "pipelined":
            if x.dim() == 2:
                B = self.executor.microbatches
                x = x.expand((B,) + tuple(x.shape))
            y, mc = self.executor.run_traced(x, rec, metrics=self.registry)
        else:
            y = self.executor.run_traced(x, rec)
        self.model_check = mc
        self.recorder = rec
        if (mc is not None and getattr(rec, "path", None) is not None
                and hasattr(rec, "on_model_check")):
            rec.on_model_check(mc)       # flight ring: dump on violation
        path = path if path is not None else self.spec.obs.trace_path
        if path is not None and rec.enabled:
            rec.save(path)
        return y, mc

    # -- serving --------------------------------------------------------------
    def serve(self, *, resident_limit: int = 0, **kw):
        """Batched streaming front end around this design.

        Reuses the pipelined executor when this artifact is already
        pipelined and no overrides are given; otherwise re-lowers the same
        plan pipelined with ``kw`` applied as :class:`CompileSpec`
        overrides (e.g. ``microbatches=16``), with the same seed and so the
        same weights.  Unless overridden, the stream depth follows the
        current executor's.  ``resident_limit`` bounds the
        flushed-but-unclaimed results kept on the device (the oldest go to
        an exact host byte store).

        The server shares this artifact's metrics registry.  When
        ``spec.obs.slo`` is set, a rolling-window
        :class:`~repro_torch.obs.slo.SloEvaluator` is attached — roofline
        from the plan's calibrated provenance, spill bandwidth budget from
        the device sheet's ``offchip_gbps`` — and, with
        ``spec.obs.flight_capacity > 0``, an SLO breach dumps a
        :class:`~repro_torch.obs.flight.FlightRecorder` ring to
        ``spec.obs.flight_path``."""
        from .serving.engine import GraphStreamServer
        if self.mode != "pipelined" and self.plan is None:
            raise ValueError(
                'mode="reference" compiles are plan-free and cannot be '
                'served; compile with mode="staged"/"pipelined" (any '
                "strategy) to get a servable plan")
        if self.mode == "pipelined" and not kw:
            sx = self.executor
        else:
            kw.setdefault("microbatches",
                          getattr(self.executor, "microbatches",
                                  self.spec.microbatches))
            sx = compile(dataclasses.replace(
                self.spec, mode="pipelined", strategy="manual-plan",
                plan=self.plan, **kw)).executor
        srv = GraphStreamServer(executor=sx, metrics=self.registry,
                                resident_limit=resident_limit)
        if self.spec.obs.slo is not None:
            try:
                bw = _resolve_device(self.spec).offchip_gbps
            except (KeyError, ValueError):
                bw = None
            evaluator = srv.enable_slo(self.spec.obs.slo, bw_gbps=bw)
            if (self.spec.obs.flight_capacity > 0
                    and self.spec.obs.flight_path is not None):
                from .obs.flight import FlightRecorder
                flight = FlightRecorder(self.spec.obs.flight_capacity,
                                        path=self.spec.obs.flight_path)
                evaluator.on_breach.append(flight.on_slo_report)
                srv.flight = flight
        return srv

    # -- persistence ----------------------------------------------------------
    def save(self, path) -> pathlib.Path:
        """Write the versioned compile artifact (JSON) with the reference
        package's keys: the plan with its provenance, the graph structure
        (so a custom-built graph reloads without the model registry), and
        every spec knob :meth:`load` needs to re-lower it.  ``kernel_mode``
        is written in the reference's names (the port's ``"cuda"`` as
        ``"pallas"``) and ``interpret`` as null, so the reference package
        loads the artifact too."""
        path = pathlib.Path(path)
        B = (self.executor.microbatches if self.mode == "pipelined"
             else self.spec.microbatches)
        payload = {
            "artifact": ARTIFACT_KIND,
            "artifact_schema_version": ARTIFACT_SCHEMA_VERSION,
            "plan_schema_version": (self.plan.schema_version if self.plan
                                    else PLAN_SCHEMA_VERSION),
            "model": self.model,
            "device": self.device,
            "mode": self.mode,
            "strategy": self.strategy,   # decision origin: save/load-stable
            "kernel_mode": _ARTIFACT_KERNEL_MODE[self.spec.kernel_mode],
            "interpret": None,
            "microbatches": B,
            "seed": self.spec.seed,
            "placement": self.spec.placement,
            "obs": self.spec.obs.to_dict(),
            "channel": (self.spec.channel.to_dict()
                        if self.spec.channel is not None else None),
            "graph": self.graph.to_json_dict(),
            "plan": (json.loads(self.plan.to_json())
                     if self.plan is not None else None),
        }
        path.write_text(json.dumps(payload, indent=1))
        return path

    @staticmethod
    def load(path, *, torch_device: str = "cuda") -> "Compiled":
        """Reconstruct a saved artifact (this package's or the reference
        package's) and lower it on ``torch_device``.

        The artifact bakes the searched decisions in, so loading never
        re-runs the DSE (``strategy`` becomes ``"manual-plan"``) and
        rebuilds the graph from the embedded structural dump.  The weights
        come from the stored seed through this package's ``init_params``,
        so a reload is bit-identical to the compile that saved it; they are
        not the reference package's ``jax.random`` weights (carry those
        over with ``runtime.executor.params_from_numpy``)."""
        d = json.loads(pathlib.Path(path).read_text())
        if d.get("artifact") != ARTIFACT_KIND:
            raise ValueError(f"{path}: not a {ARTIFACT_KIND} artifact")
        if d.get("artifact_schema_version", 0) > ARTIFACT_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: artifact schema v{d['artifact_schema_version']} is "
                f"newer than this toolflow (v{ARTIFACT_SCHEMA_VERSION})")
        kernel_mode = d["kernel_mode"]
        if kernel_mode == "pallas":
            kernel_mode = kernel_route(torch_device)
        if kernel_mode not in KERNEL_MODES:
            raise ValueError(f"{path}: unknown kernel_mode {kernel_mode!r}")
        plan = (ExecutionPlan.from_json(json.dumps(d["plan"]))
                if d.get("plan") is not None else None)
        model = (Graph.from_json_dict(d["graph"]) if d.get("graph")
                 else d["model"])
        spec = CompileSpec(
            model=model, device=d["device"], strategy="manual-plan",
            mode=d["mode"], kernel_mode=kernel_mode,
            microbatches=d["microbatches"], seed=d["seed"],
            placement=d.get("placement", "auto"), plan=plan,
            channel=(ChannelConfig.from_dict(d["channel"])
                     if d.get("channel") else None),
            obs=ObsConfig.from_dict(d.get("obs") or {}),
            torch_device=torch_device)
        return compile(spec)
