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
# obs in an artifact: the reference's default observability config, which
# asks for no telemetry.  The port has no telemetry yet, so it writes this
# and refuses to load any other (ROADMAP.md, Queue 1, item 5).
_DEFAULT_OBS = dict(enabled=False, trace_path=None, slo=None,
                    flight_capacity=0, flight_path=None)

# The default executable-path DSE configuration: eviction + fragmentation
# friendly settings at 16-bit stream words (the reference package's).
_DEFAULT_DSE = DSEConfig(batch=1, codecs=("none", "bfp8"), word_bits=16,
                         cut_kinds=("pool", "conv"))


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
    """A runnable compiled design: executor + plan + provenance."""
    spec: CompileSpec
    graph: Graph
    device: str
    plan: ExecutionPlan | None
    executor: LoweredPipeline | StreamingExecutor

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

    def run(self, x) -> torch.Tensor:
        """Staged / reference: one ``(m, c)`` frame (tensor or array) ->
        the flat ``(L,)`` output.  Pipelined: a ``(B, m, c)`` stream ->
        ``(B, L)``, or one ``(m, c)`` frame, broadcast through the stream
        (every slot computes the same frame) -> ``(L,)``."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        x = x.to(self.executor.device)
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
        return out

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
            "obs": dict(_DEFAULT_OBS),
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
        obs = {**_DEFAULT_OBS, **(d.get("obs") or {})}
        if {k: obs[k] for k in _DEFAULT_OBS} != _DEFAULT_OBS:
            raise NotImplementedError(
                f"{path}: telemetry (obs={d['obs']}) is not ported yet: "
                f"Compiled.trace, metrics and serve wait for ROADMAP.md, "
                f"Queue 1, item 5")
        kernel_mode = d["kernel_mode"]
        if kernel_mode == "pallas":
            kernel_mode = ("cuda" if torch.device(torch_device).type == "cuda"
                           else "auto")
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
            torch_device=torch_device)
        return compile(spec)
