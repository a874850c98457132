"""The SMOF compile façade of the PyTorch port: ``CompileSpec`` ->
``Compiled``.

One entry point takes a CNN graph plus a DSE target sheet and returns a
runnable streaming design with the off-chip eviction decisions baked in:

    import repro_torch

    compiled = repro_torch.compile(repro_torch.CompileSpec(
        model="unet_exec", device="u200", mode="staged"))
    y = compiled.run(x)                    # one (m, c) frame -> (L,)
    print(compiled.report())               # traffic + plan provenance

Spec knobs
----------
``device``       the DSE target sheet (``core.resources.ALL_DEVICES``), as
                 in the reference package.
``torch_device`` where the tensors live (``"cuda"`` by default).
``kernel_mode``  ``auto`` (kernels on a CUDA device, their plain versions
                 on the CPU), ``cuda`` (``auto`` that refuses the CPU) or
                 ``reference`` (plain bodies only).
``strategy``     ``dse`` (Algorithm 1) or ``manual-plan``.
``mode``         ``reference`` (dense baseline) or ``staged`` (the
                 sequential executor, Eq. 5).
``microbatches`` recorded in the plan, as the reference package does.
``seed``         fixes the per-vertex weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.builders import exec_input_shape, get_model
from .core.dse import DSEConfig, run_dse
from .core.graph import Graph
from .core.plan import ExecutionPlan, PLAN_SCHEMA_VERSION, plan_from_dse
from .core.resources import Device, get_device
from .runtime.executor import (KERNEL_MODES, LoweredPipeline, lower_plan,
                               reference_pipeline)

MODES = ("reference", "staged", "pipelined")
STRATEGIES = ("dse", "autotune", "manual-plan")

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
    mode: str = "staged"               # reference | staged
    kernel_mode: str = "auto"          # auto | cuda | reference
    microbatches: int = 8
    seed: int = 0
    plan: ExecutionPlan | None = None  # strategy="manual-plan" input
    dse: DSEConfig | None = None       # strategy="dse" knobs
    torch_device: str = "cuda"

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; pick one of "
                             f"{MODES}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; pick one "
                             f"of {STRATEGIES}")
        if self.mode == "pipelined":
            raise NotImplementedError(
                'mode="pipelined" (the 1F1B streamer) is not ported yet; '
                "see ROADMAP.md, Queue 1")
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
    else:
        executor = lower_plan(g, plan, kernel_mode=spec.kernel_mode,
                              seed=spec.seed, device=spec.torch_device)
    return Compiled(spec=spec, graph=g, device=_device_name(spec, plan),
                    plan=plan, executor=executor)


@dataclasses.dataclass
class Compiled:
    """A runnable compiled design: executor + plan + provenance."""
    spec: CompileSpec
    graph: Graph
    device: str
    plan: ExecutionPlan | None
    executor: LoweredPipeline

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
        """One ``(m, c)`` frame (tensor or array) -> the flat output."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return self.executor(x.to(self.executor.device))

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
