"""Differential conformance harness of the port (fuzzing + cross-executor
oracles), after the reference package's ``repro.testing``.

``gen``
    seeded random executable graphs and plans: a copy of the reference's
    generator, so a ``(seed, index, GenConfig)`` names the same case in
    both packages, byte for byte.
``oracle``
    differential oracles over one (graph, plan) case on a torch device:
    reference == staged == pipelined == served (exact where no BFP8
    crossing, spill-bounded where there is), the kernel route against the
    reference route, plan/artifact round-trips, ModelCheck and
    Eq. 1/5/6 invariants.
``fuzz``
    the driver — ``python -m repro_torch.testing.fuzz --budget N --seed
    S`` — which shrinks failing cases and writes replayable repro JSONs
    under ``tests/repros_torch/``.
"""
from .gen import (FuzzCase, GenConfig, mutate_plan, random_case,
                  random_exec_graph, random_plan)
from .oracle import (FAULTS, CaseReport, OracleViolation, check_case,
                     inject_fault)

__all__ = [
    "FuzzCase", "GenConfig", "random_case", "random_exec_graph",
    "random_plan", "mutate_plan",
    "CaseReport", "OracleViolation", "check_case", "inject_fault", "FAULTS",
]
