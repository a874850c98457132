"""Assigned architecture configs (``--arch <id>``).

Each module exports ``CONFIG`` (the exact published configuration) and the
registry below maps arch ids to them.  ``SHAPES`` defines the assigned
input-shape set shared by all LM-family architectures.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig

from . import (glm4_9b, granite_8b, grok_1_314b, jamba_v01_52b, olmoe_1b_7b,
               phi4_mini_38b, qwen2_vl_72b, whisper_large_v3, xlstm_13b,
               yi_6b)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (grok_1_314b, olmoe_1b_7b, whisper_large_v3, glm4_9b, yi_6b,
              phi4_mini_38b, granite_8b, xlstm_13b, jamba_v01_52b,
              qwen2_vl_72b)
}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None


def cell_applicable(arch: ArchConfig, shape: Shape) -> tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell applies, with the reason.

    ``long_500k`` needs sub-quadratic attention: only SSM/hybrid families run
    it (DESIGN.md §Arch-applicability); pure full-attention archs skip.
    """
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch (O(L^2))"
    return True, ""
