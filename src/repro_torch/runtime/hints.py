"""Activation-sharding hints: mesh-aware constraints without mesh-aware
models — the counterpart of the reference package's ``runtime/hints.py``.

The model zoo stays pure (no mesh imports); the step builders activate a
context around the step, and layer code calls :func:`constrain` at the
points where the reference constrains its activations (q/k/v head axes
after the head reshape, MoE expert/hidden axes) and where DTensor needs a
whole axis that GSPMD would gather by itself (the embedding table before
its lookup, a loss chunk's vocab axis).  Outside the context
``constrain`` is the identity, so the unsharded paths run unchanged, bit
for bit.  Inside it, a DTensor is redistributed to the guarded spec (a
plain tensor, replicated by the step's implicit replication, passes as it
is).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .sharding import _guard, placements

_HINTS: contextvars.ContextVar = contextvars.ContextVar(
    "smof_sharding_hints", default=None)


@contextlib.contextmanager
def activation_hints(mesh, dp_axes, tp_axis: str = "model"):
    token = _HINTS.set({"mesh": mesh, "dp": dp_axes, "tp": tp_axis})
    try:
        yield
    finally:
        _HINTS.reset(token)


def active() -> bool:
    return _HINTS.get() is not None


def _axes(h: dict, kind: str):
    return h[kind] if kind in ("dp", "tp") else None


def axis_size(kind: str) -> int:
    """Mesh extent of the "dp"/"tp" hint axes (1 when no context)."""
    h = _HINTS.get()
    if h is None:
        return 1
    axes = _axes(h, kind)
    if axes is None:
        return 1
    sizes = dict(zip(h["mesh"].mesh_dim_names, h["mesh"].mesh.shape))
    total = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        total *= sizes.get(a, 1)
    return total


def spec_of(shape: tuple, *spec) -> tuple:
    """The guarded mesh spec of hint entries ("dp" | "tp" | None) for a
    tensor of ``shape`` in the active context."""
    h = _HINTS.get()
    names = []
    for s in spec:
        axes = _axes(h, s) if isinstance(s, str) else None
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]
        names.append(axes)
    return _guard(tuple(shape), names, h["mesh"])


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Apply a sharding constraint; spec entries: "dp" | "tp" | None.

    Divisibility-guarded: any axis that does not divide by its mesh axes is
    left unsharded instead of failing.
    """
    h = _HINTS.get()
    if h is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(h["mesh"],
                          placements(spec_of(x.shape, *spec), h["mesh"]))


__all__ = ["activation_hints", "active", "axis_size", "spec_of",
           "constrain"]
