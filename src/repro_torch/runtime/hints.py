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
is).  Where DTensor cannot follow a layout GSPMD would, the helpers keep it
on a path it can: :func:`split_heads` / :func:`merge_heads` keep a head
axis whole where the heads do not split over "tp" (a split inside a head
has no view), and :func:`on_ranks` runs a function on each rank's own
shards (``local_map``: the recurrent scans, the experts' products).
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


def whole_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` (..., n hd) with its last axis split over "tp" only where the
    n heads are: on a mesh whose "tp" extent does not divide n, laid out
    ("dp", None, ...) so that it takes the (..., n, hd) view (a split
    inside a head has none); elsewhere ``t`` itself."""
    tp = axis_size("tp")
    if tp == 1 or n % tp == 0:
        return t
    return constrain(t, *(("dp",) + (None,) * (t.dim() - 1)))


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n hd) as (B, S, n, hd), constrained ("dp", None, "tp",
    None), as the reference constrains its heads."""
    B, S = t.shape[:2]
    return constrain(whole_heads(t, n).reshape(B, S, n, hd), "dp", None,
                     "tp", None)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, n, hd) as (B, S, n hd); on a mesh whose "tp" extent does not
    divide n its heads stay whole, so that the gradient takes the (B, S,
    n, hd) view back."""
    B, S, n, hd = t.shape
    return whole_heads(t.reshape(B, S, n * hd), n)


def on_ranks(fn, args: tuple, specs: tuple, out: tuple):
    """``fn(*args)`` on each rank's own shards.  Inside a step's hints,
    with a DTensor among ``args``: each argument (a plain tensor is taken
    as whole on every rank) is laid out by its spec (entries "dp" | "tp" |
    None, guarded as :func:`constrain`'s), ``fn`` runs on the local
    tensors (``local_map``), and its outputs come back as DTensors laid
    out by ``out``, one (global shape, spec) pair each, or (global shape,
    spec, kind) with ``kind`` "dp" or "tp": an output that is a partial sum
    over those axes.  ``fn`` works on each rank's own shards alone, so an
    argument whole along a mesh dimension that splits another argument
    gets a partial gradient there, summed over the ranks.  Elsewhere
    ``fn(*args)`` itself."""
    h = _HINTS.get()
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    if h is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = h["mesh"]
    ins = []
    for a, spec in zip(args, specs):
        pl = placements(spec_of(a.shape, *spec), mesh)
        ins.append(a.redistribute(mesh, pl) if isinstance(a, DTensor) else
                   distribute_tensor(a, mesh, pl, src_data_rank=None))
    # the work is split along each mesh dimension some input is split on:
    # there an input whole on every rank gets a partial gradient from each
    split = {d for a in ins for d, p in enumerate(a.placements)
             if isinstance(p, Shard)}
    grads = tuple(tuple(Partial() if d in split and isinstance(p, Replicate)
                        else p for d, p in enumerate(a.placements))
                  for a in ins)
    run = local_map(fn, out_placements=tuple(_out(o, h) for o in out),
                    in_placements=tuple(a.placements for a in ins),
                    in_grad_placements=grads, device_mesh=mesh)
    return run(*ins)


def _out(o: tuple, h: dict) -> tuple:
    """The placements of one :func:`on_ranks` output."""
    from torch.distributed.tensor import Partial
    shape, spec, *partial = o
    pl = list(placements(spec_of(shape, *spec), h["mesh"]))
    if partial:
        axes = _axes(h, partial[0])
        names = list(h["mesh"].mesh_dim_names)
        for a in axes if isinstance(axes, tuple) else (axes,):
            pl[names.index(a)] = Partial()
    return tuple(pl)


__all__ = ["activation_hints", "active", "axis_size", "spec_of",
           "constrain", "whole_heads", "split_heads", "merge_heads",
           "on_ranks"]
