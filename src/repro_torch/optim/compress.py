"""Gradient compression for cross-pod data parallelism — the counterpart of
the reference package's ``optim/compress.py``, on ``torch.distributed``.

The multi-pod mesh's ``pod`` axis crosses the slow inter-pod links, so the
per-step gradient all-reduce there is the collective-roofline term worth
attacking for training.  int8 quantisation with **error feedback** (the
residual of each step's quantisation is added back into the next step's
gradient) keeps SGD/Adam convergence while cutting cross-pod bytes 4x vs
f32 / 2x vs bf16.

:func:`compressed_psum` runs the quantise -> all-reduce -> dequantise
sequence over the mesh's ``pod`` dimension: an ``all_reduce(MAX)`` of the
row scales, then an int32 ``all_reduce(SUM)`` of the int8 payloads, divided
by the pod count.  Trees are nested dicts of tensors, as the port's
parameters.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise (last-axis) int8 with fp32 scales."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax.float(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_compress_tree(grads: Any, error: Any) -> tuple[Any, Any, Any]:
    """Error-feedback compression over a tree.

    Returns (quantised payloads, scales, new error residuals).  The
    residual ``g + e - dq(q(g + e))`` is carried to the next step.
    """
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        back = dequantize_int8(q, s)
        return q, s, corrected - back
    return _unzip(_map(one, grads, error), 3)


def init_error_state(grads_like: Any) -> Any:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads_like)


def _group(mesh, axis_name: str):
    return None if mesh is None else mesh.get_group(axis_name)


def compressed_psum(grads: Any, error: Any, axis_name: str = "pod",
                    mesh=None) -> tuple[Any, Any]:
    """Quantise + all-reduce over ``axis_name`` + dequantise, with error
    feedback.  Every rank of the mesh's ``axis_name`` dimension (the whole
    world without a ``mesh``) calls it with its own gradients.

    Senders must agree on the scale before int payloads can be summed, so a
    cheap MAX all-reduce over the (tiny) row scales runs first — the wire
    payload is then int8 mantissas + one shared fp32 scale per row: 4x
    fewer bytes on the slow inter-pod links than fp32 gradients.
    """
    import torch.distributed as dist
    group = _group(mesh, axis_name)
    n = dist.get_world_size(group)

    def one(g, e):
        corrected = g.float() + e
        amax = corrected.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(amax.float(), min=1e-20) / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(corrected / scale), -127, 127).to(
            torch.int8)
        new_e = corrected - q.float() * scale
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        return (summed.float() * scale) / n, new_e
    return _unzip(_map(one, grads, error), 2)


def make_pod_compressed_grad_fn(loss_fn: Callable, mesh) -> Callable:
    """Per-pod backward + int8-EF cross-pod reduction over the mesh's
    ``pod`` dimension.

    loss_fn(params, batch) -> scalar.  Returns
    fn(params, batch, error) -> (grads, loss, new_error)
    where every rank passes the whole ``batch`` (its pod takes its slice of
    the leading axis) and the same ``params``; the grads and the loss are
    the pods' means.  Each pod's backward runs on its rank's own tensors,
    so a pod is one rank: the mesh's other dimensions are 1.
    """
    import torch.distributed as dist
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if any(s != 1 for a, s in sizes.items() if a != "pod"):
        raise ValueError(f"a pod of one rank: mesh {sizes}")
    group = mesh.get_group("pod")
    n, me = sizes["pod"], mesh.get_local_rank("pod")

    def fn(params, batch, error):
        def part(x):
            rows = x.shape[0] // n
            return x[me * rows:(me + 1) * rows]
        mine = _map(part, batch)
        leaves = _map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, mine)
        flat = []
        _map(lambda t: flat.append(t), leaves)
        grads = iter(torch.autograd.grad(loss, flat))
        grads = _map(lambda t: next(grads), leaves)
        grads, new_error = compressed_psum(grads, error, "pod", mesh)
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return grads, loss / n, new_error
    return fn


__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree",
           "init_error_state", "compressed_psum",
           "make_pod_compressed_grad_fn"]
