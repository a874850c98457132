"""The train, prefill and decode steps on PyTorch tensors — the
counterparts of the reference package's ``runtime/steps.py`` on one GPU.

:func:`make_train_step` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of ``lm_loss`` over
``microbatches`` slices of the batch, accumulated as the reference does
(f32, or bf16 when the optimizer states are quantised; divided by the
count; the loss their mean), then one AdamW update.  The port updates
``params`` and ``opt_state`` in place and returns them, where the reference
returns new trees.

:func:`make_prefill_step` and :func:`make_decode_step` return the
reference's ``step(params, cache, batch_in) -> (last_logits, cache)`` and
``step(params, cache, token, pos) -> (logits, cache)``: the serving entry
points of a model the engine does not take (an encoder-decoder, whose
``batch_in`` carries ``enc_frames``; a VLM's ``patch_embeds`` likewise).
The decode step writes the cache in place, as ``models.decode_step``.

``dtype`` names the working type of the parameters and the cache, f32 or
bf16 (the reference's default); as in the reference, the step computes in
the types of the tensors it is given.

``make_train_step(..., mesh=)`` runs the step on a ``torch.distributed``
``DeviceMesh`` (``launch/mesh.py``), as the reference's GSPMD step: the
model code stays as it is, the parameters and optimizer state are DTensors
laid out by ``runtime/sharding.py``'s rules (:func:`shard_train_state`),
the batch by ``batch_shardings``, and the step runs under the activation
hints (``runtime/hints.py``), whose constraints redistribute q, k, v and
the MoE dispatch; the attention kernels run on each rank's own rows and
heads.  Each microbatch's gradients are laid out as their parameters
(a reduce-scatter of FSDP's partial sums), as the reference pins its
accumulator, and AdamW updates each rank's local shards in place, the
gradient norm and the int8 states' row maxima taken over the whole
tensors.  ``make_prefill_step`` / ``make_decode_step(..., mesh=)`` run
likewise, the cache laid out by ``cache_shardings``
(:func:`shard_serve_state`): a prefill writes the prompt's keys and values
into pages split over the sequence, a decode writes each new key and value
on the rank that holds its position and reduces its split softmax over the
ranks (``models/attention.py``), and the recurrent states keep their
layout.  On a 1x1 mesh every step is bit for bit the unsharded one.

:func:`abstract_params`, :func:`abstract_opt_state`,
:func:`abstract_cache` and :func:`input_specs` are the reference's
shape-only stand-ins (its ``jax.eval_shape`` trees and
``ShapeDtypeStruct`` leaves): tensors on the ``meta`` device, never
allocated, in the reference's shapes and types; ``input_specs`` lays each
entry out by the rules, a DTensor over a meta local shard on a
``DeviceMesh`` (one of a fake process group included:
``launch/dryrun.py``) or a :class:`Sharded` pair on a shape-only
``MeshShape``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models.config import ArchConfig
from ..models.model import (_leaves, _tree, decode_step, forward,
                            init_cache, lm_loss, param_shapes,
                            project_logits)
from ..optim.adamw import (AdamWConfig, adamw_update, global_norm,
                           init_opt_state)
from . import sharding as SH
from .hints import activation_hints

#: the working types of the steps: the parameters' (and the cache's)
DTYPES = (torch.float32, torch.bfloat16)


@contextlib.contextmanager
def _on_mesh(mesh):
    """The context of a step on ``mesh``: the activation hints and
    DTensor's implicit replication of plain tensors (positions, masks)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with activation_hints(mesh, SH.dp_axes(mesh), "model"), \
            implicit_replication():
        yield


def _check_dtype(dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} not in {DTYPES}")


def auto_microbatches(batch: int, devices: int = 1,
                      rows_per_device: int = 1) -> int:
    """Accumulation depth that keeps ~rows_per_device sequences live per
    device (bounds activation temps; the optimizer update stays one
    step)."""
    mb = max(1, batch // (devices * rows_per_device))
    while batch % mb:
        mb -= 1
    return mb


def _on(batch: dict, device) -> dict:
    return {k: _as(v, device) for k, v in batch.items()}


def _as(v, device) -> torch.Tensor:
    """``v`` (numpy or torch) on ``device``; a DTensor as it is."""
    if _is_dtensor(v):
        return v
    return torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _rows(t: torch.Tensor, i: int, parts: int, spec, mesh):
    """Microbatch ``i`` of ``parts`` of ``t``'s rows, laid out by ``spec``.
    A whole tensor gives rows ``i * n .. (i + 1) * n`` (the reference's
    slices); a DTensor whose rows each rank divides gives slice ``i`` of
    every rank's own rows (the same rows, grouped otherwise: no
    collective)."""
    from torch.distributed.tensor import DTensor, Shard
    split = _is_dtensor(t) and any(isinstance(p, Shard) and p.dim == 0
                                   for p in t.placements)
    if not split or t.to_local().shape[0] % parts:
        n = t.shape[0] // parts
        return SH.distribute(t[i * n:(i + 1) * n], spec, mesh)
    loc = t.to_local()
    n = loc.shape[0] // parts
    shape = (t.shape[0] // parts,) + tuple(t.shape[1:])
    part = DTensor.from_local(loc[i * n:(i + 1) * n], mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=SH.contiguous_strides(shape))
    return SH.distribute(part, spec, mesh)


def loss_and_grads(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   labels: torch.Tensor, *, remat: str = "full",
                   use_kernels: bool = True,
                   enc_frames: torch.Tensor | None = None,
                   patch_embeds: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` of ``lm_loss`` at ``params``, the gradients as a
    tree of ``params``' layout (an encoder-decoder's ``encoder/...``
    leaves included).  ``params`` is left as it was (the leaves are
    differentiated through detached aliases, no copy)."""
    flat = dict(_leaves(params))
    leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
    loss = lm_loss(_tree(leaves), cfg, tokens, labels, remat=remat,
                   use_kernels=use_kernels, enc_frames=enc_frames,
                   patch_embeds=patch_embeds)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), _tree(dict(zip(leaves, grads)))


def accumulate_grads(params: dict, cfg: ArchConfig, batch: dict,
                     microbatches: int, acc_dtype: torch.dtype, *,
                     remat: str = "full", use_kernels: bool = True,
                     mesh=None) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` over ``microbatches`` equal slices of ``batch``
    (rows in order; its ``enc_frames`` and ``patch_embeds`` too, where it
    has them), as the reference's scan: with more than one, each slice's
    gradients are added into ``acc_dtype`` zeros, the sum divided by the
    count, and the loss is the slices' mean.  On a ``mesh`` (DTensor
    parameters) each slice is laid out by ``batch_shardings`` and each
    slice's gradients as their parameters before they are added; a batch
    laid out already (DTensors) is sliced on each rank's own rows
    (:func:`_rows`)."""
    parts = {n: batch[n] for n in ("tokens", "labels", "enc_frames",
                                   "patch_embeds") if batch.get(n) is not None}
    B = parts["tokens"].shape[0]
    mbs = max(microbatches, 1)
    if B % mbs:
        raise ValueError(f"batch {B} is not a multiple of {microbatches} "
                         f"microbatches")
    rows = B // mbs
    if mesh is not None:
        specs = SH.batch_shardings(cfg, rows, mesh)
        place = {n: t.placements for n, t in _leaves(params)}

    def run(i):
        if mesh is None:
            mb = {n: t[i * rows:(i + 1) * rows] for n, t in parts.items()}
        else:
            mb = {n: _rows(t, i, mbs, specs[n], mesh)
                  for n, t in parts.items()}
        loss, grads = loss_and_grads(params, cfg, mb.pop("tokens"),
                                     mb.pop("labels"), remat=remat,
                                     use_kernels=use_kernels, **mb)
        if mesh is not None:
            grads = _tree({n: g.redistribute(g.device_mesh, place[n])
                           for n, g in _leaves(grads)})
        return loss, grads

    if mbs == 1:
        return run(0)
    acc = {n: torch.zeros_like(t, dtype=acc_dtype) for n, t in
           _leaves(params)}
    losses = []
    for i in range(mbs):
        loss, grads = run(i)
        for n, g in _leaves(grads):
            acc[n].add_(g.to(acc_dtype))
        del grads
        losses.append(loss)
    grads = {n: a / mbs for n, a in acc.items()}
    return torch.stack(losses).mean(), _tree(grads)


def shard_train_state(cfg: ArchConfig, params: dict, opt_state: dict, mesh
                      ) -> tuple[dict, dict]:
    """``params`` and ``opt_state``, every leaf whole on every rank (or a
    DTensor already), as DTensors on ``mesh`` laid out by
    ``param_shardings`` / ``opt_state_shardings``: each rank keeps its own
    slice, no collective runs (a DTensor of another layout is
    redistributed)."""
    p = SH.distribute_tree(params, SH.param_shardings(cfg, params, mesh),
                           mesh)
    o = SH.distribute_tree(opt_state,
                           SH.opt_state_shardings(cfg, opt_state, mesh), mesh)
    return p, o


def _row_amax(cfg: ArchConfig, params: dict, mesh) -> dict:
    """leaf name -> the function that takes a local row maximum to the
    whole row's (an all-reduce MAX over the mesh axes that split the
    leaf's last axis), for the leaves whose last axis is sharded."""
    import torch.distributed as dist
    out = {}
    for name, spec in _leaves(SH.param_shardings(cfg, params, mesh)):
        last = spec[-1] if spec else None
        if last is None:
            continue
        groups = [mesh.get_group(a) for a in
                  (last if isinstance(last, tuple) else (last,))]

        def amax(a, groups=groups):
            for g in groups:
                dist.all_reduce(a, op=dist.ReduceOp.MAX, group=g)
            return a
        out[name] = amax
    return out


def _local(tree):
    """Every DTensor leaf as its local shard (a view: in-place updates
    reach the DTensor)."""
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree.to_local()


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    remat: str = "full", dtype=torch.float32,
                    microbatches: int | None = None,
                    device: str | torch.device = "cuda",
                    use_kernels: bool = True, mesh=None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``batch`` a dict of (B, S) ``tokens`` and ``labels`` (numpy or torch)
    and, for an encoder-decoder, (B, enc_frames, d) ``enc_frames`` or, for
    a VLM, (B, P, d) ``patch_embeds``, moved to ``device``;
    metrics ``loss``, ``lr`` and ``grad_norm``, 0-d tensors.
    ``microbatches`` defaults to :func:`auto_microbatches` of the
    batch on the mesh's data-parallel ranks (one device without a mesh).
    ``use_kernels=False`` runs attention's plain version through autograd
    (the check of the kernel route).

    With a ``mesh`` every rank calls the step with the whole batch; the
    parameters and states may come whole or laid out already
    (:func:`shard_train_state`), and are returned as DTensors laid out by
    the rules, updated in place."""
    _check_dtype(dtype)
    # f32 accumulation by default; bf16 when the optimizer states are
    # already int8-quantised, as the reference
    acc_dtype = torch.bfloat16 if opt_cfg.quantize_states else torch.float32
    if mesh is not None:
        SH.register_strategies()

    def step(params, opt_state, batch):
        batch = _on(batch, device)
        B = batch["tokens"].shape[0]
        if mesh is None:
            mbs = microbatches or auto_microbatches(B)
            loss, grads = accumulate_grads(params, cfg, batch, mbs,
                                           acc_dtype, remat=remat,
                                           use_kernels=use_kernels)
            params, opt_state, metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
            metrics["loss"] = loss
            return params, opt_state, metrics
        mbs = microbatches or auto_microbatches(B, SH.dp_size(mesh))
        params, opt_state = shard_train_state(cfg, params, opt_state, mesh)
        with _on_mesh(mesh):
            loss, grads = accumulate_grads(params, cfg, batch, mbs,
                                           acc_dtype, remat=remat,
                                           use_kernels=use_kernels,
                                           mesh=mesh)
            gnorm = global_norm(grads).full_tensor()
        state = {"m": _local(opt_state["m"]), "v": _local(opt_state["v"]),
                 "step": opt_state["step"].to_local()}
        _, state, metrics = adamw_update(
            _local(params), _local(grads), state, opt_cfg, grad_norm=gnorm,
            row_amax=_row_amax(cfg, params, mesh)
            if opt_cfg.quantize_states else None)
        opt_state["step"] = SH.distribute(state["step"], (), mesh)
        metrics["loss"] = loss.full_tensor()
        return params, opt_state, metrics

    return step


def shard_serve_state(cfg: ArchConfig, batch: int, params: dict,
                      cache: dict, mesh) -> tuple[dict, dict, Any]:
    """``params`` and ``cache`` (whole on every rank, or DTensors) as
    DTensors on ``mesh`` laid out by ``param_shardings`` /
    ``cache_shardings`` at ``batch`` rows, and the cache's spec tree: each
    rank keeps its own slice, no collective runs (a DTensor of another
    layout is redistributed, one laid out so is returned as it is)."""
    p = SH.distribute_tree(params, SH.param_shardings(cfg, params, mesh),
                           mesh)
    specs = SH.cache_shardings(cfg, batch, mesh, cache)
    return p, SH.distribute_tree(cache, specs, mesh), specs


def make_prefill_step(cfg: ArchConfig, batch: int, seq: int,
                      dtype=torch.float32, device: str | torch.device = "cuda",
                      use_kernels: bool = True, mesh=None) -> Callable:
    """``step(params, cache, batch_in) -> (last_logits, cache)``:
    ``batch_in`` a dict of (batch, S) ``tokens``, S <= ``seq``, and where
    the model takes them (batch, enc_frames, d) ``enc_frames`` or (batch,
    P, d) ``patch_embeds`` (numpy or torch), moved to ``device``; the
    cache one of ``init_cache(cfg, batch, seq)``'s shapes, the new one
    returned with the prompt's keys and values (and the encoder's cross
    keys and values) and the last position's (batch, vocab) f32 logits.
    ``use_kernels=False`` runs attention's plain version.

    With a ``mesh`` every rank calls the step with the whole inputs (or
    DTensors laid out already); the parameters and cache are laid out by
    :func:`shard_serve_state`, ``batch_in`` by ``batch_shardings``, and the
    logits and the new cache come back as DTensors, the cache laid out by
    ``cache_shardings``."""
    _check_dtype(dtype)

    def step(params, cache, batch_in):
        batch_in = _on(batch_in, device)
        tokens = batch_in["tokens"]
        if tokens.shape[0] != batch or tokens.shape[1] > seq:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not fit the "
                             f"step's batch {batch} and seq {seq}")
        if mesh is None:
            x, new_cache, _ = forward(
                params, cfg, tokens.long(), cache=cache,
                enc_frames=batch_in.get("enc_frames"),
                patch_embeds=batch_in.get("patch_embeds"),
                use_kernels=use_kernels)
            return project_logits(params, cfg, x[:, -1]), new_cache
        params, cache, specs = shard_serve_state(cfg, batch, params, cache,
                                                 mesh)
        bsh = SH.batch_shardings(cfg, batch, mesh)
        bi = {n: SH.distribute(t, bsh[n], mesh) for n, t in batch_in.items()}
        with _on_mesh(mesh):
            x, new_cache, _ = forward(
                params, cfg, bi["tokens"].long(), cache=cache,
                enc_frames=bi.get("enc_frames"),
                patch_embeds=bi.get("patch_embeds"), use_kernels=use_kernels)
            logits = project_logits(params, cfg, x[:, -1])
        return logits, SH.distribute_tree(new_cache, specs, mesh)

    return step


def make_decode_step(cfg: ArchConfig, batch: int, s_max: int,
                     dtype=torch.float32, device: str | torch.device = "cuda",
                     use_kernels: bool = True, mesh=None) -> Callable:
    """``step(params, cache, token, pos) -> (logits, cache)``: one new
    token (batch, 1) at positions ``pos`` (batch,) against a cache of
    length ``s_max``, written in place and returned; (batch, vocab) f32
    logits.  With ``use_kernels`` an encoder-decoder's cross attention over
    the cached encoder keys takes the ``flash_attention`` kernel.  With a
    ``mesh`` as :func:`make_prefill_step`'s: ``token`` and ``pos`` laid out
    by ``batch_shardings``; a cache laid out already is written in place on
    each rank and keeps its layout."""
    _check_dtype(dtype)

    def step(params, cache, token, pos):
        token, pos = _as(token, device).long(), _as(pos, device).long()
        if tuple(token.shape) != (batch, 1) or tuple(pos.shape) != (batch,):
            raise ValueError(f"token {tuple(token.shape)} and pos "
                             f"{tuple(pos.shape)} do not fit the step's "
                             f"batch {batch}")
        first = next(iter(cache.values()))
        if "k" in first and first["k"].shape[2] != s_max:
            raise ValueError(f"cache of length {first['k'].shape[2]}, the "
                             f"step's s_max is {s_max}")
        if mesh is None:
            return decode_step(params, cfg, token, pos, cache,
                               use_kernels=use_kernels)
        params, cache, _ = shard_serve_state(cfg, batch, params, cache, mesh)
        bsh = SH.batch_shardings(cfg, batch, mesh)
        token = SH.distribute(token, bsh["tokens"], mesh)
        pos = SH.distribute(pos, bsh["pos"], mesh)
        with _on_mesh(mesh):
            return decode_step(params, cfg, token, pos, cache,
                               use_kernels=use_kernels)

    return step


# -- shape-only inputs (the dry-run's contract) ---------------------------------

#: parameter leaves ``init_params`` keeps in f32 under a tree of another
#: type, as the reference does (routers, Mamba's A_log and D, the mLSTM
#: gates, the sLSTM bias)
F32_PARAMS = ("router", "A_log", "D", "gate_proj", "gate_bias", "bias")


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """``init_params(cfg, dtype)``'s tree on the meta device."""
    return _tree({n: torch.empty(s, device="meta", dtype=torch.float32
                                 if n.rsplit("/", 1)[-1] in F32_PARAMS
                                 else dtype)
                  for n, s in param_shapes(cfg).items()})


def abstract_opt_state(cfg: ArchConfig, opt_cfg: AdamWConfig,
                       dtype=torch.bfloat16) -> dict:
    """``init_opt_state`` of :func:`abstract_params`, on the meta device."""
    return init_opt_state(abstract_params(cfg, dtype), opt_cfg)


def abstract_cache(cfg: ArchConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16) -> dict:
    """``init_cache(cfg, batch, s_max, dtype)`` on the meta device."""
    return init_cache(cfg, batch, s_max, dtype, device="meta")


class Sharded(NamedTuple):
    """A shape-only input on a :class:`~.sharding.MeshShape`: the whole
    tensor on the meta device and its spec."""
    tensor: torch.Tensor
    spec: tuple


def _lay_out(t: torch.Tensor, spec, mesh):
    """``t`` (meta) laid out by ``spec``: a :class:`Sharded` on a
    ``MeshShape``; on a ``DeviceMesh`` a DTensor over this rank's meta
    local shard."""
    if isinstance(mesh, SH.MeshShape):
        return Sharded(t, tuple(spec))
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = SH.placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype,
                                          device="meta"),
                              mesh, pl, run_check=False, shape=t.shape,
                              stride=SH.contiguous_strides(t.shape))


def _lay_out_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _lay_out_tree(v, specs[k], mesh) for k, v in tree.items()}
    return _lay_out(tree, specs, mesh)


def input_specs(cfg: ArchConfig, shape, mesh, *,
                opt_cfg: AdamWConfig | None = None,
                dtype=torch.bfloat16) -> dict[str, Any]:
    """Shape-only stand-ins for every input of the step ``shape`` runs
    (the train step for ``train``, prefill or decode otherwise), laid out
    by the rules on ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``), on the
    meta device: ``params`` / ``opt_state`` / ``batch`` for ``train``,
    ``params`` / ``cache`` / ``batch`` for ``prefill``, ``params`` /
    ``cache`` / ``token`` / ``pos`` for ``decode``; int32 tokens,
    positions and labels, as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    bsh = SH.batch_shardings(cfg, B, mesh)
    i32 = torch.int32

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    p_abs = abstract_params(cfg, dtype)
    params = _lay_out_tree(p_abs, SH.param_shardings(cfg, p_abs, mesh), mesh)
    extras = {}
    if cfg.is_encdec:
        extras["enc_frames"] = _lay_out(
            meta((B, cfg.enc_frames, cfg.d_model), dtype),
            bsh["enc_frames"], mesh)
    if cfg.vlm_patches and shape.kind != "decode":
        extras["patch_embeds"] = _lay_out(
            meta((B, cfg.vlm_patches, cfg.d_model), dtype),
            bsh["patch_embeds"], mesh)
    if shape.kind == "train":
        o_abs = abstract_opt_state(cfg, opt_cfg or AdamWConfig(), dtype)
        opt = _lay_out_tree(o_abs, SH.opt_state_shardings(cfg, o_abs, mesh),
                            mesh)
        batch = {"tokens": _lay_out(meta((B, S), i32), bsh["tokens"], mesh),
                 "labels": _lay_out(meta((B, S), i32), bsh["labels"], mesh),
                 **extras}
        return {"params": params, "opt_state": opt, "batch": batch}
    c_abs = abstract_cache(cfg, B, S, dtype)
    cache = _lay_out_tree(c_abs, SH.cache_shardings(cfg, B, mesh, c_abs),
                          mesh)
    if shape.kind == "prefill":
        batch = {"tokens": _lay_out(meta((B, S), i32), bsh["tokens"], mesh),
                 **extras}
        return {"params": params, "cache": cache, "batch": batch}
    # decode: one new token with a cache of length S
    return {"params": params, "cache": cache,
            "token": _lay_out(meta((B, 1), i32), bsh["tokens"], mesh),
            "pos": _lay_out(meta((B,), i32), bsh["pos"], mesh)}


__all__ = ["auto_microbatches", "loss_and_grads", "accumulate_grads",
           "shard_train_state", "shard_serve_state", "make_train_step",
           "make_prefill_step", "make_decode_step", "F32_PARAMS",
           "abstract_params", "abstract_opt_state", "abstract_cache",
           "Sharded", "input_specs"]
