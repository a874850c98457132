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
tensors.  On a 1x1 mesh the step is bit for bit the unsharded one.  The
prefill and decode steps on a mesh and the abstract-shape builders
(``abstract_*``, ``input_specs``) wait for ROADMAP.md Queue 1, item 12's
second part.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.config import ArchConfig
from ..models.model import (_leaves, _tree, decode_step, forward, lm_loss,
                            project_logits)
from ..optim.adamw import AdamWConfig, adamw_update, global_norm
from . import sharding as SH
from .hints import activation_hints

#: the working types of the steps: the parameters' (and the cache's)
DTYPES = (torch.float32, torch.bfloat16)


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
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


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
    slice's gradients as their parameters before they are added."""
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

    def run(sl):
        mb = {n: t[sl] for n, t in parts.items()}
        if mesh is not None:
            mb = {n: SH.distribute(t, specs[n], mesh) for n, t in mb.items()}
        loss, grads = loss_and_grads(params, cfg, mb.pop("tokens"),
                                     mb.pop("labels"), remat=remat,
                                     use_kernels=use_kernels, **mb)
        if mesh is not None:
            grads = _tree({n: g.redistribute(g.device_mesh, place[n])
                           for n, g in _leaves(grads)})
        return loss, grads

    if mbs == 1:
        return run(slice(0, B))
    acc = {n: torch.zeros_like(t, dtype=acc_dtype) for n, t in
           _leaves(params)}
    losses = []
    for i in range(mbs):
        loss, grads = run(slice(i * rows, (i + 1) * rows))
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
        from torch.distributed.tensor.experimental import implicit_replication
        mbs = microbatches or auto_microbatches(B, SH.dp_size(mesh))
        params, opt_state = shard_train_state(cfg, params, opt_state, mesh)
        with activation_hints(mesh, SH.dp_axes(mesh), "model"), \
                implicit_replication():
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


def make_prefill_step(cfg: ArchConfig, batch: int, seq: int,
                      dtype=torch.float32, device: str | torch.device = "cuda",
                      use_kernels: bool = True) -> Callable:
    """``step(params, cache, batch_in) -> (last_logits, cache)``:
    ``batch_in`` a dict of (batch, S) ``tokens``, S <= ``seq``, and where
    the model takes them (batch, enc_frames, d) ``enc_frames`` or (batch,
    P, d) ``patch_embeds`` (numpy or torch), moved to ``device``; the
    cache one of ``init_cache(cfg, batch, seq)``'s shapes, the new one
    returned with the prompt's keys and values (and the encoder's cross
    keys and values) and the last position's (batch, vocab) f32 logits.
    ``use_kernels=False`` runs attention's plain version."""
    _check_dtype(dtype)

    def step(params, cache, batch_in):
        batch_in = _on(batch_in, device)
        tokens = batch_in["tokens"].long()
        if tokens.shape[0] != batch or tokens.shape[1] > seq:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not fit the "
                             f"step's batch {batch} and seq {seq}")
        x, new_cache, _ = forward(params, cfg, tokens, cache=cache,
                                  enc_frames=batch_in.get("enc_frames"),
                                  patch_embeds=batch_in.get("patch_embeds"),
                                  use_kernels=use_kernels)
        return project_logits(params, cfg, x[:, -1]), new_cache

    return step


def make_decode_step(cfg: ArchConfig, batch: int, s_max: int,
                     dtype=torch.float32, device: str | torch.device = "cuda",
                     use_kernels: bool = True) -> Callable:
    """``step(params, cache, token, pos) -> (logits, cache)``: one new
    token (batch, 1) at positions ``pos`` (batch,) against a cache of
    length ``s_max``, written in place and returned; (batch, vocab) f32
    logits.  With ``use_kernels`` an encoder-decoder's cross attention over
    the cached encoder keys takes the ``flash_attention`` kernel."""
    _check_dtype(dtype)

    def step(params, cache, token, pos):
        token = torch.as_tensor(token, device=device).long()
        pos = torch.as_tensor(pos, device=device).long()
        if token.shape != (batch, 1) or pos.shape != (batch,):
            raise ValueError(f"token {tuple(token.shape)} and pos "
                             f"{tuple(pos.shape)} do not fit the step's "
                             f"batch {batch}")
        first = next(iter(cache.values()))
        if "k" in first and first["k"].shape[2] != s_max:
            raise ValueError(f"cache of length {first['k'].shape[2]}, the "
                             f"step's s_max is {s_max}")
        return decode_step(params, cfg, token, pos, cache,
                           use_kernels=use_kernels)

    return step


__all__ = ["auto_microbatches", "loss_and_grads", "accumulate_grads",
           "shard_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step"]
