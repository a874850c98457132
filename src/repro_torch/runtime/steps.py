"""The train step on PyTorch tensors — the counterpart of the reference
package's ``runtime/steps.py`` on one GPU.

:func:`make_train_step` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of ``lm_loss`` over
``microbatches`` slices of the batch, accumulated as the reference does
(f32, or bf16 when the optimizer states are quantised; divided by the
count; the loss their mean), then one AdamW update.  The port updates
``params`` and ``opt_state`` in place and returns them, where the reference
returns new trees.  The reference's sharding hints (``runtime/hints.py``),
its ``in_shardings`` and the abstract-shape builders (``abstract_*``,
``input_specs``) serve a mesh, which one GPU has not: they wait for
ROADMAP.md Queue 1, item 12.  The prefill and decode steps are the serving
engine's (``serving/engine.py``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.config import ArchConfig
from ..models.model import _leaves, _tree, lm_loss
from ..optim.adamw import AdamWConfig, adamw_update

BF16_LATER = ("the LM stack and its kernels run in f32 only; bf16 is not "
              "ported yet (ROADMAP.md, Queue 1, item 14)")


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
                   use_kernels: bool = True) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` of ``lm_loss`` at ``params``, the gradients as a
    tree of ``params``' layout.  ``params`` is left as it was (the leaves
    are differentiated through detached aliases, no copy)."""
    flat = dict(_leaves(params))
    leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
    loss = lm_loss(_tree(leaves), cfg, tokens, labels, remat=remat,
                   use_kernels=use_kernels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), _tree(dict(zip(leaves, grads)))


def accumulate_grads(params: dict, cfg: ArchConfig, batch: dict,
                     microbatches: int, acc_dtype: torch.dtype, *,
                     remat: str = "full", use_kernels: bool = True
                     ) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` over ``microbatches`` equal slices of ``batch``
    (rows in order), as the reference's scan: with more than one, each
    slice's gradients are added into ``acc_dtype`` zeros, the sum divided
    by the count, and the loss is the slices' mean."""
    tokens, labels = batch["tokens"], batch["labels"]
    if microbatches <= 1:
        return loss_and_grads(params, cfg, tokens, labels, remat=remat,
                              use_kernels=use_kernels)
    B = tokens.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} is not a multiple of {microbatches} "
                         f"microbatches")
    rows = B // microbatches
    acc = {n: torch.zeros(t.shape, dtype=acc_dtype, device=t.device)
           for n, t in _leaves(params)}
    losses = []
    for i in range(microbatches):
        sl = slice(i * rows, (i + 1) * rows)
        loss, grads = loss_and_grads(params, cfg, tokens[sl], labels[sl],
                                     remat=remat, use_kernels=use_kernels)
        for n, g in _leaves(grads):
            acc[n].add_(g.to(acc_dtype))
        del grads
        losses.append(loss)
    grads = {n: a / microbatches for n, a in acc.items()}
    return torch.stack(losses).mean(), _tree(grads)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    remat: str = "full", dtype=torch.float32,
                    microbatches: int | None = None,
                    device: str | torch.device = "cuda",
                    use_kernels: bool = True) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``batch`` a dict of (B, S) ``tokens`` and ``labels`` (numpy or torch),
    moved to ``device``; metrics ``loss``, ``lr`` and ``grad_norm``, 0-d
    tensors.  ``microbatches`` defaults to :func:`auto_microbatches` of the
    batch on one device.  ``use_kernels=False`` runs attention's plain
    version through autograd (the check of the kernel route)."""
    if dtype != torch.float32:
        raise NotImplementedError(f"dtype {dtype}: {BF16_LATER}")
    # f32 accumulation by default; bf16 when the optimizer states are
    # already int8-quantised, as the reference
    acc_dtype = torch.bfloat16 if opt_cfg.quantize_states else torch.float32

    def step(params, opt_state, batch):
        batch = _on(batch, device)
        B = batch["tokens"].shape[0]
        mbs = microbatches or auto_microbatches(B)
        loss, grads = accumulate_grads(params, cfg, batch, mbs, acc_dtype,
                                       remat=remat, use_kernels=use_kernels)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


__all__ = ["auto_microbatches", "loss_and_grads", "accumulate_grads",
           "make_train_step"]
