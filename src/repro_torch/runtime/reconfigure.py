"""Staged LM executor: the paper's §III-C reconfiguration applied to a
language model on one GPU — the counterpart of the reference package's
``runtime/reconfigure.py``.

An FPGA runs one subgraph's bitstream at a time and pays ``t_ri`` to load
the next; here only one stage's weights are on the card at a time, the
previous stage's released before the next is copied in from host memory.
Latency follows Eq. 5:

    t = sum_i (b * II_i + d_pi) / f + N * t_ri

The activation crossing from one stage to the next is the evicted stream:
it leaves the card, goes through the BFP8 codec (``core/compression``) on
the host and comes back for the next stage (Eq. 2's bandwidth at the
codec's compile-time ratio).

Stages are contiguous ranges of layer groups (:func:`split_group_stages`).
The weights of every stage stay in host memory as CPU tensors; each layer
runs through ``models.model._apply_layer`` in ``mode="full"`` without a
cache, as ``models.forward`` runs it, so attention takes the
``flash_attention`` kernels on the kernel route (``use_kernels``).  Times
are host-clock spans between ``torch.cuda.synchronize`` calls:
``reconfig_s`` the host -> device copy of a stage's weights, ``compute_s``
its layers' kernels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..core.compression import bfp8_decode, bfp8_encode
from ..models.common import apply_norm
from ..models.config import ArchConfig
from ..models.model import (_apply_layer, _embed, _leaves, _unbind,
                            project_logits)


@dataclasses.dataclass
class StageTiming:
    stage: int
    compute_s: float
    reconfig_s: float
    boundary_bytes_raw: int
    boundary_bytes_sent: int


def split_group_stages(n_groups: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) group ranges, balanced."""
    n_stages = max(1, min(n_stages, n_groups))
    base, rem = divmod(n_groups, n_stages)
    out, s = [], 0
    for i in range(n_stages):
        e = s + base + (1 if i < rem else 0)
        out.append((s, e))
        s = e
    return out


def _to_host(tree: Any) -> Any:
    """Every leaf as a CPU tensor; a CPU tensor is kept as it is (no
    copy)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(tree)
    return t.detach().cpu()


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class StagedExecutor:
    """Runs a model whose weights do not fit on the device together.

    ``host_params``: the model's parameter tree (``models.init_params``'
    layout), tensors on any device or numpy arrays; the executor keeps them
    as CPU tensors.  ``dtype`` is the tree's working type (its embedding
    table's), f32 or bf16.  ``use_kernels`` as ``models.forward``'s."""

    def __init__(self, cfg: ArchConfig, host_params: Any, *,
                 n_stages: int, compress_boundary: bool = True,
                 dtype=torch.float32, device: str | torch.device = "cuda",
                 use_kernels: bool = True):
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the staged "
                             f"executor runs decoder-only stacks, as the "
                             f"reference's")
        self.cfg = cfg
        self.n_stages = n_stages
        self.compress = compress_boundary
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.stages = split_group_stages(cfg.n_groups, n_stages)
        # host-side parameter store (stands in for host DRAM)
        self.host_params = _to_host(host_params)
        held = self.host_params["embed"].dtype
        if held != dtype:
            raise ValueError(f"the parameters are {held}, the executor's "
                             f"dtype is {dtype}")
        self.timings: list[StageTiming] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- stage weight management ("reconfiguration") ---------------------------
    def _stage_params(self, stage: int) -> Any:
        """Slice this stage's group stack and move it to the device
        (t_ri)."""
        s, e = self.stages[stage]
        return _to_device({k: _slice(v, s, e) for k, v in
                           self.host_params["groups"].items()}, self.device)

    def _boundary_roundtrip(self, x: torch.Tensor
                            ) -> tuple[torch.Tensor, int, int]:
        """Evict the inter-stage activation off the device and bring it
        back: raw bytes counted as bf16 stream words whatever the type (the
        reference's), sent bytes as the BFP8 mantissas and exponents; with
        the codec off the round trip is exact."""
        raw = x.float().cpu().numpy()
        raw_bytes = raw.size * 2                       # bf16 stream words
        if not self.compress:
            return (torch.from_numpy(raw).to(self.device, x.dtype),
                    raw_bytes, raw_bytes)
        enc = bfp8_encode(raw)
        sent = enc.mantissas.size + enc.exponents.size
        back = bfp8_decode(enc).astype(np.float32)
        return torch.from_numpy(back).to(self.device, x.dtype), raw_bytes, sent

    # -- execution ------------------------------------------------------------------
    @torch.no_grad()
    def forward_logits(self, tokens, **extras) -> torch.Tensor:
        """Full forward over all stages with reconfiguration between them:
        (B, S, vocab) f32 logits of ``tokens`` (B, S); ``patch_embeds`` (B,
        P, d) as ``models.forward``'s."""
        params = self.host_params
        tokens = torch.as_tensor(tokens, device=self.device).long()
        patches = extras.get("patch_embeds")
        if patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
        x = _embed(_to_device({"embed": params["embed"]}, self.device),
                   self.cfg, tokens, patches)
        self.timings.clear()
        last = len(self.stages) - 1
        for i in range(len(self.stages)):
            self._sync()
            t0 = time.perf_counter()
            gp = self._stage_params(i)                 # "bitstream load"
            self._sync()
            t_rc = time.perf_counter() - t0

            t1 = time.perf_counter()
            x = self._run_groups(gp, x)
            self._sync()
            t_cp = time.perf_counter() - t1
            del gp           # released before the next stage is copied in

            raw = sent = 0
            if i < last:
                x, raw, sent = self._boundary_roundtrip(x)
            self.timings.append(StageTiming(i, t_cp, t_rc, raw, sent))
        full = _to_device({k: params[k] for k in
                           ("final_norm", "embed", "lm_head") if k in params},
                          self.device)
        x = apply_norm(self.cfg.norm, x, full["final_norm"])
        return project_logits(full, self.cfg, x)

    def _run_groups(self, group_params: Any, x: torch.Tensor) -> torch.Tensor:
        """The stage's layer groups in order, each layer as
        ``models.forward`` runs it without a cache."""
        ng = next(_leaves(group_params))[1].shape[0]
        pos = torch.arange(x.shape[1], device=x.device)[None]
        for gp in _unbind(group_params, ng):
            for j in range(self.cfg.group_size):
                x, _, _ = _apply_layer(gp[f"pos_{j}"], x, self.cfg, j,
                                       pos=pos, mode="full",
                                       use_kernels=self.use_kernels)
        return x

    # -- Eq. 5 accounting -------------------------------------------------------------
    def eq5_latency(self, batch: int) -> dict:
        comp = sum(t.compute_s for t in self.timings)
        reconf = sum(t.reconfig_s for t in self.timings)
        raw = sum(t.boundary_bytes_raw for t in self.timings)
        sent = sum(t.boundary_bytes_sent for t in self.timings)
        total = comp + reconf
        return {"n_stages": self.n_stages, "compute_s": comp,
                "reconfig_s": reconf, "total_s": total,
                "throughput_fps": batch / total if total else float("inf"),
                "boundary_raw_bytes": raw, "boundary_sent_bytes": sent,
                "boundary_compression": sent / raw if raw else 1.0}


def _slice(tree: Any, s: int, e: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, s, e) for k, v in tree.items()}
    return tree[s:e]


__all__ = ["StageTiming", "split_group_stages", "StagedExecutor"]
