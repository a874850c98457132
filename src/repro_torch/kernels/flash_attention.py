"""Flash attention, the prefill hot spot: blockwise softmax attention with
the online-softmax recurrence (the reference package's
``kernels/flash_attention.py``).

``q, k, v: (B, S, H, D)`` f32 with the KV heads already repeated to H;
causal or not, scale ``D ** -0.5``, mask ``-2**30``, the softmax
denominator clamped at ``1e-30``, and key blocks wholly above the diagonal
skipped.  A CUDA tensor goes through the ``flash_attention`` kernel
(``csrc/flash_attention.cu``), which takes any S (the Pallas wrapper asks
``S % bq == 0``) and D in :data:`HEAD_DIMS`; a CPU tensor through the plain
version, ``models.attention.chunked_attention`` with block skipping, the
reference's own oracle for its kernel.
"""
from __future__ import annotations

import torch

from .library import check_operand, launch

#: head widths the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
KERNEL_BQ = 64              # the kernel's query rows a block


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention of ``q`` over ``k``, ``v`` (same shape)."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must share one (B, S, H, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if not q.is_cuda:
        from ..models.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal, chunk=min(1024, S),
                                 skip_masked=causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(f"flash_attention {name}", t, torch.float32)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if -(-S // KERNEL_BQ) > 65535 or B * H > 2**31 - 1:
        raise ValueError(f"flash_attention: S = {S} or B * H = {B * H} "
                         f"exceeds the grid")
    o = torch.empty_like(q)
    launch("flash_attention", q, k, v, o, B, S, H, D, int(causal))
    return o


__all__ = ["flash_attention", "HEAD_DIMS"]
