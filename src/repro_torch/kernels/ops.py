"""The kernel registry the executor's dispatch follows, and the public
surface of the kernel library (build, launch counts).

``KernelEntry.cuda`` is the wrapper that launches the op's CUDA kernel on a
CUDA tensor (and runs its plain version on a CPU one); ``reference`` is the
plain body that ``kernel_mode="reference"`` runs.  Every wrapper has its
kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import ref, streaming_conv
from .bfp8 import bfp8_dequant, bfp8_quant
from .flash_attention import flash_attention
from .library import (LAUNCHES, KernelLibrary, launches, load_library,
                      reset_launches)


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One lowerable op kind's dispatch row.

    ``cuda=None`` means the kind has no kernel (data movement / variadic
    ops) and the reference body runs in every kernel mode.  ``fuse_bfp8``
    marks kinds whose kernel wrapper can fuse the BFP8 boundary codec
    (ingress ``payload=`` / egress ``encode=True``).
    """
    kind: str
    reference: Callable
    cuda: Callable | None = None
    fuse_bfp8: bool = False


KERNEL_REGISTRY: dict[str, KernelEntry] = {}


def _register(entry: KernelEntry) -> None:
    KERNEL_REGISTRY[entry.kind] = entry


for _kind in ("conv", "matmul", "deconv"):
    _register(KernelEntry(kind=_kind, reference=ref.conv2d_ref,
                          cuda=streaming_conv.conv2d, fuse_bfp8=True))
_register(KernelEntry(kind="dwconv", reference=ref.dwconv_ref,
                      cuda=streaming_conv.dwconv, fuse_bfp8=True))
_register(KernelEntry(kind="pool", reference=ref.pool_ref,
                      cuda=streaming_conv.pool, fuse_bfp8=True))
_register(KernelEntry(kind="act", reference=ref.act_relu_ref,
                      cuda=streaming_conv.act_relu, fuse_bfp8=True))
# data-movement / variadic kinds: reference body in every mode
for _kind in ("input", "upsample", "add", "mul", "concat", "output"):
    _register(KernelEntry(kind=_kind, reference=lambda *a, **k: None))


def kernel_for(kind: str, *, use_kernels: bool
               ) -> tuple[Callable | None, bool]:
    """(body, is_kernel) for one op kind under the resolved kernel mode."""
    entry = KERNEL_REGISTRY.get(kind)
    if entry is None:
        return None, False
    if use_kernels and entry.cuda is not None:
        return entry.cuda, True
    return entry.reference, False


def flash_attn(q, k, v, *, causal: bool = True):
    """Blockwise softmax attention over (B, S, H, D): the
    ``flash_attention`` kernel on a CUDA tensor, its plain version on a CPU
    one (``kernels/flash_attention.py``)."""
    return flash_attention(q, k, v, causal=causal)


def evict_encode(x, *, block: int = 32):
    """Quantise an (R, C) eviction stream to BFP8 before it leaves the
    device: (int8 mantissas (R, C), int8 exponents (R, C // block))."""
    return bfp8_quant(x, block=block)


def evict_decode(man, exp, *, block: int = 32, dtype=torch.float32):
    """The inverse of :func:`evict_encode`."""
    return bfp8_dequant(man, exp, block=block, dtype=dtype)


def fusable_kinds() -> tuple[str, ...]:
    """Op kinds whose kernel wrapper fuses the BFP8 boundary codec."""
    return tuple(k for k, e in KERNEL_REGISTRY.items() if e.fuse_bfp8)


def lowerable_kinds() -> tuple[str, ...]:
    return tuple(KERNEL_REGISTRY)


__all__ = ["KernelEntry", "KERNEL_REGISTRY", "kernel_for", "fusable_kinds",
           "lowerable_kinds", "flash_attn", "flash_attention", "evict_encode",
           "evict_decode", "LAUNCHES",
           "KernelLibrary", "launches", "load_library", "reset_launches"]
