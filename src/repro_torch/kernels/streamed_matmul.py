"""Weight-fragmentation matmul (paper §III-B, Fig. 2).

``y = x @ [W_static; W_dyn]``: the *static* rows of the weight matrix are
the part the plan pins on chip, the *dynamic* rows the part it streams
from off-chip memory block by block — the paper's static/dynamic memory
fragmentation, with the plan's ``1 - m`` choosing the split point.  The
CUDA kernel (``csrc/streamed_matmul.cu``) walks the static panel and then
the dynamic blocks into one f32 accumulator, as the reference package's
kernel does; its note says why the split moves no bytes on the H100.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .library import check_operand, launch

TILE = 128                  # alignment of M, N and both K parts
KERNEL_BM = KERNEL_BN = 128  # the CUDA kernel's output tile
KERNEL_BK = 32               # its K step
KERNEL_STAGES = 3            # K steps in its cp.async ring
KERNEL_PAD_A, KERNEL_PAD_B = 4, 8  # floats of row padding (bank spread)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def smem_bytes(bm: int = KERNEL_BM, bn: int = KERNEL_BN,
               bk: int = KERNEL_BK, stages: int = KERNEL_STAGES,
               itemsize: int = 4) -> int:
    """Shared-memory working set of one block of the kernel: a ring of
    ``stages`` K steps, each the ``(bm, bk)`` slice of x and the ``(bk,
    bn)`` slice of the weight with their padded rows (the on-chip working
    set that takes the place of the TPU kernel's VMEM claim; the kernel's
    source asserts at compile time that it fits a block's 227 KB)."""
    return stages * (bm * (bk + KERNEL_PAD_A)
                     + bk * (bn + KERNEL_PAD_B)) * itemsize


def streamed_matmul(x: torch.Tensor, w_static: torch.Tensor,
                    w_dyn: torch.Tensor) -> torch.Tensor:
    """x: (M, K); w_static: (Ks, N); w_dyn: (Kd, N); K = Ks + Kd, with M, N,
    Ks and Kd multiples of 128.  CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    M, K = x.shape
    Ks, N = w_static.shape
    Kd, N2 = w_dyn.shape
    if N != N2 or K != Ks + Kd:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w_static.shape)}"
                         f", {tuple(w_dyn.shape)} do not chain")
    if M % TILE or N % TILE or Ks % TILE or Kd % TILE:
        raise ValueError(f"streamed_matmul needs M, N, Ks, Kd multiples of "
                         f"{TILE}, got M={M} N={N} Ks={Ks} Kd={Kd}")
    if not x.is_cuda:
        return ref.streamed_matmul_ref(x, w_static, w_dyn)
    for name, t in (("x", x), ("w_static", w_static), ("w_dyn", w_dyn)):
        check_operand(f"streamed_matmul {name}", t, torch.float32)
    if M // KERNEL_BM > 65535:
        raise ValueError(f"streamed_matmul: M={M} exceeds the grid's rows")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    launch("streamed_matmul", x, w_static, w_dyn, y, M, N, K, Ks)
    return y


def streamed_matmul_padded(x: torch.Tensor, w: torch.Tensor, *,
                           static_fraction: float = 0.5) -> torch.Tensor:
    """``y = x @ w`` through :func:`streamed_matmul` for ARBITRARY shapes.

    Zero-pads ``x``/``w`` to 128-alignment (padded rows/columns contribute
    exact zeros), splits ``w``'s rows at the 128-aligned point closest to
    ``static_fraction`` (the plan's ``1 - m``) — at least one static panel
    and one dynamic block — and slices the result back.  A weight matrix
    too small to split (K <= 128 after padding) falls back to a plain dot:
    there is no dynamic region worth streaming.
    """
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not x.is_cuda:
        # the plain version at x's and w's own shapes: the padding is the
        # kernel's alignment, and padded shapes let the CPU's BLAS block
        # the K sum otherwise than conv2d_ref does on the same operands
        return ref.conv2d_ref(x, w)
    Mp, Np = _round_up(M, TILE), _round_up(N, TILE)
    Kp = _round_up(K, TILE)
    if Kp <= TILE:
        return ref.conv2d_ref(x, w)
    ks = int(round(static_fraction * Kp / 128.0)) * 128
    ks = max(min(ks, Kp - TILE), 128)
    kd = _round_up(Kp - ks, TILE)
    Kp = ks + kd
    xp = F.pad(x, (0, Kp - K, 0, Mp - M))
    wp = F.pad(w, (0, Np - N, 0, Kp - K))
    y = streamed_matmul(xp, wp[:ks], wp[ks:])
    return y[:M, :N].contiguous()
