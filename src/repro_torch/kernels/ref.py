"""Plain PyTorch versions of the kernels: the CPU path, the executor's
``kernel_mode="reference"`` bodies and the targets each CUDA kernel is
held against on the card.  They repeat the kernels' arithmetic and are no
yardstick of speed."""
from __future__ import annotations

import torch

from .bfp8 import bfp8_dequant_values, bfp8_quant_values


def streamed_matmul_ref(x: torch.Tensor, w_static: torch.Tensor,
                        w_dyn: torch.Tensor) -> torch.Tensor:
    """y = x @ [w_static; w_dyn] — the fragmentation split is semantically
    invisible; only the memory placement differs."""
    return conv2d_ref(x, torch.cat([w_static, w_dyn], dim=0))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Plain softmax attention.  q, k, v: (B, S, H, D) (kv heads
    pre-repeated)."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, -2.0 ** 30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of ``csrc/tf32x3.cuh`` on f32 ``x``: ``hi`` is x
    rounded to TF32's 10 mantissa bits, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), ``lo`` the same rounding of the exact ``x -
    hi``.  For finite x below f32's largest binade.  The kernels' product
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` is emulated from these by the CPU
    tests; no path calls it."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def bf16_pieces(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """The bf16 split of ``csrc/flash_attention_bwd_bf16.cu`` on f32 ``x``:
    ``n`` pieces, each the bf16 rounding (to nearest even) of what the ones
    before it leave, ``x - p_1 - ... - p_(i-1)`` (exact in f32), as f32
    tensors of bf16 values.  Two pieces carry 16 of x's 24 bits, three all
    of them.  The bf16 backward kernels multiply P and dS by a bf16 operand
    as the sum of their pieces' products (each exact in f32); the CPU
    tests emulate that from these, no path calls it."""
    out = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 channel mixing (conv/matmul/deconv): y = x @ w, in f32."""
    return torch.matmul(x, w)


def dwconv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise temporal conv, 'same' zero padding; w: (taps, c).  The
    tap sum runs in Python ``sum`` order."""
    taps = w.shape[0]
    pad = taps // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, taps - 1 - pad))
    m = x.shape[0]
    return sum(w[k][None, :] * xp[k:k + m] for k in range(taps))


def pool_ref(x: torch.Tensor, m_out: int) -> torch.Tensor:
    """Position-axis mean to m_out rows."""
    m, c = x.shape
    if m % m_out:
        raise ValueError(f"pool needs m_out | m, got {m} -> {m_out}")
    return x.reshape(m_out, m // m_out, c).mean(dim=1)


def upsample_ref(x: torch.Tensor, m_out: int) -> torch.Tensor:
    """Repeat each row m_out / m times."""
    m = x.shape[0]
    if m_out % m:
        raise ValueError(f"upsample needs m | m_out, got {m} -> {m_out}")
    return torch.repeat_interleave(x, m_out // m, dim=0)


def act_relu_ref(x: torch.Tensor) -> torch.Tensor:
    """relu that keeps NaN and -0.0 as they are, on every device (the
    library's ``torch.relu`` treats -0.0 differently on the CPU and the
    card)."""
    return torch.where(x < 0, 0.0, x)


def bfp8_quant_ref(x: torch.Tensor, block: int = 32,
                   width: int | None = None):
    """Block floating point: int8 mantissas + per-block exponent.
    x: (R, C); the payload is ``width`` wide (default C, then C % block ==
    0), its channels past C zeros.  Returns (mantissa i8, exponent i8)."""
    return bfp8_quant_values(x, block=block, width=width)


def bfp8_dequant_ref(man: torch.Tensor, exp: torch.Tensor, block: int = 32,
                     dtype=torch.float32,
                     c: int | None = None) -> torch.Tensor:
    return bfp8_dequant_values(man, exp, block=block, c=c, dtype=dtype)
