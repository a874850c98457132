"""A bf16 attention output against its plain version: one bf16 ulp plus
what the f32 sums of either side may leave between an element and its
exact value.

Both sides compute in f32 from the same bf16 operands and round each output
once, so they lie within one ulp of the plain value plus twice the f32
error of one side.  :func:`f32_slack` bounds that error per element:
``F32_U (n + D) A``, with ``A`` the element's sum of absolute terms and
``n`` the length of its last sum (Sk for o and dq, S for dk and dv).  A
score s = q^ k^T, a sum of D terms, is off by up to F32_U D s_abs (s_abs =
|q^| |k|^T), and so P = exp(s - lse) by as much relatively: every term
weighted by P is weighted by P (1 + s_abs) (the 1 covers exp's and the
normalisation's few roundings).  dS = P (dP - D) cancels, so its terms
are taken as P (|dO| |v|^T + rowsum(|dO| o_abs)) (1 + s_abs).  The
products of a 3xTF32 split add at most 2^-21 of each term, within the
(n + D) factor.  The bf16 backward pair (csrc/flash_attention_bwd_bf16.cu)
takes s and dP from two bf16 operands, each product exact in f32, and
multiplies P or dS by a bf16 operand as two bf16 pieces of it
(kernels.ref.bf16_pieces), which leave at most 2^-16 of each term: within
twice the (n + D) factor from n + D = 128 up (2 x 2^-24 x 128 = 2^-16),
and below that within it or the one ulp unless an element cancels to a
small fraction of its absolute terms; tests/test_torch_bf16.py emulates
the pieces and finds no element past the rule at the shapes
chip_smoke.py's phase 4 takes.  Computed in f64 on the inputs' device.
"""
from __future__ import annotations

import math

import torch

F32_U = 2.0 ** -24


def f32_slack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, do: torch.Tensor | None = None
              ) -> dict[str, torch.Tensor]:
    """Per element of o (and, given dO, of dq, dk and dv), each (B, S, H,
    D) as the outputs, the f32 error bound of the module docstring.  q^ is
    bf16(q x bf16(D^-1/2)), as both sides round it."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    sc = float(torch.tensor(D ** -0.5, dtype=q.dtype))

    def f(t):
        return t.double().transpose(1, 2)
    qh = f((q * sc).to(q.dtype))
    kk, va = f(k), f(v).abs()
    s = qh @ kk.transpose(-1, -2)
    s_abs = qh.abs() @ kk.abs().transpose(-1, -2)
    if causal:
        s = s.masked_fill(~torch.ones(S, Sk, dtype=torch.bool,
                                      device=s.device).tril(), -math.inf)
    p = torch.softmax(s, -1)
    pe = p * (1 + s_abs)
    out = {"o": F32_U * (Sk + D) * (pe @ va)}
    if do is not None:
        da = f(do).abs()
        o_abs = p @ va
        ds = p * (da @ va.transpose(-1, -2)
                  + (da * o_abs).sum(-1, keepdim=True)) * (1 + s_abs)
        out["dq"] = F32_U * (Sk + D) * sc * (ds @ kk.abs())
        out["dk"] = F32_U * (S + D) * (ds.transpose(-1, -2) @ qh.abs())
        out["dv"] = F32_U * (S + D) * (pe.transpose(-1, -2) @ da)
    return {n: t.transpose(1, 2) for n, t in out.items()}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of x: 2^(e - 7) for |x| in [2^e,
    2^(e + 1)), the smallest normal's below it (f64)."""
    return torch.exp2(torch.floor(torch.log2(
        x.double().abs().clamp_min(2.0 ** -126))) - 7)


def past_one_ulp(got: torch.Tensor, want: torch.Tensor,
                 slack: torch.Tensor) -> int:
    """How many elements of the bf16 ``got`` lie further from the plain
    ``want`` than one ulp of it plus twice ``slack``."""
    err = (got.double() - want.double()).abs()
    return int((err > bf16_ulp(want) + 2 * slack).sum())
