"""Shared model components: initialisers, norms, gated activations, RoPE
and M-RoPE, on PyTorch tensors.

The counterparts of the reference package's ``models/common.py``: the norms
and rotary embeddings compute in f32 and cast back to the input's type, as
there, so a bf16 model rounds where the reference's does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


# -- initialisers --------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (at +-2) fan-in init, drawn from ``gen`` on its
    device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def typed_scale(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: what the
    reference multiplies by when it scales an array of ``dtype`` by a
    Python number (a weak type, converted to the array's type first).  A
    bf16 tensor times the result rounds once, as there; an f32 one is
    unchanged."""
    return float(torch.tensor(value, dtype=dtype))


# -- norms ---------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def norm_params(kind: str, d: int, dtype=torch.float32,
                device: str | torch.device = "cpu", lead: tuple = ()) -> dict:
    shape = lead + (d,)
    if kind == "rmsnorm":
        return {"w": torch.ones(shape, dtype=dtype, device=device)}
    return {"w": torch.ones(shape, dtype=dtype, device=device),
            "b": torch.zeros(shape, dtype=dtype, device=device)}


# -- activations ---------------------------------------------------------------

def gated_act(kind: str, up: torch.Tensor, gate: torch.Tensor
              ) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)


# -- rotary embeddings -----------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    """:func:`rope_freqs` as f32 on ``device``, made once: a copy from host
    memory at every call would make the host wait for the card."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e6
               ) -> torch.Tensor:
    """x: (..., S, H, D); pos: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                   # (D/2,)
    ang = pos[..., :, None].float() * freqs                      # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_sections_on(sections: tuple[int, int, int], half: int,
                       device: torch.device) -> torch.Tensor:
    """The position stream of each rotary frequency, ``[0] * s0 + [1] * s1
    + [2] * s2``, on ``device``, made once."""
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    sec = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    return torch.as_tensor(sec, dtype=torch.int64, device=device)


def apply_mrope(x: torch.Tensor, pos: torch.Tensor,
                sections: tuple[int, int, int], theta: float = 1e6
                ) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the rotary frequencies are split into
    three sections (temporal, height, width), each rotated by its own
    position stream.  x: (..., S, H, D); pos: (3, ..., S), for pure text
    three copies of the token index (:func:`text_mrope_positions`)."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                   # (D/2,)
    sec = _mrope_sections_on(tuple(sections), d // 2, x.device)
    # each frequency's stream: (D/2, ..., S) -> (..., S, D/2)
    pos_f = pos.float()[sec].movedim(0, -1)
    ang = pos_f * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(pos: torch.Tensor) -> torch.Tensor:
    """For text-only tokens the three M-RoPE streams coincide."""
    return pos[None].expand((3,) + tuple(pos.shape))
