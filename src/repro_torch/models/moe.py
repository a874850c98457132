"""The dense feed-forward block on PyTorch tensors — the dense half of the
reference package's ``models/moe.py``.  The mixture of experts
(``moe_params``, ``route``, ``apply_moe``) is not ported yet (ROADMAP.md,
Queue 1, item 11)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, gated_act


def dense_ffn_params(gen: torch.Generator, cfg, dtype=torch.float32,
                     lead: tuple = ()) -> dict:
    """The FFN weights, each with the leading axes ``lead``."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(gen, lead + (d, f), dtype),
         "w_down": dense_init(gen, lead + (f, d), dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, lead + (d, f), dtype)
    return p


def apply_dense_ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = gated_act(cfg.act, up, x @ p["w_gate"])
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]
