"""Architecture configuration system.

The port's copy of the reference package's ``models/config.py``, changed
only in its import paths.  One :class:`ArchConfig` per assigned
architecture (``configs/<id>.py``) plus reduced "smoke" variants for CPU
tests.  The config fully determines the
parameter pytree, the layer pattern (dense / MoE / SSM / hybrid interleave),
and the scan grouping used to keep HLO size O(1) in depth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    every_k_layers: int = 1         # jamba: MoE every other layer
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    moe: MoECfg | None = None
    # layer mixer pattern, cycled over depth. entries: "attn" | "mamba"
    # | "mlstm" | "slstm".  jamba = 7 mamba : 1 attn; xlstm = 7 mlstm : 1 slstm
    pattern: tuple[str, ...] = ("attn",)
    encoder_layers: int = 0         # whisper: encoder depth (enc-dec if > 0)
    enc_frames: int = 1500          # whisper: fixed encoder positions
    rope: Literal["rope", "mrope", "none"] = "rope"
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False
    d_state: int = 16               # mamba SSM state size
    d_conv: int = 4                 # mamba conv width
    ssm_expand: int = 2             # mamba/mlstm inner expansion
    vlm_patches: int = 0            # qwen2-vl: stub patch positions
    rope_theta: float = 1e6
    # ---- derived -----------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def layer_is_moe(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every_k_layers
                                         == self.moe.every_k_layers - 1)

    @property
    def group_size(self) -> int:
        """Layers per scan group: the period of (pattern x MoE cadence)."""
        period = len(self.pattern)
        if self.moe is not None:
            period = math.lcm(period, self.moe.every_k_layers)
        return period

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"group_size={self.group_size}")
        return self.n_layers // self.group_size

    @property
    def is_subquadratic(self) -> bool:
        """True if inter-token mixing is O(1)-state (SSM / hybrid / xLSTM)."""
        return any(k in ("mamba", "mlstm", "slstm") for k in self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def _attn_params(self) -> int:
        qkv = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.hd
        o = self.n_heads * self.hd * self.d_model
        return qkv + o

    def _ffn_params(self, moe_layer: bool) -> tuple[int, int]:
        """(total, active) FFN params for one layer."""
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        dense = mult * self.d_model * self.d_ff
        if moe_layer and self.moe is not None:
            total = self.moe.n_experts * dense + self.d_model * self.moe.n_experts
            active = self.moe.top_k * dense + self.d_model * self.moe.n_experts
            return total, active
        return dense, dense

    def _mixer_params(self, kind: str) -> int:
        d, di, ds = self.d_model, self.d_inner, self.d_state
        if kind == "attn":
            return self._attn_params()
        if kind == "mamba":
            # in_proj (d -> 2*di), conv, x-dependent (dt, B, C), out_proj
            return (d * 2 * di + self.d_conv * di + di * (ds * 2 + di // 16 + 1)
                    + di * ds + di * d)
        if kind == "mlstm":
            # in_proj (d -> 2*di: main + gate), diagonal q/k transforms,
            # per-head i/f gate projections, out_proj
            return d * 2 * di + 2 * di + 2 * di + di * d
        if kind == "slstm":
            # 4 input-gate projections + block-diagonal (per-head) recurrence
            return 4 * d * d + 4 * d * d // max(self.n_heads, 1) + 4 * d
        raise ValueError(kind)

    def param_counts(self) -> dict[str, float]:
        """Returns total and active (MoE) parameter counts."""
        emb = self.vocab * self.d_model
        total = active = emb if self.tie_embeddings else 2 * emb
        for i in range(self.n_layers):
            m = self._mixer_params(self.layer_kind(i))
            if self.d_ff > 0:
                f_total, f_active = self._ffn_params(self.layer_is_moe(i))
            else:
                f_total = f_active = 0
            total += m + f_total
            active += m + f_active
        if self.is_encdec:
            for _ in range(self.encoder_layers):
                m = self._attn_params()
                f = (3 if self.act == "swiglu" else 2) * self.d_model * self.d_ff
                total += m + f
                active += m + f
            # decoder cross-attention
            total += self.n_layers * self._attn_params()
            active += self.n_layers * self._attn_params()
        return {"total": float(total), "active": float(active)}

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        d = {
            "name": self.name + "-smoke",
            "n_layers": self.group_size,
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            "d_ff": 128 if self.d_ff else 0,
            "vocab": 256,
            "head_dim": 16,
            "encoder_layers": min(self.encoder_layers, 2),
            "enc_frames": 16 if self.is_encdec else self.enc_frames,
            "vlm_patches": 8 if self.vlm_patches else 0,
            "d_state": 8,
            # capacity_factor=4 -> no token drops, so the decode-equivalence
            # invariant holds exactly (saturated capacity legitimately breaks
            # prefill<->decode equality in capacity-routed MoE)
            "moe": (MoECfg(n_experts=4, top_k=min(self.moe.top_k, 2),
                           every_k_layers=self.moe.every_k_layers,
                           capacity_factor=4.0)
                    if self.moe else None),
            "mrope_sections": (4, 2, 2),   # sums to head_dim(16) // 2
        }
        d.update(overrides)
        return dataclasses.replace(self, **d)
