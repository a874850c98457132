"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2; Mamba+attention 1:7 interleave, MoE every other
layer.  [arXiv:2403.19887; hf]"""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    moe=MoECfg(n_experts=16, top_k=2, every_k_layers=2),
    pattern=("mamba", "mamba", "mamba", "mamba",
             "attn", "mamba", "mamba", "mamba"),
    act="swiglu", norm="rmsnorm", rope="none",   # jamba: no rope in attn
    d_state=16, d_conv=4, ssm_expand=2,
)
