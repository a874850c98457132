"""phi4-mini-3.8b — 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064;
RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
    act="swiglu", norm="rmsnorm", rope="rope", tie_embeddings=True,
)
