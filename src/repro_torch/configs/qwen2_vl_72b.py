"""qwen2-vl-72b — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064;
M-RoPE, dynamic resolution (vision frontend is a STUB: input_specs provides
precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    rope="mrope", mrope_sections=(16, 24, 24),
    act="swiglu", norm="rmsnorm", vlm_patches=1024,
)
