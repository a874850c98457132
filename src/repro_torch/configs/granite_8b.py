"""granite-8b — 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152;
llama-arch, code.  [arXiv:2405.04324; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128,
    act="swiglu", norm="rmsnorm", rope="rope", tie_embeddings=True,
)
