"""whisper-large-v3 — enc-dec, 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866; conv frontend is a STUB (input_specs provides precomputed
frame embeddings).  [arXiv:2212.04356; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    encoder_layers=32, enc_frames=1500,
    act="gelu", norm="layernorm", rope="none",   # whisper uses learned pos
)
