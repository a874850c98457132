"""xlstm-1.3b — 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304;
sLSTM + mLSTM blocks (xLSTM[7:1] interleave, no separate FFN — the mLSTM
block carries a 2x inner expansion).  [arXiv:2405.04517; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=512,
    pattern=("mlstm",) * 7 + ("slstm",),
    act="gelu", norm="layernorm", rope="none", ssm_expand=2,
)
