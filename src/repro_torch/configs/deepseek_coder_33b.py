"""deepseek-coder-33b [dense] — arXiv:2401.14196 (llama-arch).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.  Query heads
padded 56→64 for TP=16 (+14% attention FLOPs, noted); the 8 KV heads do
not divide TP=16 and are kept replicated (tiny KV projections).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=64,       # padded from 56
    n_kv_heads=8,     # replicated across TP (8 ∤ 16)
    d_ff=19_200,
    vocab=32_256,
    head_dim=128,
)
