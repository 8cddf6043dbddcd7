"""llama3-8b [dense] — arXiv:2407.21783.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, RoPE θ=500k.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,     # replicated across TP (8 ∤ 16)
    d_ff=14_336,
    vocab=128_256,
    head_dim=128,
    rope_theta=500_000.0,
)
