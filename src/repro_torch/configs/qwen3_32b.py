"""qwen3-32b [dense] — hf:Qwen/Qwen3-8B family scaled per assignment.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk-norm enabled.
head_dim=128 per the Qwen3 family (q/k RMS-normed per head before RoPE).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,     # replicated across TP (8 ∤ 16)
    d_ff=25_600,
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
