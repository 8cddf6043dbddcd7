"""phi3-medium-14b [dense] — arXiv:2404.14219.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE SwiGLU GQA.
Heads padded 40→48 and KV 10→16 for TP=16 divisibility (GQA ratio 3 kept);
≤20% attention-FLOP waste recorded in the roofline notes.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=48,       # padded from 40
    n_kv_heads=16,    # padded from 10
    d_ff=17_920,
    vocab=100_352,
    head_dim=128,
)
