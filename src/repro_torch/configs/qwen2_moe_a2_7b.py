"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936; MoE 60 routed
experts top-4 + 4 shared experts (shared_ff = 4·1408 = 5632).  Routed
experts padded 60→64 for EP=16 divisibility (dead experts masked in the
router; ~6% expert-capacity waste, noted in the roofline table).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151_936,
    head_dim=128,
    n_experts=60,
    n_experts_padded=64,
    top_k=4,
    shared_ff=5_632,
)
