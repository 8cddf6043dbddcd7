"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (kimi).

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840; MoE 64 routed
experts top-6 (+2 shared experts → shared_ff = 2·1408 = 2816).  64 experts
divide EP=16 exactly (4 per shard).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    head_dim=128,
    n_experts=64,
    n_experts_padded=64,
    top_k=6,
    shared_ff=2_816,
)
