"""zamba2-1.2b [hybrid] — arXiv:2411.15242 (Mamba2 + shared attn block).

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One weight-SHARED transformer block (attention + 8192-wide SwiGLU MLP)
applied every 6 Mamba2 layers → 6 applications, each with its own KV
cache.  Runs long_500k with the KV of the shared applications sharded
by sequence over 'data' (LSE-combined distributed attention).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,        # shared block MLP width
    vocab=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
)
