"""mamba2-780m [ssm] — arXiv:2405.21060 (SSD, state-space duality).

48L d_model=1536 attention-free, vocab=50280 (padded → 50432),
ssm_state=128, expand=2 → d_inner=3072, head_dim=64 → 48 SSD heads.
Runs long_500k (constant-size recurrent state decode).
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_432,     # padded from 50280
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)
