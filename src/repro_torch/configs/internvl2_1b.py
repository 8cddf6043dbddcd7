"""internvl2-1b [vlm] — arXiv:2404.16821 (InternViT + InternLM2 backbone).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 (padded → 151680).
The transformer BACKBONE only: the InternViT frontend is a STUB —
``input_specs()`` provides 256 precomputed patch embeddings (dim 1024)
that are projected and placed at the sequence prefix.  Heads padded
14→16 for TP=16; the 2 KV heads stay replicated.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=16,       # padded from 14
    n_kv_heads=2,     # replicated across TP (2 ∤ 16)
    d_ff=4864,
    vocab=151_680,    # padded from 151655
    head_dim=64,
    n_patches=256,
    patch_dim=1024,
)
