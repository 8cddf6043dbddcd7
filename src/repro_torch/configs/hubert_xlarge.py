"""hubert-xlarge [audio] — arXiv:2106.07447 (w2v2-style encoder-only).

48L d_model=1280 16H d_ff=5120 vocab=504 (padded → 512 for TP=16).
Encoder-only (bidirectional attention, no decode step).  The modality
frontend (CNN feature extractor) is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings [B, L, 1280].
Training objective: masked-frame cluster prediction (CE on masked
positions), mask supplied with the batch.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=512,        # padded from 504
    head_dim=80,
    causal=False,
    frame_dim=1280,
)
