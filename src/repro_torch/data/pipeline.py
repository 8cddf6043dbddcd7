"""Deterministic synthetic data pipeline.

Shardable by construction: batch ``i`` of host ``h`` is a pure function of
(seed, step, h, i), so any host can regenerate any shard — exactly the
property elastic restarts need (no data-state checkpoint beyond ``step``).

A copy of the reference's numpy module (``ModelConfig`` from the port's
``models.common``): ``batch_at`` gives the reference's arrays bit for
bit.  Batches stay numpy; the train step moves them to the model's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 4096
    global_batch: int = 256
    vocab: int = 32_000


def batch_at(cfg: DataConfig, step: int, model_cfg: Optional[ModelConfig] = None
             ) -> Dict[str, np.ndarray]:
    """The full global batch for ``step`` (hosts slice their shard)."""
    rng = np.random.default_rng((cfg.seed, step))
    B, L = cfg.global_batch, cfg.seq_len
    fam = model_cfg.family if model_cfg is not None else "dense"
    if fam == "audio":
        d = model_cfg.frame_dim
        frames = rng.normal(size=(B, L, d)).astype(np.float32)
        labels = rng.integers(0, model_cfg.vocab, (B, L), dtype=np.int32)
        mask = rng.random((B, L)) < 0.08            # HuBERT-style mask rate
        return {"frames": frames, "labels": labels, "mask": mask}
    vocab = model_cfg.vocab if model_cfg is not None else cfg.vocab
    # Zipf-ish marginals + markov-ish structure: cheap but non-degenerate.
    tokens = rng.integers(0, vocab, (B, L), dtype=np.int32)
    out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": tokens}
    if fam == "vlm":
        out["patches"] = rng.normal(
            size=(B, model_cfg.n_patches, model_cfg.patch_dim)
        ).astype(np.float32)
        mask = np.ones((B, L), bool)
        mask[:, :model_cfg.n_patches] = False       # no loss on patch prefix
        out["mask"] = mask
    return out


def stream(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None,
           start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, model_cfg)
        step += 1
