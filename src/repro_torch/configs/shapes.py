"""Assigned input shapes (identical across the 10 LM-family archs).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache / SSM state of ``seq_len``), NOT ``train_step``.  Eligibility rules
follow the assignment:
  - long_500k only for sub-quadratic archs (ssm / hybrid);
  - decode shapes skipped for encoder-only archs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def skip_reason(cfg: ModelConfig, shape: Shape) -> Optional[str]:
    """None → run the cell; str → skip with this reason (recorded)."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "full-attention arch: 500k context needs sub-quadratic mixing"
    return None
