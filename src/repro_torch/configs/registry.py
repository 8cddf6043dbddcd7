"""Architecture registry: ``--arch <id>`` → ModelConfig, plus the
(arch × shape) cell enumeration used by the dry-run and roofline passes.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, List, Optional, Tuple

from ..models.common import ModelConfig
from .shapes import SHAPE_ORDER, SHAPES, Shape, skip_reason

ARCH_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-32b": "qwen3_32b",
    "llama3-8b": "llama3_8b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-1b": "internvl2_1b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-1.2b": "zamba2_1p2b",
}

ARCH_IDS: Tuple[str, ...] = tuple(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f".{ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


def cells() -> Iterator[Tuple[str, Shape, Optional[str]]]:
    """All 40 (arch × shape) cells with skip reasons (None → runnable)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname in SHAPE_ORDER:
            shape = SHAPES[sname]
            yield arch, shape, skip_reason(cfg, shape)
