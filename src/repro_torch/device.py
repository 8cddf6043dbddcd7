"""Where the port runs: ``device=None`` means ``"cuda"``."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no CUDA available
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
