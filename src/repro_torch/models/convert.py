"""Weight carry-over: a parameter (or state) tree of numpy arrays → the
port's tensors, with the same nested keys.

The reference's trees are nested dicts of JAX arrays; ``np.asarray`` of
each leaf gives the numpy tree this module takes.  bfloat16 leaves
(numpy's ``ml_dtypes`` bfloat16) are carried bit for bit.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from ..device import resolve_device


def to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # a JAX array's buffer is read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any,
                      device: Union[None, str, torch.device] = None) -> Any:
    """Same nested dict, each leaf a tensor on ``device`` (``None`` means
    ``"cuda"``, raising without CUDA)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return to_tensor(t, dev)
    return walk(tree)
