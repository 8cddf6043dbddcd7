"""Dispatch for flash attention: CUDA kernel or plain torch version,
chosen by the device the tensors lie on.

``flash_attention`` takes the model's ``[B, L, H, D]`` layout (the
reference launcher's ``[B, H, L, D]`` is its transpose).  A CUDA tensor goes to the
kernel (``kernel.flash_attention_cuda``), a CPU tensor to the plain
version (``ref.attention_ref``); there is no fallback from one to the
other.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .ref import attention_ref

# Kernel launches made through this module (reset it to 0 and read it
# back around a run).
LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Lq, H, D]; k, v: [B, Lk, H, D] → [B, Lq, H, D] in q's
    dtype."""
    global LAUNCHES
    device = q.device
    if device.type == "cuda":
        from .kernel import flash_attention_cuda
        out = flash_attention_cuda(q, k, v, causal)
        LAUNCHES += 1
        return out
    if device.type == "cpu":
        return attention_ref(q, k, v, causal)
    raise ValueError(f"flash attention has no path for device {device}")

