"""Dispatch for the SSD scan: CUDA intra-chunk kernel plus torch carry, or
the plain torch version, chosen by the device the tensors lie on.

On a CUDA tensor, :func:`ssd` computes the chunk cumsum, launches the
kernel for the intra-chunk term and the chunk states, and carries the
states across chunks with torch ops (``ref.ssd_combine``), as the
reference keeps that part in jnp outside its Pallas kernel.  On a CPU
tensor it runs ``ref.ssd_ref``.  There is no fallback from one to the
other.  ``LAUNCHES`` counts kernel launches.

:func:`ssd_decode` is the single-token recurrence; the reference has no
kernel for it, so its torch ops are the port on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import chunk_cumsum, ssd_combine, ssd_decode_ref, ssd_ref

# Kernel launches made through this module (reset it to 0 and read it
# back around a run).
LAUNCHES = 0


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64,
        init_state: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See ``ref.ssd_ref`` for shapes: (y in x's dtype, final state fp32)."""
    global LAUNCHES
    device = x.device
    if device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    if device.type != "cuda":
        raise ValueError(f"ssd has no path for device {device}")
    from .kernel import ssd_chunks_cuda
    out_dtype = x.dtype
    cum = chunk_cumsum(dt, A, chunk)
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        # The kernel reads x, B and C in one dtype; fp32 holds any of
        # them exactly.
        x, Bm, Cm = x.float(), Bm.float(), Cm.float()
    y_intra, states = ssd_chunks_cuda(
        x.contiguous(), dt.float().contiguous(), cum, Bm.contiguous(),
        Cm.contiguous(), chunk)
    LAUNCHES += 1
    y, final = ssd_combine(y_intra, states, cum, Cm, chunk, init_state)
    return y.to(out_dtype), final


def ssd_decode(x, dt, A, Bm, Cm, state):
    return ssd_decode_ref(x, dt, A, Bm, Cm, state)
