"""Dispatch for the SSD scan: the CUDA chunk and carry kernels, or the
plain torch version, chosen by the device the tensors lie on.

On a CUDA tensor, :func:`ssd` computes the chunk cumsum, launches the
chunk kernel for the intra-chunk term and the chunk states (bf16 on the
tensor cores at the serving shapes), then the carry kernel, which walks
the chunks in order and writes y in x's dtype and the final state; the
reference keeps that carry in jnp outside its Pallas kernel.  On a CPU
tensor it runs ``ref.ssd_ref``.  There is no fallback from one to the
other.  ``LAUNCHES`` counts chunk-kernel launches, ``CARRY_LAUNCHES``
carry-kernel launches.

The kernels have no backward yet (ROADMAP Queue 1 item 9b), and their
outputs are fresh tensors that autograd cannot see through.  So on a
CUDA tensor :func:`ssd` raises when grad is enabled and any input
requires grad, rather than return outputs cut from the graph; the plain
version is not taken in their place.  On the CPU, ``ssd_ref`` is
differentiated by autograd and the SSM and hybrid families train there.

:func:`ssd_decode` is the single-token recurrence; the reference has no
kernel for it, so its torch ops are the port on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import chunk_cumsum, ssd_decode_ref, ssd_ref

# Kernel launches made through this module (reset them to 0 and read them
# back around a run).
LAUNCHES = 0          # the chunk kernel
CARRY_LAUNCHES = 0    # the carry kernel


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64,
        init_state: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See ``ref.ssd_ref`` for shapes: (y in x's dtype, final state fp32)."""
    global LAUNCHES, CARRY_LAUNCHES
    device = x.device
    if device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    if device.type != "cuda":
        raise ValueError(f"ssd has no path for device {device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        raise NotImplementedError(
            "the SSD kernels have no backward yet (ROADMAP Queue 1 item 9b: "
            "SSD chunk and carry backward kernels and SSM/hybrid training "
            "on the card); train the SSM and hybrid families on the CPU")
    from .kernel import ssd_carry_cuda, ssd_chunks_cuda
    out_dtype = x.dtype
    cum = chunk_cumsum(dt, A, chunk)
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        # The kernel reads x, B and C in one dtype; fp32 holds any of
        # them exactly.
        x, Bm, Cm = x.float(), Bm.float(), Cm.float()
    Cm = _dense(Cm)
    y_intra, states = ssd_chunks_cuda(
        _dense(x), dt.float().contiguous(), cum, _dense(Bm), Cm, chunk)
    LAUNCHES += 1
    if init_state is not None:
        init_state = _dense(init_state.float())
    y, final = ssd_carry_cuda(y_intra, states, cum, Cm, chunk, init_state,
                              out_dtype)
    CARRY_LAUNCHES += 1
    return y, final


def ssd_decode(x, dt, A, Bm, Cm, state):
    return ssd_decode_ref(x, dt, A, Bm, Cm, state)
