"""Dispatch for flash attention: CUDA kernels or plain torch version,
chosen by the device the tensors lie on.

``flash_attention`` takes the model's ``[B, L, H, D]`` layout (the
reference launcher's ``[B, H, L, D]`` is its transpose).  A CPU tensor
goes to the plain version (``ref.attention_ref``), which autograd
differentiates.  A CUDA tensor goes to the kernels; there is no fallback
from one to the other:

* with grad disabled, or on inputs that need no grad (serving), one
  launch of the forward kernel (``kernel.flash_attention_cuda``), which
  writes no log-sum-exp;
* otherwise through the operator ``repro_torch::flash_attention_fwd``
  (``torch.library.custom_op``): the same kernel, also writing each
  row's log-sum-exp, with the three backward kernels
  (``kernel.flash_attention_bwd_cuda``), which recompute P from that
  log-sum-exp, registered as its gradient.

As one operator the training forward is seen by selective activation
checkpointing (``models/layers.py``'s ``remat="dots"``), which can keep
its output instead of launching it again in the backward, as the
reference's ``checkpoint_dots`` keeps attention's products.

``LAUNCHES`` counts forward-kernel launches, ``BWD_LAUNCHES`` backward
passes; each backward pass launches each of the three backward kernels
once.
"""
# No ``from __future__ import annotations``: ``custom_op`` reads the
# operator's schema from the annotations.
from typing import Tuple

import torch

from .ref import attention_ref

# Kernel launches made through this module (reset them to 0 and read
# them back around a run).
LAUNCHES = 0       # the forward kernel
BWD_LAUNCHES = 0   # backward passes: one launch of each backward kernel


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with its log-sum-exp: (o [B, Lq, H, D] in q's
    dtype, lse fp32 [B, H, Lq]).  CUDA tensors only."""
    global LAUNCHES
    from .kernel import flash_attention_cuda
    out, lse = flash_attention_cuda(q, k, v, causal, lse=True)
    LAUNCHES += 1
    return out, lse


@flash_attention_fwd.register_fake
def _(q, k, v, causal):
    B, Lq, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Lq), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    """The three backward kernels (``kernel.flash_attention_bwd_cuda``),
    from the saved q, k, v, output and its log-sum-exp, not P: they
    recompute it tile by tile."""
    global BWD_LAUNCHES
    from .kernel import flash_attention_bwd_cuda
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, do.contiguous(),
                                          lse, ctx.causal)
    BWD_LAUNCHES += 1
    return dq, dk, dv, None


flash_attention_fwd.register_autograd(_backward,
                                      setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Lq, H, D]; k, v: [B, Lk, H, D] → [B, Lq, H, D] in q's
    dtype."""
    global LAUNCHES
    device = q.device
    if device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_fwd(q, k, v, causal)[0]
        from .kernel import flash_attention_cuda
        out = flash_attention_cuda(q, k, v, causal)
        LAUNCHES += 1
        return out
    if device.type == "cpu":
        return attention_ref(q, k, v, causal)
    raise ValueError(f"flash attention has no path for device {device}")
