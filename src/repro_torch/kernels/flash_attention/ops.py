"""Dispatch for flash attention: CUDA kernels or plain torch version,
chosen by the device the tensors lie on.

``flash_attention`` takes the model's ``[B, L, H, D]`` layout (the
reference launcher's ``[B, H, L, D]`` is its transpose).  A CPU tensor
goes to the plain version (``ref.attention_ref``), which autograd
differentiates.  A CUDA tensor goes to the kernels; there is no fallback
from one to the other.  Every launch goes through an operator
(``torch.library.custom_op``) with a fake, so that the dry run
(``launch/dryrun.py``) traces the card's path under ``FakeTensorMode``
without launching, and with a flop formula
(``torch.utils.flop_counter``), so that ``FlopCounterMode`` and the dry
run count the kernels' work:

* with grad disabled, or on inputs that need no grad (serving),
  ``repro_torch::flash_attention_fwd_nolse``: one launch of the forward
  kernel (``kernel.flash_attention_cuda``), which writes no log-sum-exp;
* otherwise ``repro_torch::flash_attention_fwd``: the same kernel, also
  writing each row's log-sum-exp, with its gradient registered, the
  operator ``repro_torch::flash_attention_bwd``: the three backward
  kernels (``kernel.flash_attention_bwd_cuda``), which recompute P from
  that log-sum-exp.

As one operator the training forward is seen by selective activation
checkpointing (``models/layers.py``'s ``remat="dots"``), which can keep
its output instead of launching it again in the backward, as the
reference's ``checkpoint_dots`` keeps attention's products.

Flops (``PERF.md``'s bounds): 4·D per unmasked (query, key) pair
forward, 10·D backward (Q·Kᵀ and P·V forward; Q·Kᵀ again, dO·Vᵀ, Pᵀ·dO,
dSᵀ·Q and dS·K backward); a causal row i of Lq sees keys up to
i + Lk − Lq, so B·H·Lq(Lq+1)/2 pairs for Lq = Lk.

``LAUNCHES`` counts forward-kernel launches, ``BWD_LAUNCHES`` backward
passes; each backward pass launches each of the three backward kernels
once.
"""
# No ``from __future__ import annotations``: ``custom_op`` reads the
# operator's schema from the annotations.
from typing import Tuple

import torch

from torch.utils.flop_counter import register_flop_formula

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


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three backward kernels (``kernel.flash_attention_bwd_cuda``),
    from q, k, v, the output and its log-sum-exp, not P: they recompute
    it tile by tile.  (dq, dk, dv) in q's dtype.  CUDA tensors only."""
    global BWD_LAUNCHES
    from .kernel import flash_attention_bwd_cuda
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, do.contiguous(),
                                          lse, causal)
    BWD_LAUNCHES += 1
    return dq, dk, dv


@flash_attention_bwd.register_fake
def _(q, k, v, out, do, lse, causal):
    return (q.new_empty(q.shape), k.new_empty(k.shape),
            v.new_empty(v.shape))


def _backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, ctx.causal)
    return dq, dk, dv, None


flash_attention_fwd.register_autograd(_backward,
                                      setup_context=_setup_context)


@torch.library.custom_op("repro_torch::flash_attention_fwd_nolse",
                        mutates_args=())
def flash_attention_fwd_nolse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The forward kernel without its log-sum-exp (serving): o
    [B, Lq, H, D] in q's dtype.  CUDA tensors only."""
    global LAUNCHES
    from .kernel import flash_attention_cuda
    out = flash_attention_cuda(q, k, v, causal)
    LAUNCHES += 1
    return out


@flash_attention_fwd_nolse.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


def attention_pairs(B: int, H: int, Lq: int, Lk: int, causal: bool) -> int:
    """Unmasked (query, key) pairs: a causal row i sees keys
    0 .. i + Lk - Lq."""
    if not causal:
        return B * H * Lq * Lk
    return B * H * (Lq * (Lq + 1) // 2 + Lq * (Lk - Lq))


@register_flop_formula([torch.ops.repro_torch.flash_attention_fwd,
                        torch.ops.repro_torch.flash_attention_fwd_nolse])
def _fwd_flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    B, Lq, H, D = q_shape
    return 4 * D * attention_pairs(B, H, Lq, k_shape[1], causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape, lse_shape,
               causal, *args, **kwargs) -> int:
    B, Lq, H, D = q_shape
    return 10 * D * attention_pairs(B, H, Lq, k_shape[1], causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Lq, H, D]; k, v: [B, Lk, H, D] → [B, Lq, H, D] in q's
    dtype."""
    device = q.device
    if device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_fwd(q, k, v, causal)[0]
        return flash_attention_fwd_nolse(q, k, v, causal)
    if device.type == "cpu":
        return attention_ref(q, k, v, causal)
    raise ValueError(f"flash attention has no path for device {device}")
