"""AdamW with global-norm clipping and warmup-cosine schedule.

The reference's formulas over dict trees of tensors (not
``torch.optim.AdamW``, whose decay and epsilon sit elsewhere): gradients
clipped by their global norm, moments in fp32, bias correction, and the
decoupled weight decay inside the same update expression.  The
optimizer state is a tree shaped exactly like the parameters plus
``step``, a 0-d int32 tensor on the parameters' device.

:func:`adamw_update` updates the parameters and moments **in place**
(under ``torch.no_grad()``) and returns the same tensors: at full width
the parameters, gradients and two moments already take 16 bytes per
parameter, and a functional update would hold a second copy of three of
them.  A caller that needs the old values keeps a clone.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..models.common import RunConfig, tree_leaves, tree_map

PyTree = Any
F32 = torch.float32


def init_opt_state(params: PyTree) -> Dict[str, Any]:
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=F32), params)
    device = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs: PyTree) -> Dict[str, Any]:
    """ParamSpec tree for the optimizer state (mirrors params)."""
    return {"mu": param_specs, "nu": param_specs, "step": None}


def lr_schedule(step: torch.Tensor, base_lr: float, warmup: int = 100,
                total: int = 10_000) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).to(F32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(
        torch.tensor(math.pi, dtype=F32, device=step.device) * prog))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, opt: Dict[str, Any],
                 run: RunConfig) -> Tuple[PyTree, Dict[str, Any],
                                          Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params``, ``opt["mu"]`` and
    ``opt["nu"]`` are updated and returned; ``opt["step"]`` is replaced
    by ``step + 1``.  Metrics: the gradients' global norm before
    clipping and the step's learning rate (0-d fp32 tensors)."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2, eps = run.adam_b1, run.adam_b2, run.adam_eps
    lr = lr_schedule(step, run.learning_rate)
    c1 = 1 - b1 ** step.to(F32)
    c2 = 1 - b2 ** step.to(F32)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt["mu"]), tree_leaves(opt["nu"])):
        g = g.to(F32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        p32 = p.to(F32)
        p.copy_(p32 - lr * (m / c1 / (torch.sqrt(v / c2) + eps)
                            + run.weight_decay * p32))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": opt["mu"], "nu": opt["nu"], "step": step}, metrics
