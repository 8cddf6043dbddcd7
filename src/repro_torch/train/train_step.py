"""Training step builder, on one device.

``make_train_step(model)`` returns a (params, opt, batch) → (params, opt,
metrics) function, the reference's unsharded step:

- gradients by ``torch.autograd.grad`` over the parameter tree's leaves
  (all floating), the layer bodies under the run's remat policy (none /
  dots / full, ``models/layers.py::remat``);
- optional gradient accumulation over microbatches (``run.microbatch``):
  the reference's Python-loop branch, the mean of the microbatch
  gradients and losses, the auxiliary loss dropped from the metrics;
- optional single cast of the parameter tree to the compute dtype at
  step entry (``run.cast_params_once``), differentiated through;
- the AdamW update of ``optim.adamw_update``, in place.

The batch (numpy arrays or tensors) is moved to the model's device; the
step runs there.  The sharded step (``build_train_step``, ``train_rules``,
the int8 gradient compression) comes with the parallelism slice (ROADMAP
Queue 1 item 11): ``make_train_step`` with a mesh raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.common import cast_tree, tree_leaves, tree_map, tree_unflatten
from ..models.registry import Model
from . import optim

PyTree = Any


def _on_device(model: Model, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}


def _detached(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def _value_and_grad(lf, params: PyTree):
    """(loss, metrics) of ``lf(params)`` and its gradient with respect to
    every leaf, as a tree shaped like ``params`` (a leaf the loss does
    not reach gets zeros, as JAX gives)."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.is_floating_point():
            raise TypeError(f"cannot differentiate a {p.dtype} parameter")
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = lf(tree_unflatten(params, xs))
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return loss.detach(), _detached(metrics), tree_unflatten(params, gs)


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the batch
    (numpy arrays or tensors) is moved to the model's device."""
    batch = _on_device(model, batch)
    loss, metrics, grads = _value_and_grad(
        lambda p: model.loss(p, batch), params)
    return loss, metrics, grads


def cast_loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params`` cast once to
    the run's compute dtype (``run.cast_params_once``): the cast lies
    inside the differentiated function, so the gradients are fp32 like
    ``params``."""
    batch = _on_device(model, batch)
    dtype = model.run.compute_dtype
    return _value_and_grad(
        lambda p32: model.loss(cast_tree(p32, dtype), batch), params)


def _accum_microbatches(model: Model, params, batch, n_micro: int):
    """Gradient accumulation over microbatches (memory ↓ n_micro×): the
    reference's Python-loop branch."""
    def micro(x, i):
        b = x.shape[0] // n_micro
        return x.reshape(n_micro, b, *x.shape[1:])[i]

    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    losses = []
    for i in range(n_micro):
        mb = {k: micro(v, i) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(model, params, mb)
        acc = tree_unflatten(acc, [a + g / n_micro for a, g in
                               zip(tree_leaves(acc), tree_leaves(grads))])
        losses.append(loss)
    mean = torch.mean(torch.stack(losses))
    return mean, {"loss": mean}, acc


def make_train_step(model: Model, mesh: Optional[Any] = None):
    """The unsharded train step of ``model`` (see the module docstring).
    The returned step updates ``params`` and the moments of ``opt`` in
    place and returns them with the new ``step``."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded train step comes with the parallelism slice "
            "(ROADMAP Queue 1 item 11); pass mesh=None")
    run = model.run

    def train_step(params, opt, batch) -> Tuple[PyTree, Dict, Dict]:
        batch = _on_device(model, batch)
        if run.cast_params_once:
            # a single tree-cast inside the grad
            if run.microbatch and run.microbatch > 1:
                raise ValueError(
                    "cast_params_once + microbatch not combined yet")
            loss, metrics, grads = cast_loss_and_grads(model, params, batch)
        elif run.microbatch and run.microbatch > 1:
            loss, metrics, grads = _accum_microbatches(
                model, params, batch, run.microbatch)
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        params, opt, opt_metrics = optim.adamw_update(params, grads, opt,
                                                      run)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt, metrics

    return train_step
