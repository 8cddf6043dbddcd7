"""Training step builders.

``make_train_step(model, mesh=None)`` returns a (params, opt, batch) →
(params, opt, metrics) function, the reference's step:

- gradients by ``torch.autograd.grad`` over the parameter tree's leaves
  (all floating), the layer bodies under the run's remat policy (none /
  dots / full, ``models/layers.py::remat``);
- optional gradient accumulation over microbatches (``run.microbatch``):
  the reference's Python-loop branch, the mean of the microbatch
  gradients and losses, the auxiliary loss dropped from the metrics;
- optional single cast of the parameter tree to the compute dtype at
  step entry (``run.cast_params_once``), differentiated through;
- the AdamW update of ``optim.adamw_update``, in place;
- with a ``DeviceMesh``, all of it inside ``parallel.ctx.scope(mesh,
  train_rules(run))``: parameters, moments and batch are DTensors, the
  model's ``constrain`` calls lay the residual stream out on the rules,
  the kernels run on each rank's shards, and AdamW's elementwise update
  runs on the local shards (only the gradients' global norm is reduced).

``build_train_step(model, mesh, shape_name)`` adds the reference's
explicit layout: it returns the step with the placements of parameters,
optimizer state and batch, and splits inputs that arrive as plain
tensors onto them.

``RunConfig.grad_compression`` is not wired: the reference's docstring
says its ``'int8'`` value compresses the data-parallel gradient
reduction, but its step never reads it, and neither does this one.
``parallel/collectives.py`` holds the int8 all-reduce, with no caller.

The batch (numpy arrays or tensors) is moved to the model's device; the
step runs there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.common import (TRAIN_RULES, RunConfig, cast_tree, tree_leaves,
                             tree_map, tree_unflatten)
from ..models.registry import Model
from ..parallel import ctx
from ..parallel import sharding as shd
from . import optim

PyTree = Any


def _on_device(model: Model, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}


def _detached(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def train_rules(run: RunConfig) -> Dict[str, Any]:
    rules = dict(TRAIN_RULES)
    if not run.seq_parallel:
        rules["seq_act"] = None
    return rules


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_host_mesh), not "
                        f"{type(mesh).__name__}")


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
    """The train step of ``model`` (see the module docstring), sharded
    when ``mesh`` (a ``DeviceMesh``) is given.  The returned step updates
    ``params`` and the moments of ``opt`` in place and returns them with
    the new ``step``; on a mesh its metrics are whole tensors."""
    if mesh is not None:
        _check_mesh(mesh)
    run = model.run

    def step(params, opt, batch) -> Tuple[PyTree, Dict, Dict]:
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

    if mesh is None:
        return step
    rules = train_rules(run)

    def train_step(params, opt, batch) -> Tuple[PyTree, Dict, Dict]:
        with ctx.scope(mesh, rules):
            params, opt, metrics = step(params, opt, batch)
        return params, opt, shd.full(metrics)

    return train_step


def build_train_step(model: Model, mesh, shape_name: str = "train_4k"):
    """The sharded step with the reference's explicit layout: returns
    ``(fn, param_placements, opt_placements, batch_placements)``, each a
    tree of DTensor placement lists.  ``fn(params, opt, batch)`` splits
    any plain-tensor input onto its placements (every rank passes the
    same whole values) and runs ``make_train_step(model, mesh)``."""
    _check_mesh(mesh)
    param_pl = shd.model_param_shardings(model, mesh, kind="train")
    opt_pl = {"mu": param_pl, "nu": param_pl, "step": shd.replicated(mesh)}
    batch_pl = shd.batch_shardings(model, mesh, shape_name, kind="train")
    step = make_train_step(model, mesh)

    def fn(params, opt, batch):
        batch = _on_device(model, batch)
        pl = {k: batch_pl.get(k, shd.replicated(mesh)) for k in batch}
        return step(shd.distribute(params, mesh, param_pl),
                    shd.distribute(opt, mesh, opt_pl),
                    shd.distribute(batch, mesh, pl))

    return fn, param_pl, opt_pl, batch_pl
