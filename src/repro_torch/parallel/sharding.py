"""Sharding assembly (the reference's ``repro/parallel/sharding.py``):
glue between the parameter specs' logical axes, a device mesh, and the
DTensor placements of the train / prefill / decode entry points.

Where the reference builds a ``NamedSharding`` from a partition spec,
this module gives the DTensor placement list of the same spec
(``models.common.placements``).  A mesh is a ``DeviceMesh`` with named
dimensions, or any object with its ``mesh_dim_names``, ``shape`` and
``ndim`` (the placements need nothing else).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.common import (LONG_RULES, SERVE_RULES, TRAIN_RULES,
                             logical_to_pspec, param_pspecs, placements,
                             tree_leaves, tree_map, tree_unflatten)
from ..models.registry import Model
from .ctx import is_dtensor

PyTree = Any


def rules_for(kind: str, long_context: bool = False) -> Dict[str, Any]:
    if kind == "train":
        return TRAIN_RULES
    return LONG_RULES if long_context else SERVE_RULES


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def model_param_shardings(model: Model, mesh, kind: str = "train",
                          long_context: bool = False) -> PyTree:
    """A placement list per parameter leaf."""
    pspecs = param_pspecs(model.specs(), rules_for(kind, long_context),
                          mesh.mesh_dim_names, mesh_axis_sizes(mesh))
    return tree_map(lambda ps: placements(ps, mesh), pspecs)


def _batch_axes(axes, multi_pod: bool):
    """The batch axis spans (pod, data) on multi-pod meshes."""
    return tuple(("pod_batch" if (x == "batch" and multi_pod) else x)
                 for x in axes)


def batch_shardings(model: Model, mesh, shape_name: str,
                    kind: str = "train", long_context: bool = False) -> Dict:
    """A placement list per model input of the cell."""
    rules = rules_for(kind, long_context)
    sizes = mesh_axis_sizes(mesh)
    multi_pod = "pod" in mesh.mesh_dim_names
    specs = model.input_specs(shape_name)
    return {k: placements(logical_to_pspec(
                _batch_axes(a, multi_pod), rules, mesh.mesh_dim_names,
                specs[k][0], sizes), mesh)
            for k, a in model.input_axes(shape_name).items()}


def state_shardings(model: Model, mesh, shape_name: str,
                    long_context: bool = False) -> Optional[Dict]:
    """A placement list per decode-state leaf of the cell (None where
    the cell has no state)."""
    sspecs = model.state_specs(shape_name)
    if sspecs is None:
        return None
    rules = rules_for("serve", long_context)
    sizes = mesh_axis_sizes(mesh)
    multi_pod = "pod" in mesh.mesh_dim_names
    axes = model.state_axes()
    tp = sizes.get("model", 1)
    out = {}
    for k, (shape, _) in sspecs.items():
        a = _batch_axes(axes[k], multi_pod)
        if k in ("k", "v") and not long_context:
            # KV cache: prefer sharding kv heads over 'model'; when the
            # head count doesn't divide TP, shard the cache *sequence*
            # over 'model' instead (keeps the per-device cache small for
            # the 32k decode cells of 8-KV-head archs).
            if model.cfg.n_kv_heads % tp != 0:
                a = tuple(("seq_model" if x == "seq" else x) for x in a)
                rules = dict(rules)
                rules["seq_model"] = "model"
        out[k] = placements(logical_to_pspec(
            a, rules, mesh.mesh_dim_names, shape, sizes), mesh)
    return out


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def round_buffer_placement(mesh=None):
    """Mesh placement for the batched-round ``[B, T, V]`` pair buffers
    (``core.cycles``' round buffers).

    Stubbed seam, as in the reference: the round buffers are staged per
    round as they are without a mesh, so the only placement is fully
    replicated (member rows are independent; splitting B across a mesh
    axis is deferred tuning).  ``core.cycles`` consumes this lazily via
    ``set_round_buffer_mesh`` so this module's model imports stay off
    the simulation hot path.  Returns ``None`` when no mesh is given."""
    if mesh is None:
        return None
    return replicated(mesh)


def distribute(tree: PyTree, mesh, placement_tree: PyTree) -> PyTree:
    """Each plain-tensor leaf of ``tree`` split onto ``mesh`` by its
    placement list in ``placement_tree`` (a tree shaped like ``tree``);
    a leaf that already is a DTensor is laid out on its placements.
    Every rank passes the same whole tensor (the same seed, the same
    checkpoint): each cuts its own shard from it, with no collective —
    on a one-rank mesh the DTensor holds the tensor itself."""
    from torch.distributed.tensor import distribute_tensor
    out = []
    for x, pl in zip(tree_leaves(tree), tree_leaves(placement_tree)):
        if is_dtensor(x):
            out.append(x if tuple(x.placements) == tuple(pl)
                       else x.redistribute(mesh, pl))
        else:
            out.append(distribute_tensor(torch.as_tensor(x), mesh, pl,
                                         src_data_rank=None))
    return tree_unflatten(tree, out)


def whole(x):
    """A DTensor gathered whole (a collective: every rank of its mesh
    calls it); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def full(tree: PyTree) -> PyTree:
    """Every DTensor leaf of ``tree`` gathered whole (:func:`whole`)."""
    return tree_map(whole, tree)


def placements_of(tree: PyTree) -> PyTree:
    """The placement list of every DTensor leaf (None for a plain one)."""
    return tree_map(lambda x: list(x.placements) if is_dtensor(x)
                    else None, tree)
