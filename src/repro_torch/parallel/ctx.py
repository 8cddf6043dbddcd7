"""Sharding context (the reference's ``repro/parallel/ctx.py``).

Model code is mesh-agnostic: it calls ``constrain(x, logical_axes)`` on
hot intermediates (the residual stream) and runs the kernels through
:func:`local_call`.  The step builders enter a :func:`scope` around the
step, so those calls bind to the active mesh and rule set and no-op
otherwise (single-device runs, oracle runs).

Under a scope, parameters and batches are DTensors.  A plain tensor that
model code makes on the fly (positions, masks, zero buffers) meets them
as a replicated DTensor (``implicit_replication``), the way a constant
meets a sharded array under ``jax.jit``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# ``models`` imports this module; the rule functions (``models.common``)
# and ``sharding.mesh_axis_sizes`` are imported where they are called.

_state = threading.local()


def current() -> Optional[Tuple]:
    """``(mesh, rules)`` of the innermost scope, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the setting it found
    on exit: the library's own context manager switches it off, which a
    nested scope (a layer body recomputed during the backward) would do
    to the step around it, whose backward still meets plain tensors
    saved in the forward (positions, masks)."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


@contextlib.contextmanager
def scope(mesh, rules: Dict[str, Optional[str]]):
    prev = current()
    _state.ctx = (mesh, rules)
    try:
        with _implicit_replication():
            yield
    finally:
        _state.ctx = prev


def carry(fn: Callable) -> Callable:
    """``fn`` run inside the current scope wherever it is called.  A
    checkpointed layer body is run again during the backward, which
    autograd runs on a thread of its own for a CUDA device, where the
    thread-local scope is not set; the body carries the scope it was
    built under.  Outside a scope, ``fn`` itself."""
    ctx = current()
    if ctx is None:
        return fn

    def inner(*args, **kwargs):
        with scope(*ctx):
            return fn(*args, **kwargs)
    return inner


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def axes_placements(axes: Sequence[Optional[str]],
                    shape: Sequence[int]) -> list:
    """The placements that ``axes`` of a tensor of ``shape`` take under
    the current scope's rules; a sharding that does not divide its
    dimension is replicated."""
    from ..models.common import logical_to_pspec, placements
    from .sharding import mesh_axis_sizes
    mesh, rules = current()
    ps = logical_to_pspec(axes, rules, mesh.mesh_dim_names, tuple(shape),
                          mesh_axis_sizes(mesh))
    return placements(ps, mesh)


def shards(axis: str, size: int) -> bool:
    """Whether the current scope's rules split logical ``axis`` of
    ``size`` over the mesh (False outside a scope)."""
    ctx = current()
    if ctx is None:
        return False
    from ..models.common import logical_to_pspec
    from .sharding import mesh_axis_sizes
    mesh, rules = ctx
    return logical_to_pspec((axis,), rules, mesh.mesh_dim_names, (size,),
                            mesh_axis_sizes(mesh))[0] is not None


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` redistributed to ``axes``→rules→mesh inside a scope (the
    reference's ``with_sharding_constraint``); ``x`` itself outside one,
    or when it is not a DTensor."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return x
    want = axes_placements(axes, x.shape)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def index_copy_(x: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``x.index_copy_(dim, index, src)`` for a one-element ``index``, in
    place, ``src`` cast to ``x``'s dtype.  A DTensor ``x`` keeps its
    placements (DTensor's own ``index_copy_`` replicates a split ``dim``
    in its metadata but not in its data): ``src`` is laid out like ``x``
    with ``dim`` whole — a partial sum reduced before the cast, not
    after — and each rank writes the slot where it lies in its shard of
    ``dim``, with no host synchronisation."""
    if not is_dtensor(x):
        return x.index_copy_(dim, index, src.to(x.dtype))
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = x.device_mesh, list(x.placements)
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src_pl = [Replicate() if p.is_shard(dim) else p for p in pl]
    src = src.redistribute(mesh, src_pl).to_local()
    if is_dtensor(index):
        index = index.to_local()
    local = x.to_local()
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    if shape[dim] == 0:
        return x
    i = index - offset[dim]
    inside = (i >= 0) & (i < shape[dim])
    i = i.clamp(0, shape[dim] - 1)
    keep = local.index_select(dim, i)
    local.index_copy_(dim, i, torch.where(inside, src.to(local.dtype), keep))
    return x


def zeros(shape: Sequence[int], dtype: torch.dtype, device,
          axes: Sequence[Optional[str]]) -> torch.Tensor:
    """A zero buffer (a cache, a state) that model code fills in place:
    inside a scope, a DTensor laid out on ``axes`` (each rank allocates
    its own shard only); outside one, a plain tensor on ``device``."""
    ctx = current()
    if ctx is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dzeros
    mesh = ctx[0]
    return dzeros(*shape, dtype=dtype, device_mesh=mesh,
                  placements=axes_placements(axes, shape))


class _ScaleGrad(torch.autograd.Function):
    """Identity whose gradient is scaled by ``k``."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


class _DenseGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn: Callable, args: Sequence, arg_axes: Sequence,
               out_axes: Sequence):
    """``fn(*args)`` on each rank's local shards (the reference's
    ``shard_map``).

    Outside a scope, or when no argument is a DTensor, ``fn(*args)``.
    Inside one, each tensor argument is first laid out on its logical
    axes in ``arg_axes`` (None for an argument passed as it is: a flag,
    or an absent tensor), a plain tensor counting as replicated; ``fn``
    runs on the local tensors
    (``torch.distributed.tensor.experimental.local_map``), and each
    output becomes a DTensor on the placements of its ``(axes, shape)``
    pair in ``out_axes``.

    Gradients follow ``shard_map``'s transpose: an output's cotangent is
    divided by the size of the mesh dimensions it is replicated over
    (every rank there holds a copy of it), and an argument's gradient is
    a partial sum over the mesh dimensions it is replicated over.  The
    kernels' operators have no sharding strategy: this runs them where
    every shard is a whole problem (batch and heads split, nothing
    reduced)."""
    ctx = current()
    if ctx is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx[0]
    in_pl, grad_pl, dargs = [], [], []
    for a, ax in zip(args, arg_axes):
        if ax is None or a is None:
            in_pl.append(None)
            grad_pl.append(None)
            dargs.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = axes_placements(ax, a.shape)
        in_pl.append(pl)
        grad_pl.append([p if p.is_shard() else Partial() for p in pl])
        dargs.append(a)
    out_pl = tuple(axes_placements(ax, shape) for ax, shape in out_axes)
    copies = [math.prod(n for n, p in zip(mesh.shape, pl) if not p.is_shard())
              for pl in out_pl]

    def body(*local_args):
        # A shard's gradient leaves the call as a DTensor whose strides
        # DTensor takes to be contiguous; a plain version's gradient can
        # be laid out otherwise (an einsum's), and a view of it would
        # then fail on the shard alone.
        local_args = [_DenseGrad.apply(a) if isinstance(a, torch.Tensor)
                      and a.requires_grad else a for a in local_args]
        out = fn(*local_args)
        outs = out if isinstance(out, tuple) else (out,)
        outs = tuple(_ScaleGrad.apply(o, 1.0 / c)
                     if c > 1 and o.requires_grad else o
                     for o, c in zip(outs, copies))
        return outs if isinstance(out, tuple) else outs[0]
    return local_map(body, out_placements=out_pl,
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*dargs)
