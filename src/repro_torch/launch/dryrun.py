"""Dry run (the reference's ``repro/launch/dryrun.py``): trace every
(arch × shape) cell on the production meshes with placeholder tensors
(no allocation), and record per-device costs, collectives and memory for
the roofline (``launch/roofline.py``) and the ML-job platform
(``waas/mljobs.py``).

The meshes are ``launch.mesh.make_production_mesh``'s, over the ranks of
a fake process group (``backend="fake"``): one process is rank 0 of 256
or 512 placeholder H100s, whose collectives return at once.  Every tensor
is a fake (``FakeTensorMode``): shapes, dtypes and devices, no storage.
The model's device is ``cuda`` by default (a card must be present), so
the trace takes the card's path — the kernels' operators, through their
fakes; ``--device cpu`` traces the plain versions instead (the plain
attention's L² products are counted then, not the kernels' work), and
the artifact's ``device`` says which.

MUST be run as its own process (``python -m repro_torch.launch.dryrun``):
a process group is process-wide, so the fake group cannot share a
process with a real one.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  python -m repro_torch.launch.dryrun --all --smoke --device cpu

How it counts (:class:`Count`, :func:`_costs_of`).  The port runs op by
op, without a layer scan, so it counts at full depth directly: there is
no probe at two depths and no ``probe_layers`` key.  The count sits
beneath DTensor: an operator on DTensors is handed back to DTensor, which
issues the rank's own local operators (and its redistributions'
collectives), and only those are counted — rank 0's share, the
per-device program as the reference's compiled SPMD module is.  Work
that every rank repeats (replicated operators) is counted on every
device, as the reference counts it.  DTensor's sharding propagation runs
each new operator once more on global-shape fakes to learn the output's
shape; that is not the rank's work and is not counted.

* ``flops``: ``torch.utils.flop_counter``'s formulas (products,
  attention, convolutions, and the kernels' operators' own formulas,
  registered in ``kernels/*/ops.py``), on the local operators.
* ``bytes``: each local operator's tensor inputs read once and its
  outputs written once; views, aliases and allocations without a write
  (``empty``) are free.  XLA's ``bytes accessed`` counts a fused
  program, whose intermediates stay on chip; torch runs each operator on
  its own, so this count is higher by every intermediate's write and
  read.
* ``collectives``: the functional collectives the rank issues
  (``_c10d_functional``: DTensor's redistributions and MoE's all-to-alls
  in ``local_call``), under the reference's five names, bytes = result
  bytes per device as ``parse_collectives`` defines them.  Torch has no
  collective-permute, so that entry stays 0.  Redistributions that a
  device type implements otherwise differ between ``cuda`` and ``cpu``
  traces (the CPU group has no all-to-all; DTensor gathers instead).
* ``memory``, from the storages of the local fakes: ``argument_bytes``
  is parameters, optimizer state, batch and decode state on rank 0;
  ``output_bytes`` the outputs (params and moments updated in place
  count, as XLA's aliased outputs do); ``temp_bytes`` the peak of the
  bytes allocated during the step and still live, less the new outputs
  alive at its end, under the cell's remat policy; so arguments + temp
  (+ outputs, for a prefill's new cache) is the step's predicted peak.
  ``generated_code_bytes`` is 0.  An operator's internal scratch (the
  SSD backward's chunk states) is not seen.  DTensor's ``Shard`` gives
  rank 0 the largest piece of an uneven split, as XLA's padding does.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs.registry import ARCH_IDS, cells, get_config
from ..configs.shapes import SHAPES, skip_reason
from ..models.common import RunConfig, tree_leaves, tree_unflatten
from ..models.registry import Model, build
from ..parallel import sharding as shd
from ..serve import serve_step
from ..train import train_step
from .mesh import make_mesh, make_production_mesh, mesh_desc

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# The smoke configs' meshes (by multi_pod): their 4 heads cannot split 16
# ways, so they trace on (2, 2) and (2, 2, 2) placeholder meshes.
SMOKE_MESHES = {False: ((2, 2), ("data", "model")),
                True: ((2, 2, 2), ("pod", "data", "model"))}

# The ``_c10d_functional`` operators DTensor and ``local_call`` issue →
# the reference's names.
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}

# Operators that allocate without writing, or read only metadata.
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "device"))


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensor leaves (a
    DTensor's local shard)."""
    seen: Dict[int, int] = {}
    for t in _tensors(tree):
        st = _storage(_local(t))
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class Count(TorchDispatchMode):
    """Flops, bytes, collectives and live storage bytes of the local
    operators run under it (module docstring).  ``keep`` holds the
    storages alive before the mode was entered (the arguments), which
    are neither allocations nor frees."""

    def __init__(self, keep=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {op: {"count": 0, "bytes": 0.0}
                            for op in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._keep = {_storage(_local(t))._cdata for t in _tensors(keep)}
        self._outside = 0   # > 0 inside DTensor's own bookkeeping

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def allocated(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was allocated under the mode and is
        live."""
        return _storage(t)._cdata in self._sizes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._outside:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor issues the local operators
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func.namespace != "prim":
            # a composite operator (one that reaches the mode whole under
            # inference mode) counts as what it decomposes into, as
            # ``FlopCounterMode`` counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_keys = {_storage(t)._cdata for t in ins}
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            c = self.collectives[_COLLECTIVES[name]]
            c["count"] += 1
            c["bytes"] += float(sum(_nbytes(t) for t in outs))
        view = (not func._schema.is_mutable
                and all(_storage(t)._cdata in in_keys for t in outs))
        if name not in _NO_TRAFFIC and not view:
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        for t in outs:
            st = _storage(t)
            key = st._cdata
            if key in self._sizes or key in self._keep or key in in_keys:
                continue
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out

    def _aside(self, fn: Callable, real: bool) -> Callable:
        """``fn`` with the operators it runs left out of the count; with
        ``real``, run on real tensors (outside ``FakeTensorMode``) and
        memoised on its arguments: DTensor's shard-offset arithmetic is a
        pure function of shapes and placements, and slow (it lists every
        offset of a strided shard)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        sig = inspect.signature(fn)
        memo: Dict[Any, Any] = {}

        def frozen(x):
            return tuple(map(frozen, x)) if isinstance(x, (list, tuple)) else x

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            key = None
            if real:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                key = frozen(list(bound.arguments.values()))
                if key in memo:
                    return memo[key]
            self._outside += 1
            try:
                with (unset_fake_temporarily() if real
                      else contextlib.nullcontext()):
                    out = fn(*args, **kwargs)
            finally:
                self._outside -= 1
            if real:
                memo[key] = out
            return out
        return inner

    @contextlib.contextmanager
    def beneath_dtensor(self):
        """The mode entered, with DTensor's own bookkeeping left out of
        the count: its sharding propagation (which runs each new
        operator on global-shape fakes) and its shard-offset arithmetic,
        which builds small index tensors and reads them back (run on real
        tensors here: a fake cannot be read)."""
        from torch.distributed.tensor import _utils
        from torch.distributed.tensor.placement_types import _StridedShard
        prop = DTensor._op_dispatcher.sharding_propagator
        meta = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(prop, n)), None)
        if meta is None:
            raise RuntimeError("DTensor's sharding propagator has no tensor-"
                               "meta step to leave out of the count")
        patches = [(prop, meta, False)] + [
            (owner, name, True) for owner, name in (
                (_utils, "_compute_local_shape_and_global_offset"),
                (_StridedShard, "local_shard_size_and_offset"))
            if name in vars(owner)]
        saved = [(owner, name, vars(owner).get(name))
                 for owner, name, _ in patches]
        for owner, name, real in patches:
            setattr(owner, name, self._aside(getattr(owner, name), real))
        try:
            with self:
                yield self
        finally:
            for owner, name, was in saved:
                if was is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, was)


# ---------------------------------------------------------------------------
# The fake process group and the cells' inputs
# ---------------------------------------------------------------------------


def fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (re-made if it has another size).  Refuses a real group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()!r} group is initialised")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake(spec: Tuple, device, mesh, placement):
    """A fake leaf of global ``(shape, dtype)``: with a mesh, a DTensor
    from rank 0's local shard on ``placement``; else a plain fake."""
    shape, dtype = spec
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():   # it computes offsets on real tensors
        local_shape, _ = compute_local_shape_and_global_offset(
            shape, mesh, placement)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placement, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _fakes(specs, device, mesh, placements):
    """A tree of fakes shaped like ``specs`` (nested dicts of
    ``(shape, dtype)``), placed by the like-shaped ``placements``."""
    leaves = tree_leaves(specs)
    pls = (tree_leaves(placements) if mesh is not None
           else [None] * len(leaves))
    return tree_unflatten(specs, [_fake(s, device, mesh, p)
                                  for s, p in zip(leaves, pls)])


def _batch(specs: Dict[str, Tuple], global_batch: Optional[int]):
    if global_batch is None:
        return specs
    return {k: ((global_batch, *shape[1:]), dt)
            for k, (shape, dt) in specs.items()}


def _lower_model(model: Model, mesh, shape_name: str,
                 global_batch: Optional[int] = None
                 ) -> Tuple[Callable, Tuple]:
    """``(step, args)`` of the cell's entry point, the args fakes (call
    under ``FakeTensorMode``): the sharded ``build_train_step``,
    ``build_prefill`` or ``build_decode_step`` with parameters, moments,
    batch and decode state made from ``model.abstract()``,
    ``input_specs()`` and ``state_specs()`` as DTensors of rank 0's local
    shards on the builders' placements — or, with ``mesh=None``, the
    unsharded step on whole fakes.  ``global_batch`` replaces the train
    or prefill batch's leading size."""
    shape = SHAPES[shape_name]
    dev = model.device
    inputs = model.input_specs(shape_name)
    if shape.kind == "train":
        params = model.abstract()
        opt = {"mu": params, "nu": params, "step": ((), torch.int32)}
        batch = _batch(inputs, global_batch)
        if mesh is None:
            return train_step.make_train_step(model), (
                _fakes(params, dev, None, None), _fakes(opt, dev, None, None),
                _fakes(batch, dev, None, None))
        fn, param_pl, opt_pl, batch_pl = train_step.build_train_step(
            model, mesh, shape_name)
        batch_pl = {k: batch_pl.get(k, shd.replicated(mesh)) for k in batch}
        return fn, (_fakes(params, dev, mesh, param_pl),
                    _fakes(opt, dev, mesh, opt_pl),
                    _fakes(batch, dev, mesh, batch_pl))
    params = model.abstract(torch.bfloat16)
    if mesh is None:
        param_pl = batch_pl = state_pl = None
    else:
        _, param_pl, batch_pl, state_pl = serve_step._layout(
            model, shape_name, mesh)
    if shape.kind == "prefill":
        fn = serve_step.build_prefill(model, shape_name, dev, mesh=mesh)
        batch = _batch(inputs, global_batch)
        return fn, (_fakes(params, dev, mesh, param_pl),
                    _fakes(batch, dev, mesh, batch_pl))
    if global_batch is not None:
        raise ValueError("global_batch applies to train and prefill cells")
    fn = serve_step.build_decode_step(model, shape_name, dev, mesh=mesh)
    tokens = _fakes({"tokens": inputs["tokens"]}, dev, mesh, batch_pl)
    return fn, (_fakes(params, dev, mesh, param_pl),
                _fakes(model.state_specs(shape_name), dev, mesh, state_pl),
                tokens["tokens"])


def _costs_of(fn: Callable, args: Tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` under :class:`Count`: the cost and memory
    entries of the artifact, and the trace's wall time."""
    count = Count(keep=args)
    t0 = time.time()
    with count.beneath_dtensor():
        out = fn(*args)
    trace_s = time.time() - t0
    outs = [_local(t) for t in _tensors(out)]
    new = {_storage(t)._cdata: _storage(t).nbytes() for t in outs
           if count.allocated(t)}
    coll_bytes = sum(v["bytes"] for v in count.collectives.values())
    return {"flops": float(count.flops), "bytes": float(count.bytes),
            "coll_bytes": coll_bytes, "collectives": count.collectives,
            "trace_s": trace_s,
            "memory": {"argument_bytes": storage_bytes(args),
                       "output_bytes": storage_bytes(out),
                       "temp_bytes": count.peak - sum(new.values()),
                       "generated_code_bytes": 0}}


def trace(model: Model, mesh, shape_name: str,
          global_batch: Optional[int] = None) -> Dict[str, Any]:
    """:func:`_costs_of` the cell's entry point (:func:`_lower_model`),
    traced on fakes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = _lower_model(model, mesh, shape_name, global_batch)
        return _costs_of(fn, args)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               run: Optional[RunConfig] = None, probe: bool = True,
               device=None, smoke: bool = False) -> Dict[str, Any]:
    """Trace one cell on its production mesh (a fake group of 256 or 512
    ranks, made here); return the roofline artifact dict, with the
    reference's keys and ``device``.  ``probe`` is the reference's
    argument and changes nothing: the port counts at full depth.
    ``smoke`` traces the smoke config (``reduce_config``)."""
    del probe
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    run = run or RunConfig(remat="full")
    model = build(arch, run, smoke=smoke, device=device)
    if smoke:
        shape_, axes = SMOKE_MESHES[multi_pod]
        fake_group(math.prod(shape_))
        mesh = make_mesh(shape_, axes, model.device.type)
    else:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=model.device.type)
    c = trace(model, mesh, shape_name)
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh_desc(mesh),
        "mesh_tag": "multipod" if multi_pod else "singlepod",
        "n_params": model.n_params(),
        "n_active_params": model.n_active_params(),
        "lower_s": round(c["trace_s"], 2),
        "compile_s": 0.0,
        "raw_scan_costs": {k: c[k] for k in ("flops", "bytes", "coll_bytes")},
        "memory": c["memory"],
        "flops_per_device": c["flops"],
        "bytes_accessed_per_device": c["bytes"],
        "collective_bytes_per_device": c["coll_bytes"],
        "collectives": c["collectives"],
        "device": model.device.type,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default=None,
                    help="variant tag appended to artifact names")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence parallelism")
    ap.add_argument("--cast-once", action="store_true",
                    help="cast params to the compute dtype once per step")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--device", default=None,
                    help="the model's device: cuda (default; needs a card) "
                         "or cpu (the plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs (few layers, narrow)")
    args = ap.parse_args()

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        # --arch or --shape beside --all keeps that arch's or shape's cells
        chosen = [(a, s.name, r) for a, s, r in cells()
                  if args.arch in (None, a) and args.shape in (None, s.name)]
        todo = [(a, s) for a, s, r in chosen if r is None]
        skips = [(a, s, r) for a, s, r in chosen if r is not None]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo, skips = [(args.arch, args.shape)], []

    os.makedirs(args.out, exist_ok=True)
    run = RunConfig(remat=args.remat, seq_parallel=not args.no_sp,
                    cast_params_once=args.cast_once,
                    microbatch=args.microbatch,
                    moe_capacity=args.capacity_factor)
    failures = []
    for mp in meshes:
        tag = "multipod" if mp else "singlepod"
        if args.tag:
            tag = f"{tag}-{args.tag}"
        for arch, shape in todo:
            key = f"{tag}__{arch}__{shape}"
            path = os.path.join(args.out, key + ".json")
            if os.path.exists(path):
                print(f"[skip-cached] {key}")
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                art = lower_cell(arch, shape, mp, run, device=args.device,
                                 smoke=args.smoke)
                with open(path, "w") as f:
                    json.dump(art, f, indent=1)
                mem_gb = sum(art["memory"].values()) / 2**30
                print(f"  ok: trace={art['lower_s']}s "
                      f"flops/dev={art['flops_per_device']:.3e} "
                      f"mem/dev={mem_gb:.2f}GiB "
                      f"coll/dev={art['collective_bytes_per_device']:.3e}B",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures.append((key, repr(e)))
                print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
        for arch, shape, reason in skips:
            path = os.path.join(args.out, f"{tag}__{arch}__{shape}.json")
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh_tag": tag,
                           "skipped": reason}, f, indent=1)
    if failures:
        print("FAILURES:")
        for k, e in failures:
            print(" ", k, e)
        raise SystemExit(1)
    print("dry-run complete.")


if __name__ == "__main__":
    main()
