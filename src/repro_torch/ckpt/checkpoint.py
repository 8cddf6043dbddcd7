"""Checkpointing: atomic step directories for parameter trees and
versioned simulation-stream snapshots.

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per array leaf plus
``manifest.json``.  Writes are atomic (tmp dir + rename).  The on-disk
schema is the reference package's, so either package reads the other's
checkpoints.  Two kinds share the scheme:

* ``kind="params"`` — tree sections (model params / optimizer state),
  written by :func:`save_sections` (or the :func:`save` convenience
  wrapper) and read back section by section with
  :func:`restore_section` / :func:`restore`.  A leaf's key is its
  ``"/"``-joined dict path, in the reference's flattening order (sorted
  keys); the manifest records each leaf's file, shape and dtype.  Leaves
  are restored as tensors on the device asked for (``None`` means
  ``"cuda"``), or split onto a device mesh (which may differ from the
  one that wrote them: an elastic restart).  A DTensor leaf is written
  whole: every rank of its mesh gathers it, rank 0 writes.  A bfloat16 leaf is written as the reference writes one
  (``np.save`` of an ``ml_dtypes`` bfloat16 array: a ``'<V2'`` array of
  the raw 16-bit words, manifest dtype ``"bfloat16"``) and read back
  bit for bit, without ``ml_dtypes``;
* ``kind="stream"`` — a snapshot (``BatchSimEngine.snapshot()``: named
  numpy arrays + one opaque residue blob; manifest: step, schema
  version, member count, per-array shape and dtype, caller meta)
  written by :func:`save_stream` and read back with
  :func:`restore_stream`.  ``STREAM_SCHEMA_VERSION`` gates forward
  compatibility: a restore refuses manifests newer than it understands.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import tree_unflatten

PyTree = Any

# Manifest schema version for ``kind="stream"`` checkpoints.  Bump when
# the array block / residue contract changes; ``restore_stream`` refuses
# manifests newer than this.  v2: chaos residue (attempt/preemption
# counters + injection tallies) — v1 snapshots still restore (benign
# defaults fill the missing keys).  The live SLO monitor needs no
# version of its own: it rides the residue's opaque event-log pickle as
# ``elog.sub`` (repro_torch.obs.monitor), so pre-monitor snapshots restore
# with monitoring simply absent.
STREAM_SCHEMA_VERSION = 2


def _atomic_step_dir(ckpt_dir: str, step: int):
    """(tmp, final) pair for an atomic ``step_<N>`` write: stage into
    ``tmp``, then ``os.rename`` to ``final`` (same filesystem)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=ckpt_dir)
    return tmp, final


def _commit(tmp: str, final: str) -> None:
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _flatten(tree: PyTree) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flattening order: dict keys
    sorted at every level, a key the ``"/"``-joined path."""
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        else:
            out.append(("/".join(path), t))
    walk(tree, ())
    return out


def _rank() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _leaf_to_file(path: str, leaf) -> Tuple[Tuple[int, ...], str]:
    """Write one leaf as ``.npy`` the way the reference writes it; returns
    its shape and manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": raw.shape})
                f.write(raw.tobytes())
            return raw.shape, "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return arr.shape, str(arr.dtype)


def _leaf_from_file(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_sections(ckpt_dir: str, step: int,
                  sections: Mapping[str, Optional[PyTree]],
                  extra: Optional[Dict] = None) -> str:
    """Atomic tree checkpoint: one named section per tree (``None``
    sections are skipped).  Returns the final directory.  Under an
    initialised process group every rank calls this (DTensor leaves are
    gathered whole), rank 0 writes, and all ranks return once the
    directory is committed."""
    from ..parallel.sharding import whole
    if _rank() != 0:
        for tree in sections.values():
            if tree is not None:
                for _, leaf in _flatten(tree):
                    whole(leaf)
        _barrier()
        return os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp, final = _atomic_step_dir(ckpt_dir, step)
    manifest: Dict[str, Any] = {"step": step, "kind": "params",
                                "extra": extra or {}}
    try:
        for name, tree in sections.items():
            manifest[name] = {}
            if tree is None:
                continue
            for key, leaf in _flatten(tree):
                fn = f"{name}__{key.replace('/', '__')}.npy"
                shape, dtype = _leaf_to_file(os.path.join(tmp, fn),
                                             whole(leaf))
                manifest[name][key] = {"file": fn, "shape": list(shape),
                                       "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        _commit(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        _barrier()
    return final


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def save(ckpt_dir: str, step: int, params: PyTree,
         opt: Optional[PyTree] = None, extra: Optional[Dict] = None) -> str:
    """Convenience wrapper: the classic params(+opt) checkpoint."""
    return save_sections(ckpt_dir, step, {"params": params, "opt": opt},
                         extra=extra)


def restore_section(ckpt_dir: str, step: Optional[int], template: PyTree,
                    device: Union[None, str, torch.device] = None,
                    section: str = "params", *, mesh=None,
                    placements: Optional[PyTree] = None
                    ) -> Tuple[PyTree, int]:
    """Restore ``section`` onto ``template``'s tree structure (the latest
    step when ``step`` is None).  Each leaf is loaded whole and becomes
    a tensor on ``device`` (``None`` means ``"cuda"``, raising without
    CUDA) or, with ``mesh`` and ``placements`` (a tree of DTensor
    placement lists shaped like ``template``; the reference's
    ``shardings``), a DTensor split onto ``mesh`` — which may differ from
    the mesh that wrote it.  A leaf whose shape differs from the
    template's raises ``ValueError``."""
    if (mesh is None) != (placements is None):
        raise ValueError("pass mesh and placements together")
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for key, leaf in _flatten(template):
        meta = manifest[section][key]
        t = _leaf_from_file(os.path.join(d, meta["file"]), meta["dtype"])
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else tuple(np.shape(leaf))
        if want != tuple(t.shape):
            raise ValueError(
                f"checkpoint {section}/{key} has shape {tuple(t.shape)}, "
                f"template expects {want} — a re-shard may change the "
                "mesh, never the array shapes")
        out.append(t.to(dev))
    tree = tree_unflatten(template, out)
    if mesh is not None:
        from ..parallel.sharding import distribute
        tree = distribute(tree, mesh, placements)
    return tree, step


# Back-compat alias (the pre-generalization public name).
restore = restore_section


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def save_stream(ckpt_dir: str, step: int, snap: Mapping[str, Any],
                meta: Optional[Dict] = None) -> str:
    """Atomic write of a simulation-stream snapshot.

    ``snap`` is the ``{"arrays", "residue", "version", ...}`` dict the
    engines produce (``SimState.snapshot`` / ``BatchSimEngine.snapshot``):
    each named numpy array lands as its own ``.npy``; the opaque
    ``residue`` bytes land as ``residue.pkl``; ``meta`` (scenario name,
    partial rows, …) round-trips through the manifest as JSON.
    """
    tmp, final = _atomic_step_dir(ckpt_dir, step)
    manifest: Dict[str, Any] = {
        "step": step,
        "kind": "stream",
        "stream_version": int(snap.get("version", STREAM_SCHEMA_VERSION)),
        "n_members": snap.get("n_members"),
        "arrays": {},
        "meta": meta or {},
    }
    try:
        for name, arr in snap["arrays"].items():
            arr = np.asarray(arr)
            fn = "arr__" + name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["arrays"][name] = {"file": fn,
                                        "shape": list(arr.shape),
                                        "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "residue.pkl"), "wb") as f:
            f.write(snap["residue"])
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        _commit(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def restore_stream(ckpt_dir: str, step: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], int, Dict]:
    """Load a stream snapshot → ``(snap, step, meta)``.

    ``snap`` has the exact shape the engines' ``load_snapshot`` expects.
    Refuses manifests written by a newer schema, and refuses
    ``kind="params"`` directories loudly rather than mis-parsing them.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    kind = manifest.get("kind", "params")
    if kind != "stream":
        raise ValueError(f"{d} is a {kind!r} checkpoint, not a stream "
                         "snapshot (use restore_section)")
    version = int(manifest.get("stream_version", 1))
    if version > STREAM_SCHEMA_VERSION:
        raise ValueError(
            f"stream snapshot schema v{version} is newer than supported "
            f"v{STREAM_SCHEMA_VERSION} — upgrade before resuming")
    arrays = {name: np.load(os.path.join(d, meta["file"]))
              for name, meta in manifest["arrays"].items()}
    with open(os.path.join(d, "residue.pkl"), "rb") as f:
        residue = f.read()
    snap: Dict[str, Any] = {"arrays": arrays, "residue": residue,
                            "version": version}
    if manifest.get("n_members") is not None:
        snap["n_members"] = manifest["n_members"]
    return snap, step, manifest.get("meta", {})


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` steps (rank 0's job under a
    process group)."""
    if _rank() != 0:
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
