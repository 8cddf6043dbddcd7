"""Stream checkpoints: versioned simulation-stream snapshots.

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per named array of the
snapshot, the opaque residue bytes as ``residue.pkl`` and
``manifest.json`` (step, ``kind="stream"``, schema version, member
count, per-array shape and dtype, caller meta).  Writes are atomic (tmp
dir + rename).

A snapshot (``BatchSimEngine.snapshot()``: named numpy arrays + one
opaque residue blob) is written by :func:`save_stream` and read back with
:func:`restore_stream`.  ``STREAM_SCHEMA_VERSION`` gates forward
compatibility: a restore refuses manifests newer than it understands.
The on-disk schema is the reference package's, so either package reads
the other's snapshot directories.

Only the stream half is here; the params half (pytree sections for
model params and optimizer state) comes with the training port.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

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
                         "snapshot")
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
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
