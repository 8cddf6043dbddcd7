"""Device meshes (the reference's ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh spans the ranks of the process group that the
caller has initialised (``torch.distributed.init_process_group`` with
its own address, world size and rank: nothing here finds a cluster).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` with dimension names ``axes`` over the ranks of
    the initialised process group (their count must be the product of
    ``shape``)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         "differ in length")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The dry run's two meshes (``launch/dryrun.py``): ``(16, 16)`` over
    ``("data", "model")``, or with ``multi_pod`` ``(2, 16, 16)`` over
    ``("pod", "data", "model")``, where ``'pod'`` extends data
    parallelism.  The group must have 256 or 512 ranks.  The dry run
    makes them ranks of a fake process group (``backend="fake"``), one
    process standing in for 256 or 512 H100s — 32 or 64 nodes of eight
    GPUs — none of which is touched."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, data: Optional[int] = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over every rank of the group: ``model``
    ranks of tensor parallelism (at most the world size), the rest data
    parallel."""
    n = dist.get_world_size()
    model = min(model, n)
    data = data or (n // model)
    return make_mesh((data, model), ("data", "model"), device_type)


def mesh_desc(mesh: DeviceMesh) -> dict:
    return {"axes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "n_devices": int(mesh.size())}
