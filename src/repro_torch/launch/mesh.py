"""Device meshes (the reference's ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh spans the ranks of the process group that the
caller has initialised (``torch.distributed.init_process_group`` with
its own address, world size and rank: nothing here finds a cluster).
The reference's fixed production topologies are not carried over: the
device count is the group's.
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
