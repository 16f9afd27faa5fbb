"""Device meshes of the multi-device training.

Counterpart of `langsplat_tpu/parallel/mesh.py:18 make_mesh`: a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process group (one
process per rank, `launch.py`), with the JAX package's axis names ('data', 'gauss',
'depth', 'tiles'). A 1-D mesh holds every rank on its one axis; a 2-D mesh puts as many
ranks as possible on the trailing axis, the first axis taking the largest divisor of n
that is at most sqrt(n), as the JAX package factors its device array. Rank r sits at
(r // n1, r % n1). An axis is the process group `mesh.get_group(name)`; without a process
group (one process) there is no mesh and every axis is a group of one.
"""

from __future__ import annotations

import math

import torch.distributed as dist


def mesh_shape(n: int, num_axes: int) -> tuple[int, ...]:
    """(n,) for one axis; for two, (d0, n // d0) with d0 the largest divisor of n that is
    at most sqrt(n)."""
    if num_axes == 1:
        return (n,)
    if num_axes != 2:
        raise ValueError(f"meshes of 1 or 2 axes, not {num_axes}")
    d0 = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return (d0, n // d0)


def make_mesh(num_devices: int | None = None, axis_names: tuple = ("data",),
              device_type: str = "cpu"):
    """The DeviceMesh over the first `num_devices` ranks (all of them by default) of the
    initialised process group, or None when there is no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        if num_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {num_devices} ranks needs a process group "
                               f"(parallel/launch.py)")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    n = num_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, mesh_shape(n, len(axis_names)),
                            mesh_dim_names=tuple(axis_names))


def axis_group(mesh, name: str):
    """The process group of axis `name` (None: one process)."""
    return None if mesh is None else mesh.get_group(name)


def axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along axis `name`."""
    return 0 if mesh is None else mesh.get_local_rank(name)
