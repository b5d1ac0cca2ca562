"""Device meshes of the port: functions, not module constants, so that
importing this module touches no device and no process group.

Port of ``repro/launch/mesh.py`` on ``torch.distributed``'s
``DeviceMesh``: ``init_device_mesh`` over the ranks of the process group
that ``launch.distributed_init`` (or the caller) set up.  The device type
is the card unless the caller names another (``"cpu"`` for gloo ranks
and for the dry-run's fake backend).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def data_axes(multi_pod: bool):
    """Axes that carry batch parallelism (pod stays pure-DP so the only
    cross-pod traffic is the per-step gradient reduce)."""
    return ("pod", "data") if multi_pod else ("data",)


def make_host_mesh(num_devices: int | None = None,
                   device_type: str = "cuda"):
    """A small mesh for tests and one-host runs: ``(n, 1)`` over
    ``("data", "model")``, ``n`` the group's world size by default."""
    n = num_devices or dist.get_world_size()
    return init_device_mesh(device_type, (n, 1),
                            mesh_dim_names=("data", "model"))
