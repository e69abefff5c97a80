"""Device meshes of the port, as ``repro.launch.mesh``, on
``torch.distributed``'s DeviceMesh.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; 'pod' is the outer data-parallel ring (gradient
and label reductions only), 'model' stays inside a pod.

Functions, not module constants: importing this module touches no device
and no process group.  A mesh needs a process group of its size: the
dry-run starts a fake one of 256 or 512 ranks in one process
(``launch/dryrun.py``), a multi-rank run its own (gloo or nccl), and
``make_host_mesh`` starts a one-rank group itself where there is none.

The sharding vocabulary (``P``, ``placements``, ``constrain``,
``use_mesh``, ``sharded_ops``, ...) lives in ``repro_torch.sharding``,
below the models; it is re-exported here.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.sharding import (  # noqa: F401  (re-exported)
    P, axis_names, axis_size, constrain, current_mesh, distribute, lead,
    mesh_size, placements, remat_context, sharded_ops, unshard_dim,
    use_mesh)


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks (have {have}); the dry-run starts a fake one")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over the ranks that exist: with no process
    group, a one-rank group over a HashStore is started here (gloo on the
    CPU, nccl on a card), so one card makes a 1x1 mesh."""
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo" if device_type == "cpu" else "nccl",
            store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    return _mesh(device_type, (n // model, model), ("data", "model"))


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh ('pod' composes with 'data')."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
