"""The 1-D ``("index",)`` device mesh of the mesh-distributed index (port
of the index half of ``repro.launch.mesh``).

One process a mesh device, in a ``torch.distributed`` process group the
caller has initialised (address, world size and rank are the caller's):
NCCL on the card, gloo on the CPU.  ``make_index_mesh`` returns a
``DeviceMesh`` whose one dimension is named ``"index"``; the named
dimension is what the reference's ``PartitionSpec("index")`` shards over.
The model-mesh half of the reference module is not ported.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

INDEX_AXIS = "index"
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_index_mesh(n_devices: int = 0, device=None) -> DeviceMesh:
    """1-D ``("index",)`` mesh over ranks ``0 .. n_devices - 1`` of the
    default process group (``0``: all of them).

    ``device=None`` means ``"cuda"``: every rank takes card ``rank`` and
    the group must be NCCL; without a card it raises.  ``device="cpu"``
    needs a gloo group.  Asking for more devices than the group has ranks
    raises ``ValueError``: the index bakes one key slice per device into
    its boundaries, so a silent shrink would change the data layout.
    Called by every rank of the group, as ``DeviceMesh`` requires.
    """
    dev = "cuda" if device is None else torch.device(device).type
    if dev not in _BACKEND:
        raise ValueError(f"make_index_mesh: no index mesh on {dev!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_index_mesh: initialise torch.distributed "
                           "(init_process_group) first")
    backend = str(dist.get_backend())
    if _BACKEND[dev] not in backend:
        raise ValueError(f"make_index_mesh: a {dev} mesh needs a "
                         f"{_BACKEND[dev]} process group, not {backend!r}")
    world = dist.get_world_size()
    if n_devices == 0:
        n_devices = world
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices > world:
        raise ValueError(
            f"make_index_mesh: requested {n_devices} devices but the process "
            f"group's world size is {world}; start one process a device")
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_index_mesh: no CUDA device; pass "
                               "device='cpu' for a gloo mesh")
        torch.cuda.set_device(dist.get_rank())
    return DeviceMesh(dev, torch.arange(n_devices),
                      mesh_dim_names=(INDEX_AXIS,))


def index_axis_size(mesh: DeviceMesh) -> int:
    """Devices on the mesh's ``"index"`` dimension; ``ValueError`` if it
    has none."""
    names = tuple(mesh.mesh_dim_names or ())
    if INDEX_AXIS not in names:
        raise ValueError(f"mesh dimensions {names} lack the '{INDEX_AXIS}' "
                         "dimension (see launch.mesh.make_index_mesh)")
    return int(mesh.shape[names.index(INDEX_AXIS)])


def validate_index_partition(mesh: DeviceMesh, total_shards: int) -> int:
    """Shards a device when ``total_shards`` divides across the index
    dimension; ``ValueError`` otherwise or without that dimension."""
    n_dev = index_axis_size(mesh)
    if total_shards % n_dev != 0:
        raise ValueError(
            f"total_shards={total_shards} does not divide across "
            f"{n_dev} devices on the '{INDEX_AXIS}' dimension; use a shard "
            f"count that is a multiple of the mesh size")
    return total_shards // n_dev
