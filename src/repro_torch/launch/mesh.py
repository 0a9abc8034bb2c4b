"""Meshes for the model and index planes (port of ``repro.launch.mesh``).

One process a mesh device, in a ``torch.distributed`` process group the
caller has initialised (address, world size and rank are the caller's):
NCCL on the card, gloo on the CPU.

Model mesh. ``make_production_mesh`` describes the 16x16 (one pod, 256
devices) or 2x16x16 (two pods, 512) topology, with a ``DeviceMesh`` of
the caller's device type whenever the default process group has that
many ranks, a fake group's included (``launch.dryrun`` opens one of 256
or 512 ranks). With fewer devices (the ranks of the default process
group, or 1 without one) it degrades to a 1xN ``("data", "model")`` mesh
and warns with ``MeshFallbackWarning``, as the reference does.
``make_host_mesh`` is the 1x1 mesh of one device and needs no process
group; ``model_mesh`` any shape over the group's first ranks. Both
return a ``ModelMesh``: axis names, sizes and the device (the
reference's ``mesh.axis_names`` and ``mesh.shape``, all that the
sharding policy reads), with a ``DeviceMesh`` where a process group
exists.

Index mesh.  ``make_index_mesh`` returns a ``DeviceMesh`` whose one
dimension is named ``"index"``; the named dimension is what the
reference's ``PartitionSpec("index")`` shards over.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.skiplist import resolve_device

INDEX_AXIS = "index"
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


class MeshFallbackWarning(UserWarning):
    """Requested topology does not fit the available devices; degraded."""


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A model mesh: named axes of given sizes over devices of one type.
    ``device_mesh`` is the ``DeviceMesh`` of the ranks, where a process
    group exists (``None`` on one device without a group)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device = torch.device("meta")
    device_mesh: Optional[DeviceMesh] = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))


def model_mesh(shape, axes, device=None) -> ModelMesh:
    """A model mesh of named ``axes`` of the given sizes over ranks
    ``0 .. prod(shape) - 1`` of the default process group (a
    ``DeviceMesh`` of the device's type; none without a group), e.g. the
    2x4 ``("data", "model")`` mesh of eight gloo ranks.  ``device=None``
    means the GPU and raises without one."""
    return _model_mesh(shape, axes, resolve_device(device))


def _model_mesh(shape, axes, dev: torch.device) -> ModelMesh:
    dm = None
    if dist.is_initialized():
        dm = DeviceMesh(dev.type, torch.arange(math.prod(shape)).reshape(
            shape), mesh_dim_names=tuple(axes))
    return ModelMesh(tuple(axes), tuple(int(s) for s in shape), dev, dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ModelMesh:
    """Production mesh, degrading to 1xN when devices are scarce.

    Returns the 16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)
    mesh when the default process group has that many ranks.  Otherwise
    it falls back to a 1xN ``("data", "model")`` mesh over the group's N
    ranks (1 without a group) and warns with :class:`MeshFallbackWarning`;
    callers that must not run degraded should turn the warning into an
    error.  ``device=None`` means the GPU and raises without one.
    """
    dev = resolve_device(device)
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    n = dist.get_world_size() if dist.is_initialized() else 1
    need = math.prod(shape)
    if n >= need:
        return _model_mesh(shape, axes, dev)
    warnings.warn(
        f"mesh fallback: production topology {shape} needs {need} devices "
        f"but only {n} are available; degrading to a "
        f"1x{n} ('data', 'model') mesh",
        MeshFallbackWarning, stacklevel=2)
    return _model_mesh((1, n), PRODUCTION_AXES, dev)


def make_host_mesh(device=None) -> ModelMesh:
    """1x1 mesh over one device (the GPU for ``None``), for smoke tests
    and examples; needs no process group."""
    return ModelMesh(PRODUCTION_AXES, (1, 1), resolve_device(device))


def dp_axes(mesh) -> tuple:
    """Data-parallel mesh axes present in this mesh ('pod' + 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.shape[a]
    return out


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
