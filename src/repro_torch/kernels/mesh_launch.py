"""K10: the clustered kernels on every device of the mesh index (port of
``repro.kernels.mesh_launch``).

``core.mesh_index.search_mesh`` runs the eager traversal on each device;
``search_kernel_mesh`` is its kernel twin.  The route, sort and
``all_to_all_single`` exchange are the same, but step 4 runs
``kernels.ops.search_kernel_sharded(cluster=True)`` on the lanes a device
received, so K5 / K6 (with the K9 postlude on a fat index) launch on that
device's CUDA tensors.  K10 has no kernel body of its own: its body is
K5 / K6.

``k_shards=0`` resolves to ``min(QBLK, S_local)``, which every block's
shard count fits, so the launch is one clustered K5 / K6 with no K7
split, as in the reference, and equals the single-device kernel on the
same keys.  Node ids come back device-global, ``device * (S_local * cap *
node_width) + local`` (element-flat under the fat layout), ``-1`` for an
unserved lane.  The reference composes that id in int32, so a mesh whose
``D * S_local * cap * node_width`` passes ``2**31 - 1`` has no reference
answer and is refused with ``ValueError``.

``search_kernel_mesh.launches`` counts the K5 / K6 launches it makes (they
also count in those wrappers' own ``launches``).
"""
from __future__ import annotations

import torch

from repro_torch.core import mesh_index as mi
from repro_torch.core.mesh_index import MeshShardedIndex
from repro_torch.core.sharded import route
from repro_torch.kernels import foresight_traverse as ft
from repro_torch.kernels.foresight_traverse import QBLK
from repro_torch.kernels.ops import (MAX_RECORDS, KernelSearchResult,
                                     search_kernel_sharded,
                                     shard_vmem_footprint)

_CLUSTERED = (ft.foresight_traverse_clustered, ft.base_traverse_clustered)


def check_mesh_index_range(mx: MeshShardedIndex) -> None:
    """Raise where the reference's int32 device-global node id would wrap."""
    span = mx.n_devices * mx.local_shards * mx.shard_capacity * mx.node_width
    if span > MAX_RECORDS:
        raise ValueError(
            f"D * S * capacity * node_width = {span} exceeds 2**31 - 1: the "
            "reference's int32 device-global node id device * (S * capacity "
            "* node_width) + node would wrap")


def _clustered_launches() -> int:
    return sum(w.launches for w in _CLUSTERED)


def search_kernel_mesh(mx: MeshShardedIndex, queries, *, mesh,
                       max_steps: int = 0, k_shards: int = 0
                       ) -> KernelSearchResult:
    """Kernel-backed mesh search of this rank's chunk ``queries [C]``:
    route, exchange, one clustered launch, exchange back.

    Equal to ``search_kernel_sharded`` on the equivalent single-device
    index in ``found`` and ``vals`` (and to ``search_mesh``), with node
    ids composed device-globally.
    """
    D, me, group = mi._validate(mx, mesh)
    check_mesh_index_range(mx)
    if k_shards == 0:
        k_shards = min(QBLK, mx.local_shards)
    q = mi._lanes(mx, queries)
    did = route(mx.device_boundaries, q)
    (rq,), _, perm, starts, did_s = mi._exchange_out(did, (q,), (0,), D,
                                                     group)
    before = _clustered_launches()
    res = search_kernel_sharded(mx.local, rq, max_steps=max_steps,
                                cluster=True, k_shards=k_shards)
    search_kernel_mesh.launches += _clustered_launches() - before
    stride = mx.local_shards * mx.shard_capacity * mx.node_width
    gnode = torch.where(res.node >= 0, me * stride + res.node, -1)
    found, vals, node = mi._exchange_back((res.found, res.vals, gnode), perm,
                                          starts, did_s, D, group)
    return KernelSearchResult(found != 0, vals, node)


search_kernel_mesh.launches = 0


def dma_model_bytes_mesh(mx: MeshShardedIndex, n_queries: int) -> int:
    """The reference's TPU cost model: worst-case per-device HBM->VMEM tile
    bytes of one mesh search (every local tile for every block of the
    padded batch).  Host arithmetic, not a card measurement.  Copied as
    it is: like the reference it leaves a fat shard's run tile out."""
    D = mx.n_devices
    C = -(-max(n_queries, 1) // D)
    Bp = D * C + (-(D * C)) % QBLK
    tile = shard_vmem_footprint(mx.levels, mx.shard_capacity, mx.foresight)
    return (Bp // QBLK) * mx.local_shards * tile


__all__ = ["search_kernel_mesh", "dma_model_bytes_mesh",
           "check_mesh_index_range"]
