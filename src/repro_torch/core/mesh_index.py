"""Mesh-distributed key-space index over ``torch.distributed`` (port of
``repro.core.mesh_index``).

The key space is cut into ``D`` contiguous device slices, one a device of
a 1-D ``("index",)`` mesh (``launch.mesh.make_index_mesh``), each held as
an independent ``ShardedSkipList``; the replicated ``device_boundaries
[D]`` int32 (the ``partition_boundaries`` rule one level up) route lanes to
their slice.  The port is SPMD, one process a device: rank ``d`` holds only
its own slice and the boundaries (no ``[D]``-stacked state), and each
collective call is made by every rank with its own chunk of the batch.

A global batch of ``B`` lanes is padded to ``D * C`` (``C = ceil(B / D)``)
with the reference's fills (query 0; op ``OP_READ``, key 0, val 0), and
rank ``r`` passes lanes ``[r*C, (r+1)*C)`` (``chunk``) and gets their
results back.  Per rank (the reference's ``shard_map`` body):

1. route the chunk over ``device_boundaries``;
2. stable-sort lanes by destination and cut per-destination segments;
3. ``all_to_all_single`` the ``[D, P, C]`` buckets (``P`` payloads and
   a live flag, dead slots filled); the received batch is source-major
   ``[D * C]``, each source's lanes in its order;
4. run the single-device engine on the received lanes
   (``search_sharded`` / ``apply_ops_sharded``; the clustered kernels in
   ``kernels.mesh_launch``);
5. ``all_to_all_single`` the results back and inverse-permute.

The results equal the single-device engine's on the whole batch, and the
per-device states equal the reference's slice ``d``.  Rebalancing stays
device-local: each rank's apply runs the in-place passes
(``core.rebalance_traced``) inside its own shard axis, as the reference
does under ``shard_map``, and ``device_boundaries`` never move, so
cross-device skew is surfaced as ``DeviceLoadStats``, never absorbed.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import sharded as shd
from repro_torch.core.rebalance_traced import (DeviceLoadStats,
                                               cross_device_load)
from repro_torch.core.sharded import (HIGH_WATER, LOW_WATER, ShardedSkipList,
                                      partition_boundaries, route,
                                      shard_capacity_for, shard_segments)
from repro_torch.core.skiplist import (KEY_MAX, KEY_MIN, NULL_VAL, OP_READ,
                                       resolve_device)
from repro_torch.launch.mesh import INDEX_AXIS, index_axis_size


class MeshShardedIndex(NamedTuple):
    """One device's slice of the mesh index + the replicated routing array.

    Device ``d`` owns keys in ``[device_boundaries[d],
    device_boundaries[d + 1])``; slot 0 is ``KEY_MIN`` and a dead slice's
    boundary is ``KEY_MAX``.  ``rank`` is the index coordinate whose slice
    ``local`` holds.
    """

    local: ShardedSkipList           # this device's slice
    device_boundaries: torch.Tensor  # [D] int32, inclusive lower key bound
    rank: int

    @property
    def n_devices(self) -> int:
        return self.device_boundaries.shape[0]

    @property
    def local_shards(self) -> int:
        return self.local.n_shards

    @property
    def shard_capacity(self) -> int:
        return self.local.shard_capacity

    @property
    def levels(self) -> int:
        return self.local.levels

    @property
    def foresight(self) -> bool:
        return self.local.foresight

    @property
    def node_width(self) -> int:
        return self.local.node_width

    @property
    def device(self) -> torch.device:
        return self.device_boundaries.device


def route_devices(mx: MeshShardedIndex, queries) -> torch.Tensor:
    """Owning device per query [B] int32: the shard routing rule."""
    return route(mx.device_boundaries, queries)


def chunk(batch, n_devices: int, rank: int, fill: int = 0) -> torch.Tensor:
    """Rank ``rank``'s ``C = ceil(B / D)`` lanes of a global ``[B]`` batch
    padded to ``D * C`` lanes with ``fill`` (the reference's ``_chunk``)."""
    b = torch.as_tensor(batch).to(torch.int32)
    C = -(-max(b.shape[0], 1) // n_devices)
    pad = n_devices * C - b.shape[0]
    if pad:
        b = torch.cat([b, b.new_full((pad,), fill)])
    return b[rank * C:(rank + 1) * C]


def _rank(rank: Optional[int], n_devices: int) -> int:
    if rank is None:
        if not dist.is_initialized():
            raise ValueError("pass rank= or initialise torch.distributed")
        rank = dist.get_rank()
    if not 0 <= rank < n_devices:
        raise ValueError(f"rank {rank} outside the {n_devices} device(s)")
    return int(rank)


def build_mesh_index(keys, vals, *, n_devices: int, n_shards: int,
                     capacity: int = 0, levels: int = 16,
                     foresight: bool = True, seed: int = 0,
                     node_width: int = 1, rank: Optional[int] = None,
                     device=None) -> MeshShardedIndex:
    """This rank's slice of sorted unique int32 ``keys`` over ``n_devices``.

    Every rank passes the same global keys.  They are padded to ``D * m``
    (``m = ceil(n / D)``) with ``KEY_MAX`` / ``NULL_VAL`` / invalid; slice
    ``rank`` is built with ``build_sharded`` at ``n_shards`` shards, seed
    ``seed + rank * n_shards``, and a shared ``capacity`` (sized for ``m``
    when 0); the boundaries are ``partition_boundaries(keys, m)``.
    ``rank=None`` is the caller's rank in the default process group;
    ``device=None`` the GPU.
    """
    D = int(n_devices)
    if D < 1:
        raise ValueError(f"n_devices must be >= 1, got {D}")
    d = _rank(rank, D)
    dev = resolve_device(device)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    n = keys.shape[0]
    m = max(1, -(-n // D))
    if capacity == 0:
        capacity = shard_capacity_for(m, n_shards, node_width)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    pad = D * m - n
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), KEY_MAX)])
        vals = torch.cat([vals, vals.new_full((pad,), NULL_VAL)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    mine = slice(d * m, (d + 1) * m)
    local = shd.build_sharded(keys[mine], vals[mine], n_shards=n_shards,
                              capacity=capacity, levels=levels,
                              foresight=foresight, seed=seed + d * n_shards,
                              valid=valid[mine], node_width=node_width,
                              device=dev)
    return MeshShardedIndex(local, partition_boundaries(keys, m), d)


def empty_mesh_index(*, n_devices: int, n_shards: int, capacity: int,
                     levels: int = 16, foresight: bool = True, seed: int = 0,
                     key_span: int = KEY_MAX, node_width: int = 1,
                     rank: Optional[int] = None,
                     device=None) -> MeshShardedIndex:
    """An empty mesh index with ``[0, key_span)`` split evenly per device.

    This rank's slice is an empty ``build_sharded`` at ``n_shards`` (seed
    ``seed + rank * n_shards``), which is its ceiling under
    ``apply_ops_mesh(rebalance=True)``.
    """
    D = int(n_devices)
    d = _rank(rank, D)
    dev = resolve_device(device)
    z = torch.zeros((0,), dtype=torch.int32, device=dev)
    local = shd.build_sharded(z, z, n_shards=n_shards, capacity=capacity,
                              levels=levels, foresight=foresight,
                              seed=seed + d * n_shards,
                              node_width=node_width, device=dev)
    step = max(1, int(key_span) // D)
    db = (torch.arange(D, dtype=torch.int64, device=dev) * step
          ).to(torch.int32)
    db[0] = KEY_MIN
    return MeshShardedIndex(local, db, d)


# ---------------------------------------------------------------------------
# Lane exchange: bucket by destination, all_to_all, inverse-permute
# ---------------------------------------------------------------------------

def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """Row ``i`` of ``send [D, ...]`` goes to device ``i``; row ``s`` of the
    result came from device ``s``."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv


def _exchange_out(did: torch.Tensor, payloads: Sequence[torch.Tensor],
                  fills: Sequence[int], D: int, group):
    """Route-sort lanes, bucket them per destination, send them out.

    Returns ``(received, recv_live, perm, starts, did_sorted)``:
    ``received[i]`` is payload ``i`` as this device's ``[D * C]`` batch
    (source-major, each source's lanes in its own order) and
    ``recv_live`` flags the real lanes among the bucket fill.  All
    payloads and the live flag travel in one ``[D, P + 1, C]`` int32
    exchange.
    """
    C = did.shape[0]
    perm = torch.argsort(did, stable=True)
    did_s = did[perm]
    starts, lens = shard_segments(did_s, D)
    j = torch.arange(C, device=did.device)
    idx = torch.clamp(starts[:, None] + j[None, :], 0, C - 1).long()
    valid = j[None, :] < lens[:, None]                       # [D, C]
    rows = [torch.where(valid, p.to(torch.int32)[perm][idx], fill)
            for p, fill in zip(payloads, fills)]
    send = torch.stack(rows + [valid.to(torch.int32)], dim=1)
    recv = _all_to_all(send, group)
    received = [recv[:, i].reshape(D * C) for i in range(len(payloads))]
    return received, recv[:, -1].reshape(D * C) != 0, perm, starts, did_s


def _exchange_back(results: Sequence[torch.Tensor], perm: torch.Tensor,
                   starts: torch.Tensor, did_s: torch.Tensor, D: int,
                   group) -> List[torch.Tensor]:
    """Send each ``[D * C]`` per-lane result back to its source and restore
    the source's lane order: after the exchange row ``b`` holds the
    results of this device's bucket-``b`` lanes, so sorted lane ``j``'s is
    ``back[did_s[j], j - starts[did_s[j]]]``; the inverse permutation
    undoes the route sort."""
    C = did_s.shape[0]
    send = torch.stack([r.to(torch.int32).reshape(D, C) for r in results],
                       dim=1)                               # [D, P, C]
    back = _all_to_all(send, group)
    j = torch.arange(C, device=did_s.device)
    rows = did_s.long()
    res_sorted = back[rows, :, j - starts[rows].long()]     # [C, P]
    res = res_sorted[torch.argsort(perm)]
    return [res[:, i] for i in range(len(results))]


def _validate(mx: MeshShardedIndex, mesh) -> Tuple[int, int, object]:
    """(D, this device's index, its process group); ``ValueError`` on a
    mesh without the ``"index"`` dimension, of another size, of another
    device type, or where this process holds another device's slice."""
    D = index_axis_size(mesh)
    if D != mx.n_devices:
        raise ValueError(f"index was partitioned for {mx.n_devices} "
                         f"device(s) but the mesh has {D} on the "
                         f"'{INDEX_AXIS}' dimension; rebuild the index for "
                         "this mesh")
    if mesh.device_type != mx.device.type:
        raise ValueError(f"index on {mx.device.type} but the mesh is "
                         f"{mesh.device_type}")
    me = mesh.get_local_rank(INDEX_AXIS)
    if me != mx.rank:
        raise ValueError(f"this process is device {me} of the mesh but holds "
                         f"device {mx.rank}'s slice")
    return D, me, mesh.get_group(INDEX_AXIS)


def _lanes(mx: MeshShardedIndex, a) -> torch.Tensor:
    return torch.as_tensor(a, device=mx.device).to(torch.int32)


# ---------------------------------------------------------------------------
# The collective data paths (every rank calls them with its own chunk)
# ---------------------------------------------------------------------------

def search_mesh(mx: MeshShardedIndex, queries, *, mesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched lookup across the mesh: (found [C], vals [C]) of this rank's
    chunk ``queries [C]`` (``chunk``; every rank passes ``C`` lanes).

    Equal to ``search_sharded`` on the equivalent single-device index.
    """
    D, _, group = _validate(mx, mesh)
    q = _lanes(mx, queries)
    did = route(mx.device_boundaries, q)
    (rq,), _, perm, starts, did_s = _exchange_out(did, (q,), (0,), D, group)
    found, vals = shd.search_sharded(mx.local, rq)
    found, vals = _exchange_back((found, vals), perm, starts, did_s, D,
                                 group)
    return found != 0, vals


def apply_ops_mesh(mx: MeshShardedIndex, op_types, keys, vals, *, mesh,
                   rebalance: bool = False, high_water: float = HIGH_WATER,
                   low_water: float = LOW_WATER, max_shards: int = 0,
                   seed: int = 0
                   ) -> Tuple[MeshShardedIndex, torch.Tensor,
                              DeviceLoadStats]:
    """Apply a linearized mixed-op batch across the mesh: (new index,
    results [C] of this rank's chunk, ``DeviceLoadStats``).

    Lanes are exchanged as in ``search_mesh``; each rank applies the lanes
    it received with ``apply_ops_sharded`` and seed ``seed + rank``, with
    ``rebalance`` through the in-place passes inside its own shard axis
    (``max_shards`` tightens that ceiling).  The stats fold every
    device's live keys and received lanes, all-gathered.
    """
    D, me, group = _validate(mx, mesh)
    ops, ks, vs = (_lanes(mx, a) for a in (op_types, keys, vals))
    did = route(mx.device_boundaries, ks)
    (r_ops, r_keys, r_vals), live_lanes, perm, starts, did_s = _exchange_out(
        did, (ops, ks, vs), (OP_READ, 0, 0), D, group)
    local, res = shd.apply_ops_sharded(
        mx.local, r_ops, r_keys, r_vals, rebalance=rebalance,
        high_water=high_water, low_water=low_water, max_shards=max_shards,
        seed=int(seed) + me, _in_place=True)
    res, = _exchange_back((res,), perm, starts, did_s, D, group)
    mine = torch.stack([shd.total_n(local),
                        live_lanes.sum(dtype=torch.int32)])
    counts = _all_gather(mine, D, group)                     # [D, 2]
    return (mx._replace(local=local), res,
            cross_device_load(counts[:, 0], counts[:, 1]))


# ---------------------------------------------------------------------------
# Invariants / introspection: per-rank checks joined by collectives
# ---------------------------------------------------------------------------

def _all_gather(t: torch.Tensor, D: int, group) -> torch.Tensor:
    out = [torch.empty_like(t) for _ in range(D)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def total_n_mesh(mx: MeshShardedIndex, *, mesh) -> torch.Tensor:
    """[] int32 live keys over every device."""
    _, _, group = _validate(mx, mesh)
    n = shd.total_n(mx.local).clone()
    dist.all_reduce(n, group=group)
    return n


def device_live(mx: MeshShardedIndex, *, mesh) -> torch.Tensor:
    """[D] int32 live keys per device: the load the counters report."""
    D, _, group = _validate(mx, mesh)
    return _all_gather(shd.total_n(mx.local), D, group)


def check_mesh_invariant(mx: MeshShardedIndex, expect_n=None, *, mesh
                         ) -> torch.Tensor:
    """[] bool on every rank: every device's ``check_sharded_invariant``,
    the boundaries sorted from ``KEY_MIN``, every live key inside its
    device's slice and (with ``expect_n``) the global live count."""
    _, me, group = _validate(mx, mesh)
    db = mx.device_boundaries
    ok = shd.check_sharded_invariant(mx.local)
    ok &= (db[0] == KEY_MIN) & (db[1:] >= db[:-1]).all()
    keys = mx.local.shards.keys
    live = (keys != KEY_MAX) & (keys != KEY_MIN)
    hi = db[me + 1] if me + 1 < mx.n_devices else KEY_MAX
    ok &= torch.where(live, (keys >= db[me]) & (keys < hi), True).all()
    ok = ok.to(torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    ok = ok != 0
    if expect_n is not None:
        ok &= total_n_mesh(mx, mesh=mesh) == int(expect_n)
    return ok
