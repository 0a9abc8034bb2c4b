"""Distributed flash-decode: sequence-sharded KV attention with an LSE
combine (port of ``repro.parallel.decode_attn``).

GQA decode cannot shard 8 KV heads over a 16-way model axis.  Instead the
KV cache's *sequence* dim is sharded, each shard computes partial
attention over its slots, and the shards combine with the exact
log-sum-exp rule:

    m = max over shards of m_local
    l = sum over shards of exp(m_local - m) * l_local
    o = sum over shards of exp(m_local - m) * o_local, divided by l

The reference's ``pmax`` / ``psum`` over the sequence axes are
functional all-reduces (max, sum) over the sequence shards' process
group here: one process a shard, each with its own slice of the cache.
On a mesh with a ``device_mesh`` the group is that of the sequence axes
(``device_mesh[seq_axes]``, flattened where there are several), and the
combine runs on the local shards of DTensor arguments (``local_map``:
q and the output laid out by the batch axes, the cache by batch and
sequence, as the reference's ``shard_map`` specs).  Without a mesh,
``group=`` names the shards' group, one process a shard; with neither
there is one shard, the whole cache.  Its volume a layer is the partial
outputs, O(B*H*D), not the O(B*S*Hkv*D) of gathering the cache.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.parallel.sharding import P, on_shards, to_placements


def make_distributed_decode_attn(mesh, batch_axes, seq_axes: Tuple[str, ...],
                                 group=None):
    """Build a drop-in replacement for ``layers.decode_attention``.

    Args:
      mesh: the model mesh (``launch.mesh.ModelMesh``).
      batch_axes: mesh axes sharding the batch dim (None / str / tuple);
        each process holds its batch rows, so they only name the layout.
      seq_axes: mesh axes sharding the KV sequence dim.
      group: without a ``device_mesh``, the process group of the sequence
        shards (``None``: one shard); this process's shard is its rank in
        the group.
    """
    dm = getattr(mesh, "device_mesh", None)
    if dm is not None:
        seq_axes = tuple(seq_axes)
        if seq_axes:
            sub = dm[seq_axes]
            group = (sub._flatten() if len(seq_axes) > 1 else sub
                     ).get_group()
        else:
            group = None
    if group is not None and dist.get_world_size(group) == 1:
        group = None                    # one shard: nothing to combine
    shard = dist.get_rank(group) if group is not None else 0

    def all_reduce(t, op):
        if group is not None:
            t = funcol.all_reduce(t, op, group)
        return t

    def local_attn(q, k, v, length):
        """q [B,1,H,D]; k, v this shard's [B,S_loc,Hkv,D]; ``length`` []
        or [B] valid slots of the whole cache.  Returns [B,1,H,D]."""
        B, S_loc, Hkv, D = k.shape
        rep = q.shape[2] // Hkv
        pos = shard * S_loc + torch.arange(S_loc, device=q.device)
        valid = pos[None, :] < torch.as_tensor(
            length, device=q.device).reshape(-1, 1)          # [B,S_loc]
        kg = k.float().repeat_interleave(rep, dim=2)
        vg = v.repeat_interleave(rep, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg) / math.sqrt(D)
        sc = torch.where(valid[:, None, None, :], sc,
                         torch.full_like(sc, -1e30))
        m = all_reduce(sc.amax(dim=-1), "max")               # [B,H,1]
        p = torch.exp(sc - m[..., None])
        l = all_reduce(p.sum(dim=-1), "sum")                 # [B,H,1]
        o = all_reduce(torch.einsum("bhqk,bkhd->bqhd",
                                    p.to(v.dtype).float(), vg.float()),
                       "sum")
        out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        return out.to(q.dtype)

    if dm is None:
        return local_attn
    s = seq_axes if len(seq_axes) > 1 else (seq_axes[0] if seq_axes
                                            else None)
    q_pl = to_placements(P(batch_axes, None, None, None), dm)
    kv_pl = to_placements(P(batch_axes, s, None, None), dm)
    len_pl = to_placements(P(batch_axes), dm)
    return on_shards(local_attn, q_pl, (q_pl, kv_pl, kv_pl, len_pl), dm)
