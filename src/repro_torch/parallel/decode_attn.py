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
``all_reduce(MAX)`` / ``all_reduce(SUM)`` over ``group`` here: one
process a shard, each calling with its own slice of the cache.  Without
a group there is one shard, the whole cache.  Its volume a layer is the
partial outputs, O(B*H*D), not the O(B*S*Hkv*D) of gathering the cache.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist


def make_distributed_decode_attn(mesh, batch_axes, seq_axes: Tuple[str, ...],
                                 group=None):
    """Build a drop-in replacement for ``layers.decode_attention``.

    Args:
      mesh: the model mesh (``launch.mesh.ModelMesh``).
      batch_axes: mesh axes sharding the batch dim (None / str / tuple);
        each process holds its batch rows, so they only name the layout.
      seq_axes: mesh axes sharding the KV sequence dim.
      group: the process group of the sequence shards (``None``: one
        shard); this process's shard is its rank in the group.
    """
    del mesh, batch_axes, seq_axes     # the layout is the group's
    shard = dist.get_rank(group) if group is not None else 0

    def all_reduce(t, op):
        if group is not None:
            dist.all_reduce(t, op=op, group=group)
        return t

    def decode_attn(q, k, v, length):
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
        m = all_reduce(sc.amax(dim=-1), dist.ReduceOp.MAX)   # [B,H,1]
        p = torch.exp(sc - m[..., None])
        l = all_reduce(p.sum(dim=-1), dist.ReduceOp.SUM)     # [B,H,1]
        o = all_reduce(torch.einsum("bhqk,bkhd->bqhd",
                                    p.to(v.dtype).float(), vg.float()),
                       dist.ReduceOp.SUM)
        out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        return out.to(q.dtype)

    return decode_attn
