"""Mixture-of-Experts FFN — sort-based token dispatch (port of
``repro.models.moe``).

Tokens are sorted by expert id, placed into a fixed-capacity [E, C, d]
buffer (overflow dropped — capacity-factor semantics), batch-multiplied
against the stacked expert weights, and scattered back weighted by the
router gates.  Routing is integer and equals the reference's exactly on
equal inputs:

* the top-k is a stable descending sort (``lax.top_k`` returns the lower
  index first among equal values; ``torch.topk`` promises no order);
* the expert order is ``torch.sort(stable=True)`` (``jnp.argsort(stable=
  True)``);
* a dropped token's slot is ``E*C``, one spare row past the buffer that
  is cut off (``.at[slot].set(mode="drop")``);
* capacity ``C`` is lane-aligned to 128, which decides what drops.

Grouped dispatch (GShard), as the reference's: with a sharding context
``cs`` the tokens split into ``G = cs.moe_groups`` groups (the DP degree),
each routed with group-local indices at a capacity of its own, so a mesh
drops the tokens the reference drops there.  On a mesh (DTensors) the
dispatch and the combine run on each rank's local groups
(``local_map``), the buffers ``[G, E, C, d]`` are laid out by
``cs.moe_mode`` (``"dp"``, ``"ep_ctp"``, ``"ep_a2a"``: the reshards
around the experts are the all-to-alls), and the experts' products run
on local shards: each rank its experts, its capacity slots and its slice
of the ffn dim, a partial sum where the ffn dim is split.  Without ``cs``
there is one group and nothing changes.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamBuilder, bmatmul
from repro_torch.parallel.sharding import is_dtensor, on_shards

PyTree = Any


def build_moe(pb: ParamBuilder, d_model: int, d_ff: int, n_experts: int
              ) -> PyTree:
    return {
        "router": pb.param((d_model, n_experts), ("embed", "experts"),
                           dtype=torch.float32),
        "w_gate": pb.param((n_experts, d_model, d_ff),
                           ("experts", "embed", "ffn")),
        "w_up": pb.param((n_experts, d_model, d_ff),
                         ("experts", "embed", "ffn")),
        "w_down": pb.param((n_experts, d_ff, d_model),
                           ("experts", "ffn", "embed")),
    }


def stable_top_k(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, int32 indices), the lower
    index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _dispatch_group(xt: torch.Tensor, router: torch.Tensor, top_k_: int,
                    C: int, E: int):
    """Dispatch one token group. xt [Tg, d] -> (buf [E,C,d], combine info,
    aux).  ``info = (tok_s, gate_s, slot, keep)``, every index int32."""
    Tg, d = xt.shape
    dev = xt.device
    logits = xt.float() @ router.float()                        # [Tg,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = stable_top_k(probs, top_k_)               # [Tg,K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=0)
    ce = F.one_hot(eidx.long(), E).float().sum(dim=1).mean(dim=0)
    aux = (me * ce).sum() * E

    te = eidx.reshape(-1)                                       # [Tg*K]
    tok = torch.arange(Tg, dtype=torch.int32,
                       device=dev).repeat_interleave(top_k_)
    gates = gate_vals.reshape(-1)
    order = torch.sort(te, stable=True).indices
    te_s, tok_s, gate_s = te[order], tok[order], gates[order]
    # bincount of a fixed length (its output shape is not data-dependent,
    # and it is deterministic on the card)
    counts = (te.long()[:, None] == torch.arange(E, device=dev)).sum(0)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    pos = torch.arange(Tg * top_k_, dtype=torch.int32,
                       device=dev) - starts[te_s.long()]
    keep = pos < C
    slot = torch.where(keep, te_s * C + pos,
                       torch.full_like(pos, E * C))             # OOB -> drop

    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=dev)
    buf[slot.long()] = xt[tok_s.long()]             # row E*C: the spare
    return buf[:E * C].reshape(E, C, d), (tok_s, gate_s, slot, keep), aux


def _combine_group(y_e: torch.Tensor, info, Tg: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Weighted scatter back for one group. y_e [E,C,d] -> [Tg,d]."""
    tok_s, gate_s, slot, keep = info
    EC, d = y_e.shape[0] * y_e.shape[1], y_e.shape[2]
    y_slots = y_e.reshape(EC, d)
    gathered = torch.where(keep[:, None],
                           y_slots[torch.clamp(slot, max=EC - 1).long()],
                           torch.zeros((), dtype=y_e.dtype,
                                       device=y_e.device))
    out = torch.zeros((Tg, d), dtype=dtype, device=y_e.device)
    return out.index_add_(0, tok_s.long(),
                          gathered * gate_s[:, None].to(dtype))


def capacity(T: int, top_k_: int, E: int, capacity_factor: float) -> int:
    """Per-expert capacity of one group, lane-aligned to 128."""
    C = int(capacity_factor * T * top_k_ / E) + 1
    return ((C + 127) // 128) * 128


def _dispatch(xg: torch.Tensor, router: torch.Tensor, top_k_: int, C: int,
              E: int):
    """``_dispatch_group`` over the leading group axis of xg [G, Tg, d]:
    (buf [G,E,C,d], tok_s, gate_s, slot, keep [G, Tg*K], aux [G])."""
    outs = [_dispatch_group(xt, router, top_k_, C, E) for xt in xg]
    buf = torch.stack([o[0] for o in outs])
    info = [torch.stack([o[1][i] for o in outs]) for i in range(4)]
    return (buf, *info, torch.stack([o[2] for o in outs]))


def _combine(y_e: torch.Tensor, tok_s, gate_s, slot, keep, Tg: int,
             dtype: torch.dtype) -> torch.Tensor:
    """``_combine_group`` over the leading group axis: [G, Tg, d]."""
    return torch.stack([_combine_group(y_e[g], (tok_s[g], gate_s[g],
                                                slot[g], keep[g]), Tg, dtype)
                        for g in range(y_e.shape[0])])


def _experts(buf: torch.Tensor, w_gate, w_up, w_down,
             dtype: torch.dtype) -> torch.Tensor:
    """The experts' SwiGLU on buf [G, E, C, d] -> [G, E, C, d], each
    expert over its G * C slots."""
    G, E, C, d = buf.shape
    a = buf.transpose(0, 1).reshape(E, G * C, d)
    g = bmatmul(a, w_gate, torch.float32)
    u = bmatmul(a, w_up, torch.float32)
    act = (F.silu(g) * u).to(dtype)
    y = bmatmul(act, w_down, dtype)
    return y.reshape(E, G, C, d).transpose(0, 1)


def _local(fn, out_dims, args, in_placements, mesh, grads=None):
    """``fn`` on the local shards of DTensor ``args`` laid out as
    ``in_placements`` (redistributed to them first), its outputs DTensors
    laid out as ``out_dims`` (a placement list an output); ``grads`` the
    layouts of the inputs' gradients where they differ (a partial sum
    where a rank sees only part of the rows)."""
    return on_shards(fn, out_dims, in_placements, mesh, grads=grads)(*args)


def dispatch(xg: torch.Tensor, router: torch.Tensor, top_k_: int, C: int,
             E: int):
    """``_dispatch`` on each rank's local groups when ``xg`` is a DTensor
    (groups laid out as xg's dim 0, replicated elsewhere; the router
    replicated), else as is."""
    if not is_dtensor(xg):
        return _dispatch(xg, router, top_k_, C, E)
    from torch.distributed.tensor import Partial, Replicate, Shard
    rows = [Shard(0) if pl == Shard(0) else Replicate()
            for pl in xg.placements]
    rep = [Replicate()] * len(rows)
    rgrad = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    return _local(lambda a, r: _dispatch(a, r, top_k_, C, E), (rows,) * 6,
                  (xg, router), (rows, rep), xg.device_mesh,
                  grads=(rows, rgrad))


def _experts_on_mesh(buf, w_gate, w_up, w_down, dtype):
    """``_experts`` on local shards.  A mesh dim that splits buf's experts
    splits the weights' experts; one that splits groups or capacity slots
    sees whole weights; on a mesh dim where buf is replicated the weights
    keep a split of their ffn dim, and the output is a partial sum there.
    The weights' other splits (FSDP, row-parallel) are gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    win, wdown, out, gbuf, gin, gdown = [], [], [], [], [], []
    for m, bp in enumerate(buf.placements):
        if bp == Shard(1):
            win.append(Shard(0)), wdown.append(Shard(0)), out.append(bp)
            gbuf.append(bp), gin.append(Shard(0)), gdown.append(Shard(0))
        elif bp == Replicate() and w_gate.placements[m] == Shard(2):
            win.append(Shard(2)), wdown.append(Shard(1))
            out.append(Partial())
            gbuf.append(Partial()), gin.append(Shard(2))
            gdown.append(Shard(1))
        else:
            # rows (groups, capacity slots) split, or nothing: whole
            # weights, whose gradient sums over the row split
            win.append(Replicate()), wdown.append(Replicate())
            out.append(bp)
            wg = Partial() if isinstance(bp, Shard) else Replicate()
            gbuf.append(bp), gin.append(wg), gdown.append(wg)
    return _local(lambda *a: _experts(*a, dtype), out,
                  (buf, w_gate, w_up, w_down),
                  (list(buf.placements), win, win, wdown), buf.device_mesh,
                  grads=(gbuf, gin, gin, gdown))


def moe_fwd(p: PyTree, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, cs=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux_loss []).

    With ``cs``, the reference's grouped dispatch: ``cs.moe_groups``
    groups of ``T / G`` tokens (one group when that does not divide), the
    buffers laid out by ``cs`` around the experts.  aux_loss is the
    standard load-balancing loss (mean_prob·mean_assign·E), averaged over
    the groups.
    """
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    G = getattr(cs, "moe_groups", 1)
    if G <= 0 or T % G:
        G = 1
    Tg = T // G
    if cs is None:                     # one group, nothing laid out
        def cs(t, kind):
            return t
    C = capacity(Tg, top_k, E, capacity_factor)    # per expert, per group
    xg = cs(x.reshape(G, Tg, d), "gtd")
    buf, *info, aux = dispatch(xg, p["router"], top_k, C, E)
    aux = aux.mean()
    if getattr(cs, "moe_mode", "") != "dp":
        buf = cs(buf, "gecd_dp")       # [G,E,C,d] group-sharded (local)
    buf = cs(buf, "gecd_ep")           # the reshard: all-to-all for EP
    if is_dtensor(buf):
        y_e = _experts_on_mesh(buf, p["w_gate"], p["w_up"], p["w_down"],
                               x.dtype)
    else:
        y_e = _experts(buf, p["w_gate"], p["w_up"], p["w_down"], x.dtype)
    y_e = cs(y_e, "gecd_ep")
    y_e = cs(y_e, "gecd_dp")           # all-to-all back: E -> G
    if is_dtensor(y_e):
        y = _local(lambda ye, *inf: _combine(ye, *inf, Tg, x.dtype),
                   list(info[0].placements),
                   (y_e, *info), [list(y_e.placements)]
                   + [list(t.placements) for t in info], y_e.device_mesh)
    else:
        y = _combine(y_e, *info, Tg, x.dtype)
    y = cs(y, "gtd")
    return y.reshape(B, S, d), aux
