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

The reference splits tokens into ``cs.moe_groups`` groups for sharding;
without a sharding context that is one group, which is all the port runs.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamBuilder, bmatmul

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
    counts = torch.bincount(te.long(), minlength=E)
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


def moe_fwd(p: PyTree, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux_loss []).

    aux_loss is the standard load-balancing loss (mean_prob·mean_assign·E).
    """
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    C = capacity(T, top_k, E, capacity_factor)
    buf, info, aux = _dispatch_group(x.reshape(T, d), p["router"], top_k,
                                     C, E)
    g = bmatmul(buf, p["w_gate"], torch.float32)                # [E,C,f]
    u = bmatmul(buf, p["w_up"], torch.float32)
    act = (F.silu(g) * u).to(x.dtype)
    y_e = bmatmul(act, p["w_down"], x.dtype)                    # [E,C,d]
    y = _combine_group(y_e, info, T, x.dtype)
    return y.reshape(B, S, d), aux
