"""RWKV-6 "Finch" mixer — attention-free, data-dependent decay (port of
``repro.models.rwkv6``).

Time-mixing follows arXiv:2404.05892: token-shift interpolation with
data-dependent mix (low-rank), per-channel data-dependent decay ``w`` via a
LoRA on the shifted input, and the WKV linear-attention recurrence per head:

    S_t = diag(exp(-exp(w_t))) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

Training/prefill runs the recurrence as a sequential loop over time (state
[B,H,D,D]), in the reference's order of operations; the reference cuts
time into chunks of ``T_CHUNK`` and pads the last with ``decay=1, k=v=0``,
which leaves the state as it is, so the loop needs no padding.  Decode is
the O(1) single-step recurrence.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ParamBuilder, matmul, pad_seq,
                                       reshape)
from repro_torch.parallel.sharding import is_dtensor, on_shards, whole

PyTree = Any

HEAD_DIM = 64
LORA_R = 32
T_CHUNK = 128


def build_rwkv6(pb: ParamBuilder, d_model: int) -> PyTree:
    return {
        # token-shift mix coefficients (static part) for r,k,v,w,g
        "mix": pb.param((5, d_model), (None, "embed"), init="zeros",
                        dtype=torch.float32),
        # data-dependent mix LoRA
        "mix_lora_a": pb.param((d_model, 5 * LORA_R), ("embed", None)),
        "mix_lora_b": pb.param((5, LORA_R, d_model), (None, None, "embed")),
        "wr": pb.param((d_model, d_model), ("embed", "inner")),
        "wk": pb.param((d_model, d_model), ("embed", "inner")),
        "wv": pb.param((d_model, d_model), ("embed", "inner")),
        "wg": pb.param((d_model, d_model), ("embed", "inner")),
        # decay: static base + LoRA(data)
        "w_base": pb.param((d_model,), ("embed",), init="zeros",
                           dtype=torch.float32),
        "w_lora_a": pb.param((d_model, LORA_R), ("embed", None)),
        "w_lora_b": pb.param((LORA_R, d_model), (None, "embed")),
        "u_bonus": pb.param((d_model,), ("embed",), init="zeros",
                            dtype=torch.float32),
        "wo": pb.param((d_model, d_model), ("inner", "embed")),
        "ln_w": pb.param((d_model,), ("embed",), init="ones",
                         dtype=torch.float32),
        "ln_b": pb.param((d_model,), ("embed",), init="zeros",
                         dtype=torch.float32),
    }


def _projections(p: PyTree, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift mixing + projections. x, x_prev [B,S,d]."""
    B, S, d = x.shape
    f32 = torch.float32
    delta = (x_prev - x).float()
    lora = matmul(x.float(), p["mix_lora_a"].float(), f32)
    lora = reshape(torch.tanh(lora), B, S, 5, LORA_R)
    dyn = torch.einsum("bsfr,frd->bsfd", lora,
                       p["mix_lora_b"].float())                # [B,S,5,d]
    mix = p["mix"][None, None] + dyn                           # [B,S,5,d]
    xi = x.float()[:, :, None] + delta[:, :, None] * mix
    xr, xk, xv, xw, xg = [xi[:, :, i].to(x.dtype) for i in range(5)]

    r = matmul(xr, p["wr"], f32)
    k = matmul(xk, p["wk"], f32)
    v = matmul(xv, p["wv"], f32)
    g = matmul(xg, p["wg"], f32)
    wl = torch.tanh(matmul(xw.float(), p["w_lora_a"].float(), f32))
    w = p["w_base"][None, None] + matmul(wl, p["w_lora_b"].float(), f32)
    decay = torch.exp(-torch.exp(w))                           # (0,1) per chan
    return r, k, v, g, decay


def _wkv(r, k, v, decay, u, S0):
    """The recurrence over axis 1 of [B,S,H,D] inputs from state ``S0``
    [B,H,D,D]: (outs [B,S,H,D], final state)."""
    Sst = S0
    outs = torch.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # [B,H,D,D]
        outs[:, t] = torch.einsum("bhd,bhde->bhe", r[:, t],
                                  Sst + u[None, :, :, None] * kv)
        Sst = decay[:, t, ..., None] * Sst + kv
    return outs, Sst


def _wkv_from_zero(r, k, v, decay, u):
    """``_wkv`` from a zero state.  On DTensors it runs on each rank's
    shards (``local_map``): the recurrence is elementwise over the batch
    and the heads that the mesh splits; ``u``'s gradient sums over a
    batch split."""
    def run(r_, k_, v_, d_, u_):
        B, _, H, D = r_.shape
        S0 = torch.zeros((B, H, D, D), dtype=torch.float32, device=r_.device)
        return _wkv(r_, k_, v_, d_, u_, S0)

    if not is_dtensor(r):
        return run(r, k, v, decay, u)
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = whole(r.placements)
    state = [Shard(q.dim - 1) if isinstance(q, Shard) and q.dim > 1 else q
             for q in pl]
    up = [Shard(0) if q == Shard(2) else Replicate() for q in pl]
    ug = [Partial() if q == Shard(0) else p_ for q, p_ in zip(pl, up)]
    return on_shards(run, (pl, state), (pl, pl, pl, pl, up), r.device_mesh,
                     grads=(pl, pl, pl, pl, ug))(r, k, v, decay, u)


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                groups: int) -> torch.Tensor:
    B, S, d = x.shape
    xg = reshape(x, B, S, groups, d // groups).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, correction=0)
    y = reshape((xg - mu) * torch.rsqrt(var + 1e-5), B, S, d)
    return y * w.float() + b.float()


def _rwkv6(p: PyTree, x: torch.Tensor):
    """Full-sequence forward: (y [B,S,d], final wkv state)."""
    B, S, d = x.shape
    H = d // HEAD_DIM
    x_prev = pad_seq(x, 1, 0)[:, :-1]
    r, k, v, g, decay = _projections(p, x, x_prev)
    heads = lambda a: reshape(a, B, S, H, HEAD_DIM)   # noqa: E731
    u = reshape(p["u_bonus"], H, HEAD_DIM)
    out, ST = _wkv_from_zero(heads(r), heads(k), heads(v), heads(decay), u)
    out = reshape(out, B, S, d) * F.silu(g)                      # gated
    out = _group_norm(out, p["ln_w"], p["ln_b"], H)
    return matmul(out.to(x.dtype), p["wo"], x.dtype), ST


def rwkv6_fwd(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x [B,S,d]."""
    return _rwkv6(p, x)[0]


def rwkv6_init_cache(p: PyTree, batch: int, dtype=torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    d = p["wr"].shape[0]
    H = d // HEAD_DIM
    dev = p["wr"].device
    return {
        "shift": torch.zeros((batch, 1, d), dtype=dtype, device=dev),
        "wkv": torch.zeros((batch, H, HEAD_DIM, HEAD_DIM),
                           dtype=torch.float32, device=dev),
    }


def rwkv6_decode(p: PyTree, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence. x [B,1,d]; state is O(1) in context length."""
    B, _, d = x.shape
    H = d // HEAD_DIM
    r, k, v, g, decay = _projections(p, x, cache["shift"].to(x.dtype))
    heads = lambda a: reshape(a, B, 1, H, HEAD_DIM)   # noqa: E731
    u = reshape(p["u_bonus"], H, HEAD_DIM)
    out, S_new = _wkv(heads(r), heads(k), heads(v), heads(decay), u,
                      cache["wkv"])
    out = reshape(out, B, 1, d) * F.silu(g)
    out = _group_norm(out, p["ln_w"], p["ln_b"], H)
    y = matmul(out.to(x.dtype), p["wo"], x.dtype)
    return y, {"shift": x.to(cache["shift"].dtype), "wkv": S_new}
