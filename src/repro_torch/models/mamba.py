"""Mamba (selective SSM) mixer — for the Jamba hybrid architecture (port of
``repro.models.mamba``).

Training/prefill runs the recurrence ``h_t = a_t * h_{t-1} + bu_t`` as a
sequential loop over time, where the reference runs an associative scan
inside chunks of ``CHUNK`` tokens: the same sums in another order, held
to the reference within a stated tolerance.  The loop carries one state
[B, d_inner, N], so it needs no ``CHUNK`` padding (the reference pads
with ``a=1, bu=0``, which leaves the state as it is).  Decode is the
single-step recurrence with the state carried in the cache.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamBuilder, matmul
from repro_torch.parallel.sharding import is_dtensor, on_shards, whole

PyTree = Any

D_STATE = 16
D_CONV = 4
CHUNK = 256


def build_mamba(pb: ParamBuilder, d_model: int, expand: int = 2,
                dt_rank: int = 0) -> PyTree:
    d_inner = expand * d_model
    dt_rank = dt_rank or max(d_model // 16, 1)
    return {
        "in_proj": pb.param((d_model, 2 * d_inner), ("embed", "inner")),
        "conv_w": pb.param((D_CONV, d_inner), ("conv", "inner")),
        "conv_b": pb.param((d_inner,), ("inner",), init="zeros"),
        "x_proj": pb.param((d_inner, dt_rank + 2 * D_STATE),
                           ("inner", "state")),
        "dt_proj_w": pb.param((dt_rank, d_inner), ("state", "inner")),
        "dt_proj_b": pb.param((d_inner,), ("inner",), init="zeros"),
        "a_log": pb.param((d_inner, D_STATE), ("inner", "state"),
                          init="ones", dtype=torch.float32),
        "d_skip": pb.param((d_inner,), ("inner",), init="ones",
                           dtype=torch.float32),
        "out_proj": pb.param((d_inner, d_model), ("inner", "embed")),
    }


def _ssm_inputs(p: PyTree, u: torch.Tensor):
    """u [B,S,d_inner] -> discretized (a [B,S,di,N], bu [B,S,di,N], Cmat)."""
    dt_rank = p["dt_proj_w"].shape[0]
    proj = matmul(u, p["x_proj"], torch.float32)
    dt_in = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank:dt_rank + D_STATE]                 # [B,S,N]
    Cmat = proj[..., dt_rank + D_STATE:]                        # [B,S,N]
    dt = F.softplus(matmul(dt_in, p["dt_proj_w"], torch.float32)
                    + p["dt_proj_b"].float())                   # [B,S,di]
    A = -torch.exp(p["a_log"].float())                          # [di,N]
    a = torch.exp(dt[..., None] * A[None, None])                # [B,S,di,N]
    bu = (dt * u.float())[..., None] * Bmat[:, :, None, :]
    return a, bu, Cmat


def _in_conv(p: PyTree, x: torch.Tensor):
    """Input projection and the depthwise causal conv (kernel ``D_CONV``,
    in ``x.dtype`` as the reference's): (u before the conv, u after, z)."""
    S = x.shape[1]
    d_inner = p["conv_w"].shape[1]
    ug = matmul(x, p["in_proj"], x.dtype)
    u, z = ug[..., :d_inner], ug[..., d_inner:]

    def conv_silu(u_, w, b):
        upad = F.pad(u_, (0, 0, D_CONV - 1, 0))
        conv = 0
        for i in range(D_CONV):
            conv = conv + upad[:, i:i + S] * w[i][None, None]
        conv = conv + b[None, None]
        return F.silu(conv.float()).to(x.dtype)

    if not is_dtensor(u):
        return u, conv_silu(u, p["conv_w"], p["conv_b"]), z
    # on local shards: the conv is depthwise, over the batch and inner
    # dims the mesh splits (its weights split with the inner dim)
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = whole(u.placements)
    wp = [Shard(1) if q == Shard(2) else Replicate() for q in pl]
    bp = [Shard(0) if q == Shard(2) else Replicate() for q in pl]
    wg = [Partial() if q == Shard(0) else w_ for q, w_ in zip(pl, wp)]
    bg = [Partial() if q == Shard(0) else b_ for q, b_ in zip(pl, bp)]
    uc = on_shards(conv_silu, pl, (pl, wp, bp), u.device_mesh,
                   grads=(pl, wg, bg))(u, p["conv_w"], p["conv_b"])
    return u, uc, z


def _scan(a: torch.Tensor, bu: torch.Tensor, h: torch.Tensor):
    """``h_t = a_t * h_{t-1} + bu_t`` over axis 1: (hs [B,S,di,N], h_S)."""
    hs = torch.empty_like(bu)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bu[:, t]
        hs[:, t] = h
    return hs, h


def _scan_read(a: torch.Tensor, bu: torch.Tensor, Cmat: torch.Tensor):
    """``_scan`` from a zero state, read out through ``Cmat``: (y [B,S,di]
    before the skip and gate, h_S).  On DTensors it runs on each rank's
    shards (``local_map``): the recurrence is elementwise over the batch
    and inner dims that the mesh splits, so no rank needs another's."""
    def run(a_, bu_, c_):
        h0 = torch.zeros((a_.shape[0], a_.shape[2], a_.shape[3]),
                         dtype=torch.float32, device=a_.device)
        hs, hT = _scan(a_, bu_, h0)
        return torch.einsum("bsin,bsn->bsi", hs, c_), hT

    if not is_dtensor(a):
        return run(a, bu, Cmat)
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = whole(a.placements)
    last = [Shard(q.dim - 1) if isinstance(q, Shard) and q.dim > 1 else q
            for q in pl]
    cp = [q if q == Shard(0) else Replicate() for q in pl]
    cg = [Partial() if q == Shard(2) else c_ for q, c_ in zip(pl, cp)]
    return on_shards(run, (pl[:], last), (pl, pl, cp), a.device_mesh,
                     grads=(pl, pl, cg))(a, bu, Cmat)


def _mamba(p: PyTree, x: torch.Tensor):
    """Full-sequence forward: (y [B,S,d], terminal state h, u before the
    conv)."""
    B = x.shape[0]
    d_inner = p["conv_w"].shape[1]
    u0, u, z = _in_conv(p, x)
    a, bu, Cmat = _ssm_inputs(p, u)
    y, hT = _scan_read(a, bu, Cmat)
    y = y + p["d_skip"][None, None] * u.float()
    y = y * F.silu(z.float())
    return matmul(y.to(x.dtype), p["out_proj"], x.dtype), hT, u0


def mamba_fwd(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x [B,S,d] -> [B,S,d]."""
    return _mamba(p, x)[0]


def mamba_init_cache(p: PyTree, batch: int, dtype=torch.float32
                     ) -> Dict[str, torch.Tensor]:
    d_inner = p["conv_w"].shape[1]
    dev = p["conv_w"].device
    return {
        "h": torch.zeros((batch, d_inner, D_STATE), dtype=torch.float32,
                         device=dev),
        "conv": torch.zeros((batch, D_CONV - 1, d_inner), dtype=dtype,
                            device=dev),
    }


def mamba_decode(p: PyTree, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence. x [B,1,d]."""
    d_inner = p["conv_w"].shape[1]
    ug = matmul(x, p["in_proj"], x.dtype)
    u, z = ug[..., :d_inner], ug[..., d_inner:]

    window = torch.cat([cache["conv"], u.to(cache["conv"].dtype)],
                       dim=1)                                   # [B,D_CONV,di]
    conv = (window.float() * p["conv_w"].float()[None]).sum(dim=1) \
        + p["conv_b"].float()
    uc = F.silu(conv)[:, None].to(x.dtype)                      # [B,1,di]

    a, bu, Cmat = _ssm_inputs(p, uc)
    h = cache["h"] * a[:, 0] + bu[:, 0]                         # [B,di,N]
    y = torch.einsum("bin,bn->bi", h, Cmat[:, 0])
    y = y + p["d_skip"][None] * uc[:, 0].float()
    y = y * F.silu(z[:, 0].float())
    out = matmul(y.to(x.dtype), p["out_proj"], x.dtype)[:, None]
    return out, {"h": h, "conv": window[:, 1:]}
