"""Shared model layers: ParamBuilder, norms, rotary, attention, MLP (port
of ``repro.models.layers``).

Conventions
-----------
* Params are nested dicts (and lists) of tensors.  A single ``build_*``
  function describes each module once; the ``ParamBuilder`` materializes
  it as real tensors drawn from a ``torch.Generator`` (init), tensors on
  the ``meta`` device (abstract: shapes and dtypes, nothing allocated) or
  logical-axis tuples (axes) — one source of truth, three views.
* Logical axes vocabulary: "layers" (the stacked reps), "embed"
  (d_model), "ffn", "heads", "kv_heads", "head_dim", "vocab", "experts",
  "inner" (mamba), "state", "conv", "frames".
* Weights and activations are bf16.  Every product accumulates in fp32
  and is rounded once to its output dtype (``matmul`` / ``contract``);
  norms and softmax statistics run in fp32.  On the CPU the products run
  on fp32 copies of their operands, so that the result does not depend on
  how torch accumulates bf16 there; on the card a bf16 product is one
  cuBLAS call with fp32 accumulation, and one with an fp32 output
  takes its gradient through ``_F32Product``.  Products of two
  activations (attention scores and values) run in fp32 on both devices.
* On a mesh the params and activations are DTensors (``parallel.
  sharding``): a product runs on each rank's local shards
  (``_mesh_matmul``, ``sharding.on_shards`` around the same local products,
  ``_F32Product`` included, so torch's missing DTensor strategies for
  ``aten.mm.dtype`` / ``aten.bmm.dtype`` are never needed), as do
  attention (``attend``) and the embedding.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel.sharding import (is_dtensor, on_shards,
                                           reshape_placements, whole)

PyTree = Any


# ---------------------------------------------------------------------------
# Products with fp32 accumulation
# ---------------------------------------------------------------------------

_CARD_NUMERICS = False


@contextlib.contextmanager
def card_numerics():
    """Products run as the card runs them whatever the tensors' device:
    bf16 operands, fp32 accumulation, no fp32 copies.  The dry-run traces
    under it (``launch.dryrun``), on fake tensors of any device type, so
    that what it counts (bytes held, moved and multiplied) is the card's
    and not the fp32 upcasts the CPU path makes.  This is the port's twin
    of the reference's ``REPRO_MOE_BF16`` (set by its dry-run so that the
    MoE's einsums stay bf16 on the CPU backend).  Outside it the numerics
    are as the module docstring says."""
    global _CARD_NUMERICS
    old, _CARD_NUMERICS = _CARD_NUMERICS, True
    try:
        yield
    finally:
        _CARD_NUMERICS = old


def _in_fp32(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a product runs on fp32 copies: on the CPU (outside
    ``card_numerics``), or with an fp32 operand (the reference promotes
    those to fp32)."""
    return ((a.device.type == "cpu" and not _CARD_NUMERICS)
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16)


class _F32Product(torch.autograd.Function):
    """``a @ b`` (``torch.mm``) or ``a.bmm(b)`` of two bf16 operands with an
    fp32 output: one cuBLAS call with fp32 accumulation.  torch has no
    derivative for ``aten::mm.dtype`` / ``aten::bmm.dtype``; this is the
    reference's transpose rule for ``dot_general(...,
    preferred_element_type=float32)``: the fp32 cotangent times the other
    operand, accumulated in fp32 and cast to the operand's dtype.  The
    cotangent is rounded to bf16 first, so that both backward products run
    on the tensor cores as the forward does (widening the bf16 operand
    instead would run them as fp32 products)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        prod = torch.mm if a.dim() == 2 else torch.bmm
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = prod(g, b.transpose(-1, -2),
                      out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = prod(a.transpose(-1, -2), g,
                      out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def _reshape_d(t: torch.Tensor, shape) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    src, dst = reshape_placements(t, shape)
    if src != list(t.placements):
        t = t.redistribute(t.device_mesh, src)
    local = t.to_local()
    parts = [1] * len(shape)
    for m, p in enumerate(dst):
        if p.is_shard():
            parts[p.dim] *= t.device_mesh.size(m)
    out = local.reshape(*(n // k for n, k in zip(shape, parts)))
    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    return DTensor.from_local(out, t.device_mesh, dst, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


class _DReshape(torch.autograd.Function):
    """A DTensor reshape on local shards whose backward reshapes the
    gradient by the same rule (the gradient may arrive split where the
    forward was not)."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _reshape_d(t, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_d(g, ctx.shape), None


def reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``.  A DTensor reshapes each rank's shard
    (``sharding.reshape_placements``): a split that the new shape keeps
    whole stays, one that it cuts where the split does not fall (8 kv
    heads of a dim split 16 ways) is gathered first on its mesh dims; its
    gradient likewise."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(n for j, n in enumerate(shape) if j != i)
        shape = shape[:i] + (t.numel() // rest,) + shape[i + 1:]
    return _DReshape.apply(t, tuple(shape))


def pad_seq(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """``t`` [B, S, ...] padded with zeros along dim 1.  A DTensor pads on
    each rank's shard (``local_map``; activations never split their
    sequence dim), so no DTensor padding strategy is involved."""
    pad = [0, 0] * (t.dim() - 2) + [before, after]
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, pad)
    pl = whole(t.placements)
    return on_shards(lambda x: torch.nn.functional.pad(x, pad), pl, (pl,),
                     t.device_mesh)(t)


def _mesh_matmul(a2: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``a2 [M, K] @ b [K, N]`` of DTensors, on local shards: the
    activation keeps its layout and the weight moves.  On each mesh dim:
    rows split -> the weight whole there (an FSDP gather), the output's
    rows split; the weight's columns split -> the output's columns split;
    the contraction split (either operand) -> both split along it and a
    partial sum, reduced at once (a row-parallel all-reduce).  A partial
    activation is reduced first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = a2.device_mesh
    ap, bp, out, ga, gb, partial = [], [], [], [], [], False
    for x, w in zip(whole(a2.placements), b.placements):
        if x == Shard(0):
            ap.append(x), bp.append(Replicate()), out.append(x)
            ga.append(x), gb.append(Partial())
        elif x == Shard(1) or w == Shard(0):
            ap.append(Shard(1)), bp.append(Shard(0)), out.append(Partial())
            ga.append(Shard(1)), gb.append(Shard(0))
            partial = True
        elif w == Shard(1):
            ap.append(Replicate()), bp.append(w), out.append(w)
            ga.append(Partial()), gb.append(w)
        else:
            ap.append(Replicate()), bp.append(Replicate())
            out.append(Replicate()), ga.append(Replicate())
            gb.append(Replicate())
    y = on_shards(lambda x, w: _local_matmul(x, w, out_dtype), out,
                  (ap, bp), dm, grads=(ga, gb))(a2, b)
    return y.redistribute(dm, whole(y.placements)) if partial else y


def _local_matmul(a2: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    if _in_fp32(a2, b):
        return (a2.float() @ b.float()).to(out_dtype)
    if out_dtype == torch.float32:
        return _F32Product.apply(a2, b)
    return (a2 @ b).to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """``a [..., K] @ b [K, N] -> [..., N]`` in ``out_dtype``, fp32
    accumulation (``preferred_element_type=float32`` and a cast).  On
    DTensors the product runs on local shards (``_mesh_matmul``)."""
    lead = a.shape[:-1]
    a2 = reshape(a, -1, a.shape[-1])
    if is_dtensor(a2) and is_dtensor(b):
        return reshape(_mesh_matmul(a2, b, out_dtype), *lead, b.shape[-1])
    return _local_matmul(a2, b, out_dtype).reshape(*lead, b.shape[-1])


def bmatmul(a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Batched ``a [E, M, K] @ b [E, K, N]`` with ``matmul``'s rule."""
    if _in_fp32(a, b):
        return torch.bmm(a.float(), b.float()).to(out_dtype)
    if out_dtype == torch.float32:
        return _F32Product.apply(a, b)
    return torch.bmm(a, b).to(out_dtype)


def contract(x: torch.Tensor, w: torch.Tensor, n: int,
             out_dtype: torch.dtype) -> torch.Tensor:
    """Contract the last ``n`` dims of ``x`` with the first ``n`` of ``w``
    (``"bsd,dhk->bshk"`` is ``n=1``, ``"bshk,hkd->bsd"`` is ``n=2``)."""
    k = math.prod(w.shape[:n])
    out = matmul(reshape(x, *x.shape[:x.dim() - n], k),
                 reshape(w, k, -1), out_dtype)
    return reshape(out, *x.shape[:x.dim() - n], *w.shape[n:])


# ---------------------------------------------------------------------------
# ParamBuilder — one description, three materializations
# ---------------------------------------------------------------------------

class ParamBuilder:
    """mode in {"init", "abstract", "axes"}.

    ``init`` draws from ``generator`` (a seeded ``torch.Generator``) on
    the generator's device; ``abstract`` gives tensors on the ``meta``
    device; ``axes`` gives the logical-axis tuples.
    """

    def __init__(self, mode: str, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16):
        assert mode in ("init", "abstract", "axes")
        if mode == "init" and generator is None:
            raise ValueError("init mode draws from a torch.Generator")
        self.mode = mode
        self.generator = generator
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
              init: str = "normal", scale: float = 1.0,
              dtype: Optional[torch.dtype] = None):
        assert len(shape) == len(axes), (shape, axes)
        dtype = dtype or self.dtype
        shape = tuple(int(s) for s in shape)
        if self.mode == "axes":
            return axes
        if self.mode == "abstract":
            return torch.empty(shape, dtype=dtype, device="meta")
        dev = self.generator.device
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale / math.sqrt(max(fan_in, 1))
        return (torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=dev)
                .mul_(std).to(dtype))


# ---------------------------------------------------------------------------
# Norms / rotary
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [*(B,) S] -> (cos, sin) each [..., S, head_dim/2] fp32."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, D/2] broadcast over heads."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Flash attention (chunked online softmax) — O(S·chunk) memory
# ---------------------------------------------------------------------------

def _gqa(t: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, H, S, D] fp32, each kv head repeated ``rep``
    times (``jnp.repeat(t, rep, axis=2)``)."""
    return t.float().repeat_interleave(rep, dim=2).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,Hkv,D] (GQA broadcast). Returns [B,Sq,H,D].

    Online softmax over KV chunks inside a loop over Q chunks, with the
    reference's chunk boundaries (so the same running max / sum updates);
    a short last chunk stands for the reference's zero padding, whose
    masked entries add exact zeros.  ``q_offset`` positions the query
    block for causal masking (prefill continuation).
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kg, vg = _gqa(k, rep), v.repeat_interleave(rep, dim=2).transpose(1, 2)
    qh = q.float().transpose(1, 2)                           # [B,H,Sq,D]
    out = []
    for q0 in range(0, Sq, q_chunk):
        qb = qh[:, :, q0:q0 + q_chunk]
        nq = qb.shape[2]
        qpos = q_offset + torch.arange(q0, q0 + nq, device=dev)
        # the running state laid out as the chunk is (a DTensor on a mesh)
        m = torch.full_like(qb[..., 0], -1e30)
        l = torch.zeros_like(qb[..., 0])
        o = torch.zeros_like(qb)
        for k0 in range(0, Skv, kv_chunk):
            kb = kg[:, :, k0:k0 + kv_chunk]
            vb = vg[:, :, k0:k0 + kv_chunk]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale  # [B,H,q,k]
            if causal:
                kpos = torch.arange(k0, k0 + kb.shape[2], device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s,
                                torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).float(), vb.float())
            o = o * corr[..., None] + pv
            m = m_new
        norm = torch.clamp(l, min=1e-30)[..., None]
        out.append((o / norm).transpose(1, 2).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """``flash_attention``; on DTensors, on each rank's local shards
    (``local_map``): batch rows as q's, q's heads split over the tensor-
    parallel mesh dim where they divide, k / v whole there.  Each rank
    takes the kv head of each of its query heads (GQA) by index, so the
    backward's kv gradient is a partial sum over the head-split dim."""
    if not is_dtensor(q):
        return flash_attention(q, k, v, causal=causal)
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    rep = H // Hkv
    qp, kvp, kvg, split = [], [], [], None
    for m, pl in enumerate(q.placements):
        if pl == Shard(0):
            qp.append(pl), kvp.append(pl), kvg.append(pl)
        elif split is None and H % dm.size(m) == 0 and dm.size(m) > 1:
            split = m
            qp.append(Shard(2)), kvp.append(Replicate())
            kvg.append(Partial())
        else:
            qp.append(Replicate()), kvp.append(Replicate())
            kvg.append(Replicate())

    def local(ql, kl, vl):
        if split is not None:
            n = ql.shape[2]
            heads = dm.get_local_rank(split) * n + torch.arange(
                n, device=ql.device)
            idx = torch.div(heads, rep, rounding_mode="floor")
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return flash_attention(ql, kl, vl, causal=causal)

    return on_shards(local, qp, (qp, kvp, kvp), dm,
                     grads=(qp, kvg, kvg))(q, k, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """Single-position attention vs a cache.

    q [B,1,H,D]; caches [B,Smax,Hkv,D]; ``length`` [] or [B] — number of
    valid cache slots.  fp32 softmax; GQA broadcast.
    """
    B, Smax, Hkv, D = k_cache.shape
    rep = q.shape[2] // Hkv
    kg = _gqa(k_cache, rep)                                  # [B,H,Smax,D]
    s = torch.matmul(q.float().transpose(1, 2), kg.transpose(-1, -2)) \
        / math.sqrt(D)                                       # [B,H,1,Smax]
    pos = torch.arange(Smax, device=q.device)
    valid = pos[None, :] < torch.as_tensor(length, device=q.device
                                           ).reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    vg = v_cache.repeat_interleave(rep, dim=2).transpose(1, 2)
    o = torch.matmul(p.to(v_cache.dtype).float(), vg.float())
    return o.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (GQA + rotary), train/prefill + decode-with-cache
# ---------------------------------------------------------------------------

def build_attention(pb: ParamBuilder, d_model: int, n_heads: int,
                    n_kv_heads: int, head_dim: int) -> PyTree:
    return {
        "wq": pb.param((d_model, n_heads, head_dim),
                       ("embed", "heads", "head_dim")),
        "wk": pb.param((d_model, n_kv_heads, head_dim),
                       ("embed", "kv_heads", "head_dim")),
        "wv": pb.param((d_model, n_kv_heads, head_dim),
                       ("embed", "kv_heads", "head_dim")),
        "wo": pb.param((n_heads, head_dim, d_model),
                       ("heads", "head_dim", "embed")),
    }


def qkv(p: PyTree, x: torch.Tensor, src: Optional[torch.Tensor] = None):
    """The three head projections ``"bsd,dhk->bshk"`` in ``x.dtype``; k and
    v from ``src`` (cross-attention) when given."""
    src = x if src is None else src
    return (contract(x, p["wq"], 1, x.dtype),
            contract(src, p["wk"], 1, x.dtype),
            contract(src, p["wv"], 1, x.dtype))


def attention_fwd(p: PyTree, x: torch.Tensor, positions: torch.Tensor, *,
                  causal: bool = True,
                  kv_override: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Full-sequence attention (training / prefill).

    ``kv_override`` (encoder output) switches this into cross-attention.
    Rotary runs at the default theta, as the reference's does.
    """
    q, k, v = qkv(p, x, kv_override)
    if kv_override is None:                    # rotary only for self-attn
        cos, sin = rotary_embedding(positions, q.shape[-1])
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    o = attend(q, k, v, causal=causal and kv_override is None)
    return contract(o, p["wo"], 2, x.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``cache`` [B,Smax,...] with ``new`` [B,1,...] at each row's ``slot``
    (a one-hot select, as the reference's: a slot past ``Smax`` writes
    nothing); into ``out`` when given."""
    Smax = cache.shape[1]
    onehot = (torch.arange(Smax, device=cache.device)[None, :]
              == slot.reshape(-1, 1))
    onehot = onehot.reshape(*onehot.shape, *([1] * (cache.dim() - 2)))
    new = new.to(cache.dtype)
    if out is None:
        return torch.where(onehot, new, cache)
    return torch.where(onehot, new, cache, out=out)


def attention_decode(p: PyTree, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], position: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. cache = {"k": [B,Smax,Hkv,D], "v": ...,
    "len": [B]}."""
    q, k, v = qkv(p, x)
    pos = position.reshape(-1)
    cos, sin = rotary_embedding(pos[:, None], q.shape[-1])
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    slot = cache["len"].reshape(-1)
    k_cache = cache_write(cache["k"], k, slot)
    v_cache = cache_write(cache["v"], v, slot)
    new_len = cache["len"] + 1
    o = decode_attention(q, k_cache, v_cache, new_len)
    out = contract(o, p["wo"], 2, x.dtype)
    return out, {"k": k_cache, "v": v_cache, "len": new_len}


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and embedding
# ---------------------------------------------------------------------------

def build_mlp(pb: ParamBuilder, d_model: int, d_ff: int) -> PyTree:
    return {
        "w_gate": pb.param((d_model, d_ff), ("embed", "ffn")),
        "w_up": pb.param((d_model, d_ff), ("embed", "ffn")),
        "w_down": pb.param((d_ff, d_model), ("ffn", "embed")),
    }


def mlp_fwd(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    g = matmul(x, p["w_gate"], torch.float32)
    u = matmul(x, p["w_up"], torch.float32)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return matmul(h, p["w_down"], x.dtype)


def build_embedding(pb: ParamBuilder, vocab: int, d_model: int) -> PyTree:
    return {"table": pb.param((vocab, d_model), ("vocab", "embed"),
                              scale=1.0)}


def embed_fwd(p: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``.  A DTensor table gathers on each
    rank's shards (``local_map``): a rank whose vocab slice holds a token
    gives its row, the others zeros, summed over the vocab split (a
    partial sum; no gather of the table); a split of the embed dim (FSDP)
    is gathered first."""
    table = p["table"]
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = table.device_mesh
    tok, tab, grad, out, split = [], [], [], [], None
    for m, tp in enumerate(tokens.placements):
        if table.placements[m] == Shard(0) and split is None:
            split = m
            tok.append(Replicate()), tab.append(Shard(0))
            grad.append(Shard(0)), out.append(Partial())
        elif tp == Shard(0):
            tok.append(tp), tab.append(Replicate())
            grad.append(Partial()), out.append(tp)
        else:
            tok.append(Replicate()), tab.append(Replicate())
            grad.append(Replicate()), out.append(Replicate())

    def local(tb, tk):
        n = tb.shape[0]
        off = 0 if split is None else dm.get_local_rank(split) * n
        idx = tk.long() - off
        inside = ((idx >= 0) & (idx < n))[..., None]
        rows = tb[idx.clamp(0, n - 1)]
        return torch.where(inside, rows, torch.zeros_like(rows))

    return on_shards(local, out, (tab, tok), dm,
                     grads=(grad, tok))(table, tokens)


def unembed_fwd(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in fp32 (loss stability)."""
    return matmul(x, p["table"].t(), torch.float32)
