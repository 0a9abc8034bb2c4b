"""Unified model stack for all assigned architectures (port of
``repro.models.transformer``).

A model is a repeating **super-block pattern**: ``pattern_len`` consecutive
layers whose shapes repeat ``reps = n_layers / pattern_len`` times.  Each
pattern position has a mixer (attention / mamba / rwkv6) and an FFN (dense
MLP / MoE).  Params for each position are stacked along a leading "layers"
axis ``[reps, ...]``, as the reference's are, so that params carry across
as arrays of the same shape; the reference's ``lax.scan`` over the stack
is a loop over the rep index ``r`` here.

Families:
* dense   — pattern [attention + MLP]
* moe     — pattern [attention + MoE]
* ssm     — pattern [rwkv6 + MLP]
* hybrid  — Jamba: pattern of 8 = 7×mamba + 1×attention, MoE every 2nd layer
* vlm     — dense + patch-embedding stub prepended to the token sequence
* audio   — whisper: bidirectional encoder stack + decoder with cross-attn

Training takes ``torch.autograd.grad`` of ``loss_fn`` (``train.step``).
``ModelConfig.remat`` is honoured while grad is enabled, as the
reference's ``jax.checkpoint`` around each rep of the scan: ``"none"``
saves everything, ``"full"`` recomputes each rep's body in the backward
pass, and ``"dots"`` (``dots_with_no_batch_dims_saveable``) saves the
outputs of the 2-D weight products and recomputes the rest, the batched
products (attention, the MoE experts) included. The stacked params are
split into reps once a forward (``torch.unbind``), so each leaf gets one
stacked gradient. ``forward``, ``loss_fn``, ``prefill``, ``decode_step``
and the block body take the reference's sharding context ``cs``
(``parallel.sharding.make_constraint_fn``) at the reference's call
sites: on a mesh with a ``device_mesh`` the params and inputs are
DTensors and ``cs`` lays the activations out by the policy; with
``cs=None`` nothing changes. ``decode_step`` takes ``decode_attn_fn``.
Its quirks are kept: ``forward`` runs rotary at the default theta
(``layers.attention_fwd``), while ``prefill`` and ``decode_step`` use
``rope_theta``; decode's MoE runs at capacity factor 8.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.skiplist import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.parallel.sharding import is_dtensor, on_shards, whole

PyTree = Any


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    moe_experts: int = 0
    moe_top_k: int = 0
    pattern_len: int = 1
    attn_positions: Tuple[int, ...] = (0,)
    moe_positions: Tuple[int, ...] = ()
    mixer: str = "attention"        # mixer for non-attention positions
    enc_layers: int = 0             # whisper encoder depth
    n_extra_embeds: int = 0         # vlm patches / audio frames (stub frontend)
    rope_theta: float = 10000.0
    capacity_factor: float = 1.25
    remat: str = "dots"             # "none" | "dots" | "full" (training)
    sub_quadratic: bool = False     # True -> eligible for long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        assert self.n_layers % self.pattern_len == 0

    @property
    def reps(self) -> int:
        return self.n_layers // self.pattern_len

    def position_kind(self, pos: int) -> Tuple[str, str]:
        mixer = "attention" if pos in self.attn_positions else self.mixer
        ffn = "moe" if (self.moe_experts and
                        (pos in self.moe_positions or not self.moe_positions)
                        ) else "mlp"
        return mixer, ffn

    def pattern(self) -> List[Tuple[str, str]]:
        return [self.position_kind(i) for i in range(self.pattern_len)]

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS = 6·N·D accounting)."""
        return sum(t.numel() for t in leaves(abstract_params(self)))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of experts)."""
        if not self.moe_experts:
            return self.param_count()
        total = self.param_count()
        # subtract inactive expert fraction of stacked expert weights
        inactive = 0
        for blk in abstract_params(self)["blocks"]:
            ffn = blk.get("ffn", {})
            if "w_gate" in ffn and ffn["w_gate"].dim() == 4:   # [reps,E,d,f]
                e = ffn["w_gate"].shape[1]
                frac = 1.0 - self.moe_top_k / e
                for k in ("w_gate", "w_up", "w_down"):
                    inactive += int(frac * math.prod(ffn[k].shape))
        return total - inactive


def leaves(tree: PyTree) -> List[Any]:
    """The leaves of a tree of dicts and lists, in key order (a tuple, as
    the logical axes are, is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _at(tree: PyTree, r: int) -> PyTree:
    """Rep ``r`` of a tree of stacked ``[reps, ...]`` tensors."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_at(v, r) for v in tree]
    return tree[r]


def _unbind(tree: PyTree) -> List[PyTree]:
    """Every rep of a tree of stacked ``[reps, ...]`` tensors, split once
    (``torch.unbind``: one stacked gradient a leaf, where ``_at`` per rep
    would give each rep's gradient the size of the whole stack)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v) for k, v in tree.items()}
        reps = len(next(iter(per.values())))
        return [{k: v[r] for k, v in per.items()} for r in range(reps)]
    if isinstance(tree, list):
        per = [_unbind(v) for v in tree]
        return [[v[r] for v in per] for r in range(len(per[0]))]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# Param construction (init / abstract / logical-axes from one description)
# ---------------------------------------------------------------------------

class _Stacked:
    """Prepends the stacked-layer dim to every param of a block."""

    def __init__(self, pb: L.ParamBuilder, reps: int):
        self.pb = pb
        self.reps = reps

    def param(self, shape, axes, **kw):
        return self.pb.param((self.reps,) + tuple(shape),
                             ("layers",) + tuple(axes), **kw)


def _build_block(spb, cfg: ModelConfig, mixer: str, ffn: str) -> PyTree:
    blk: Dict[str, PyTree] = {
        "ln1": spb.param((cfg.d_model,), ("embed",), init="ones",
                         dtype=torch.float32),
        "ln2": spb.param((cfg.d_model,), ("embed",), init="ones",
                         dtype=torch.float32),
    }
    if mixer == "attention":
        blk["mixer"] = L.build_attention(spb, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim)
    elif mixer == "mamba":
        blk["mixer"] = M.build_mamba(spb, cfg.d_model)
    elif mixer == "rwkv6":
        blk["mixer"] = R.build_rwkv6(spb, cfg.d_model)
    else:
        raise ValueError(mixer)
    if ffn == "moe":
        blk["ffn"] = MOE.build_moe(spb, cfg.d_model, cfg.d_ff,
                                   cfg.moe_experts)
    else:
        blk["ffn"] = L.build_mlp(spb, cfg.d_model, cfg.d_ff)
    return blk


def _build_params(cfg: ModelConfig, pb: L.ParamBuilder) -> PyTree:
    spb = _Stacked(pb, cfg.reps)
    params: Dict[str, PyTree] = {
        "embed": L.build_embedding(pb, cfg.vocab, cfg.d_model),
        "final_ln": pb.param((cfg.d_model,), ("embed",), init="ones",
                             dtype=torch.float32),
        "blocks": [_build_block(spb, cfg, mx, ff) for mx, ff in cfg.pattern()],
    }
    if cfg.family in ("vlm", "audio"):
        params["frontend"] = {
            "proj": pb.param((cfg.d_model, cfg.d_model), ("embed", "embed")),
        }
    if cfg.family == "audio":
        epb = _Stacked(pb, cfg.enc_layers)
        params["encoder"] = {
            "blocks": [_build_block(epb, cfg, "attention", "mlp")],
            "final_ln": pb.param((cfg.d_model,), ("embed",), init="ones",
                                 dtype=torch.float32),
        }
        cpb = _Stacked(pb, cfg.reps)
        params["cross"] = {
            "ln": cpb.param((cfg.d_model,), ("embed",), init="ones",
                            dtype=torch.float32),
            "attn": L.build_attention(cpb, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim),
        }
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator) -> PyTree:
    """Random params drawn from ``generator``, on its device."""
    return _build_params(cfg, L.ParamBuilder("init", generator))


def abstract_params(cfg: ModelConfig) -> PyTree:
    """Params as ``meta``-device tensors: shapes and dtypes, no storage."""
    return _build_params(cfg, L.ParamBuilder("abstract"))


def param_logical_axes(cfg: ModelConfig) -> PyTree:
    return _build_params(cfg, L.ParamBuilder("axes"))


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _apply_mixer(kind: str, p: PyTree, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool) -> torch.Tensor:
    if kind == "attention":
        return L.attention_fwd(p, x, positions, causal=causal)
    if kind == "mamba":
        return M.mamba_fwd(p, x)
    if kind == "rwkv6":
        return R.rwkv6_fwd(p, x)
    raise ValueError(kind)


def _ffn(cfg: ModelConfig, ffn: str, p: PyTree, h: torch.Tensor,
         capacity_factor: float, cs=None):
    """(y, aux) of a position's FFN."""
    if ffn == "moe":
        return MOE.moe_fwd(p, h, top_k=cfg.moe_top_k,
                           capacity_factor=capacity_factor, cs=cs)
    return L.mlp_fwd(p, h), 0.0


def _block_body(cfg: ModelConfig, pattern, carry, block_params, positions,
                causal=True, cs=None):
    x, aux = carry
    for (mixer, ffn), p in zip(pattern, block_params):
        h = L.rms_norm(x, p["ln1"])
        x = x + _apply_mixer(mixer, p["mixer"], h, positions, causal)
        h = L.rms_norm(x, p["ln2"])
        y, a = _ffn(cfg, ffn, p["ffn"], h, cfg.capacity_factor, cs)
        aux = aux + a
        x = x + y
        if cs is not None:
            x = cs(x, "btd")
    return x, aux


# The ops whose outputs "dots" saves: the 2-D products (the weight
# products; ``layers._F32Product`` runs ``mm.dtype``).  Batched products
# (``bmm``, einsum over batch dims) are recomputed, as the reference's
# ``dots_with_no_batch_dims_saveable`` keeps only dots without batch dims.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body):
    """``body`` under ``cfg.remat`` (the reference's ``_remat_policy``:
    ``"none"``, ``"full"``, anything else ``"dots"``), only while grad is
    enabled."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    if cfg.remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    return functools.partial(
        checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots))


def _run_stack(cfg: ModelConfig, blocks: Sequence[PyTree], x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               pattern=None, cross: Optional[PyTree] = None,
               enc_out: Optional[torch.Tensor] = None, cs=None):
    """Run the stacked super-blocks, rep by rep. Returns (x, aux_loss)."""
    pattern = pattern or cfg.pattern()

    def body(x, aux, block_params, cross_p):
        x, aux = _block_body(cfg, pattern, (x, aux), block_params,
                             positions, causal, cs)
        if cross_p is not None:                       # whisper cross-attn
            h = L.rms_norm(x, cross_p["ln"])
            x = x + L.attention_fwd(cross_p["attn"], h, positions,
                                    kv_override=enc_out)
        return x, aux

    step = _remat(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    reps = _unbind(list(blocks))
    crosses = _unbind(cross) if cross is not None else [None] * len(reps)
    for block_params, cross_p in zip(reps, crosses):
        x, aux = step(x, aux, block_params, cross_p)
    return x, aux


def _frontend(params: PyTree, extra: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The stub frontend's projection ``"bpd,de->bpe"``."""
    return L.matmul(extra.to(dtype), params["frontend"]["proj"], dtype)


def _encode(cfg: ModelConfig, params: PyTree, f: torch.Tensor, cs=None
            ) -> torch.Tensor:
    """Whisper's bidirectional encoder over projected frames ``f``."""
    fpos = torch.arange(f.shape[1], device=f.device)[None]
    enc_out, _ = _run_stack(cfg, params["encoder"]["blocks"], f, fpos,
                            causal=False, pattern=[("attention", "mlp")],
                            cs=cs)
    return L.rms_norm(enc_out, params["encoder"]["final_ln"])


def forward(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None, cs=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens [B,S] -> (logits [B,S,V] fp32, aux_loss).

    ``extra_embeds`` [B,P,d] (vlm patches / audio stub frames) are prepended
    (vlm) or encoded + cross-attended (audio).
    """
    x = L.embed_fwd(params["embed"], tokens)
    enc_out = None
    n_prefix = 0
    if cfg.family == "vlm":
        assert extra_embeds is not None
        img = _frontend(params, extra_embeds, x.dtype)
        x = torch.cat([img, x], dim=1)
        n_prefix = img.shape[1]
    elif cfg.family == "audio":
        assert extra_embeds is not None
        enc_out = _encode(cfg, params,
                          _frontend(params, extra_embeds, x.dtype), cs)

    positions = torch.arange(x.shape[1], device=x.device)[None]
    if cs is not None:
        x = cs(x, "btd")
    x, aux = _run_stack(cfg, params["blocks"], x, positions,
                        cross=params.get("cross"), enc_out=enc_out, cs=cs)
    x = L.rms_norm(x, params["final_ln"])
    if n_prefix:
        x = x[:, n_prefix:]
    logits = L.unembed_fwd(params["embed"], x)
    if cs is not None:
        logits = cs(logits, "btv")
    return logits, aux


def loss_fn(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            labels: torch.Tensor, extra_embeds: Optional[torch.Tensor] = None,
            cs=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy + z-loss + MoE aux: ``(total, parts)``,
    differentiable in ``params`` (``train.step`` takes its gradient)."""
    logits, aux = forward(cfg, params, tokens, extra_embeds, cs=cs)
    logits = logits.float()
    lse = _pinned(_logsumexp(logits))
    gold = _pinned(_gold(logits, labels))
    ce = torch.mean(lse - gold)
    z_loss = 1e-4 * torch.mean(lse ** 2)
    moe_loss = 1e-2 * aux / max(cfg.n_layers, 1)
    total = ce + z_loss + moe_loss
    return total, {"ce": ce, "z": z_loss, "moe": moe_loss}


class _Pin(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward
    value was (a scalar loss's gradient arrives whole on every rank; laid
    out by the batch split at once, the vocab-split logits' backward never
    gathers)."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a partial sum made whole first) whose gradient comes back
    laid out as ``t`` is."""
    if not is_dtensor(t):
        return t
    return _Pin.apply(t.redistribute(t.device_mesh, whole(t.placements)))


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the vocab.  On a DTensor split along the
    vocab every op on the [B, S, V] logits runs on local shards
    (``local_map``): each rank's max
    and sum of exponentials over its vocab slice, combined by two
    all-reduces of [B, S] (the max, as a constant shift, carries no
    gradient) rather than by gathering the logits."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    vdim = logits.dim() - 1
    if not is_dtensor(logits) or Shard(vdim) not in logits.placements:
        return torch.logsumexp(logits, dim=-1)     # the vocab whole
    dm, pl = logits.device_mesh, list(logits.placements)

    def reduced(op):
        return [Partial(op) if p_ == Shard(vdim) else p_ for p_ in pl]

    rest = [Replicate() if p_ == Shard(vdim) else p_ for p_ in pl]
    m = on_shards(lambda lg: lg.detach().amax(dim=-1), (reduced("max"),),
                  (pl,), dm)(logits)
    m = m.redistribute(dm, rest)
    se = on_shards(lambda lg, mm: torch.exp(lg - mm[..., None]).sum(dim=-1),
                   (reduced("sum"),), (pl, rest), dm)(logits, m)
    return torch.log(se.redistribute(dm, rest)) + m


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  A DTensor whose vocab dim is split takes
    each rank's labels in its slice and sums over the slices (a partial
    sum, as ``aten.embedding``'s strategy does for a vocab-split table)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm, vdim = logits.device_mesh, logits.dim() - 1
    lab, out, split = [], [], None
    for m, pl in enumerate(logits.placements):
        if pl == Shard(vdim):
            split = m
            lab.append(Replicate()), out.append(Partial())
        elif isinstance(pl, Shard):
            lab.append(pl), out.append(pl)
        else:
            lab.append(Replicate()), out.append(Replicate())

    def local(lg, lb):
        n = lg.shape[-1]
        off = 0 if split is None else dm.get_local_rank(split) * n
        idx = lb.long() - off
        inside = (idx >= 0) & (idx < n)
        g = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))

    return on_shards(local, out, (list(logits.placements), lab),
                     dm)(logits, labels)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, params_or_abstract: PyTree, batch: int,
               max_len: int, abstract: bool = False,
               dtype: torch.dtype = torch.bfloat16, device=None) -> PyTree:
    """Per-pattern-position stacked caches (tree mirrors params["blocks"]).

    ``device`` follows the package rule (``None``: the GPU); ``abstract``
    gives ``meta`` tensors.
    """
    dev = torch.device("meta") if abstract else resolve_device(device)

    def mk(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    caches = []
    for mixer, _ in cfg.pattern():
        if mixer == "attention":
            c = {"k": mk((cfg.reps, batch, max_len, cfg.n_kv_heads,
                          cfg.head_dim), dtype),
                 "v": mk((cfg.reps, batch, max_len, cfg.n_kv_heads,
                          cfg.head_dim), dtype),
                 "len": mk((cfg.reps, batch), torch.int32)}
        elif mixer == "mamba":
            d_inner = 2 * cfg.d_model
            c = {"h": mk((cfg.reps, batch, d_inner, M.D_STATE),
                         torch.float32),
                 "conv": mk((cfg.reps, batch, M.D_CONV - 1, d_inner), dtype)}
        else:  # rwkv6
            H = cfg.d_model // R.HEAD_DIM
            c = {"shift": mk((cfg.reps, batch, 1, cfg.d_model), dtype),
                 "wkv": mk((cfg.reps, batch, H, R.HEAD_DIM, R.HEAD_DIM),
                           torch.float32)}
        caches.append(c)
    out = {"blocks": caches, "pos": mk((batch,), torch.int32)}
    if cfg.family == "audio":
        out["enc_out"] = mk((batch, cfg.n_extra_embeds, cfg.d_model), dtype)
    return out


def _empty_like_blocks(blocks: List[PyTree]) -> List[PyTree]:
    return [{k: torch.empty_like(v) for k, v in c.items()} for c in blocks]


def _rotary_qk(cfg: ModelConfig, p: PyTree, h: torch.Tensor,
               positions: torch.Tensor):
    """Head projections with rotary at ``rope_theta``."""
    q, k, v = L.qkv(p, h)
    cos, sin = L.rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    return L.apply_rotary(q, cos, sin), L.apply_rotary(k, cos, sin), v


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree,
                tokens: torch.Tensor, cs=None, decode_attn_fn=None
                ) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode. tokens [B,1] -> (logits [B,V] fp32, new cache).

    ``decode_attn_fn`` overrides the attention-vs-cache primitive (the
    sequence-sharded ``parallel.decode_attn`` plugs in here).

    The input cache is left as it is; the new one is written into fresh
    tensors of the same shapes.
    """
    x = L.embed_fwd(params["embed"], tokens)
    if cs is not None:
        x = cs(x, "b1d")
    position = cache["pos"]
    enc_out = cache.get("enc_out")
    attn_fn = decode_attn_fn or L.decode_attention
    pattern = cfg.pattern()
    new_blocks = _empty_like_blocks(cache["blocks"])
    for r in range(cfg.reps):
        for idx, (mixer, ffn) in enumerate(pattern):
            p = _at(params["blocks"][idx], r)
            cc = _at(cache["blocks"][idx], r)
            nc = _at(new_blocks[idx], r)
            h = L.rms_norm(x, p["ln1"])
            if mixer == "attention":
                q, k, v = _rotary_qk(cfg, p["mixer"], h, position[:, None])
                L.cache_write(cc["k"], k, cc["len"], out=nc["k"])
                L.cache_write(cc["v"], v, cc["len"], out=nc["v"])
                torch.add(cc["len"], 1, out=nc["len"])
                o = attn_fn(q, nc["k"], nc["v"], nc["len"])
                mx = L.contract(o, p["mixer"]["wo"], 2, h.dtype)
            else:
                step = M.mamba_decode if mixer == "mamba" else R.rwkv6_decode
                mx, out = step(p["mixer"], h, cc)
                for key, t in out.items():
                    nc[key].copy_(t)
            x = x + mx
            h = L.rms_norm(x, p["ln2"])
            y, _ = _ffn(cfg, ffn, p["ffn"], h, 8.0, cs)
            x = x + y
        if cfg.family == "audio":
            cp = _at(params["cross"], r)
            h = L.rms_norm(x, cp["ln"])
            x = x + L.attention_fwd(cp["attn"], h, position[:, None],
                                    kv_override=enc_out)

    x = L.rms_norm(x, params["final_ln"])
    logits = L.unembed_fwd(params["embed"], x)[:, 0]
    new_cache = dict(cache)
    new_cache["blocks"] = new_blocks
    new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            max_len: int, extra_embeds: Optional[torch.Tensor] = None,
            cs=None) -> Tuple[torch.Tensor, PyTree]:
    """Process a prompt, build the decode cache, return last-token logits.

    Attention K/V for the prompt are recomputed per layer and written into
    the cache (padded to ``max_len``); SSM/RWKV states come from the scan.
    """
    B = tokens.shape[0]
    x = L.embed_fwd(params["embed"], tokens)
    enc_out = None
    if cfg.family == "vlm":
        x = torch.cat([_frontend(params, extra_embeds, x.dtype), x], dim=1)
    elif cfg.family == "audio":
        enc_out = _encode(cfg, params,
                          _frontend(params, extra_embeds, x.dtype), cs)

    St = x.shape[1]
    if St > max_len:
        raise ValueError(f"prompt of {St} positions exceeds max_len "
                         f"{max_len}")
    positions = torch.arange(St, device=x.device)[None]
    if cs is not None:
        x = cs(x, "btd")
    pattern = cfg.pattern()
    if getattr(cs, "device_mesh", None) is not None:
        cache = cs.zeros_cache(init_cache(cfg, params, B, max_len,
                                          abstract=True, dtype=x.dtype))
    else:
        cache = init_cache(cfg, params, B, max_len, dtype=x.dtype,
                           device=x.device)
    for r in range(cfg.reps):
        for idx, (mixer, ffn) in enumerate(pattern):
            p = _at(params["blocks"][idx], r)
            nc = _at(cache["blocks"][idx], r)
            h = L.rms_norm(x, p["ln1"])
            if mixer == "attention":
                q, k, v = _rotary_qk(cfg, p["mixer"], h, positions)
                o = L.attend(q, k, v, causal=True)
                mx = L.contract(o, p["mixer"]["wo"], 2, h.dtype)
                _fill_prompt(nc["k"], k)
                _fill_prompt(nc["v"], v)
                nc["len"].fill_(St)
            else:
                fill = _mamba_prefill if mixer == "mamba" else _rwkv_prefill
                mx, out = fill(p["mixer"], h)
                for key, t in out.items():
                    nc[key].copy_(t)
            x = x + mx
            h = L.rms_norm(x, p["ln2"])
            y, _ = _ffn(cfg, ffn, p["ffn"], h, cfg.capacity_factor, cs)
            x = x + y
            if cs is not None:
                x = cs(x, "btd")
        if cfg.family == "audio":
            cp = _at(params["cross"], r)
            h = L.rms_norm(x, cp["ln"])
            x = x + L.attention_fwd(cp["attn"], h, positions,
                                    kv_override=enc_out)

    x = L.rms_norm(x, params["final_ln"])
    logits = L.unembed_fwd(params["embed"], x[:, -1:])[:, 0]
    cache["pos"].fill_(St)
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return logits, cache


def _fill_prompt(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, :S] = src`` (a rep's cache [B, max_len, ...], the prompt's
    [B, S, ...]).  A DTensor cache sharded along its sequence dim takes
    the prompt padded to ``max_len`` whole, each rank its own slots."""
    S = src.shape[1]
    if is_dtensor(dst):
        dst.copy_(L.pad_seq(src.to(dst.dtype), 0, dst.shape[1] - S))
    else:
        dst[:, :S] = src


def _mamba_prefill(p, x):
    """mamba_fwd and the terminal state for the cache: the state from the
    same recurrence, and the conv tail from the input before the conv."""
    y, hT, u = M._mamba(p, x)
    return y, {"h": hT, "conv": u[:, -(M.D_CONV - 1):, :]}


def _rwkv_prefill(p, x):
    """rwkv6_fwd and the final wkv state and token shift for the cache."""
    y, ST = R._rwkv6(p, x)
    return y, {"shift": x[:, -1:, :], "wkv": ST}
