"""Step factories: train / prefill / decode (port of ``repro.train.step``).

Each factory returns ``(fn, shardings, abstracts)`` as the reference's
does: the step function, the spec trees of its inputs under the policy
(``parallel.sharding``) and the abstract inputs (``meta`` tensors).  The
train step takes ``torch.autograd.grad`` of ``models.transformer.loss_fn``
(``ModelConfig.remat`` decides what the backward pass recomputes) and
applies ``optim.adamw.update_``.

On a mesh with a ``device_mesh`` (a process group; any size, 1x1
included) a step places its inputs by their spec trees first (DTensors;
a DTensor already placed otherwise is redistributed, as the reference's
jit reshards to its ``in_shardings``), runs the model under the policy's
constraint function ``cs`` (plain tensors beside DTensors count as
replicated), and returns its outputs laid out as the reference's
``out_shardings``: params and moments by their specs, the cache by its
spec tree, logits ``P(batch, vocab)``; the metrics come back as plain
0-d tensors.  On a mesh without one (``make_host_mesh``) the tensors are
plain and nothing is placed.  The steps run eagerly (no jit); the train
step donates its params and optimizer state as the reference's does,
updating them in place.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel.decode_attn import make_distributed_decode_attn
from repro_torch.parallel.sharding import (P, Policy, is_dtensor,
                                           make_constraint_fn, mesh_size,
                                           place, place_tree)

PyTree = Any


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Input specs (abstract stand-ins)
# ---------------------------------------------------------------------------

def train_input_specs(cfg: T.ModelConfig, global_batch: int, seq_len: int
                      ) -> Dict[str, torch.Tensor]:
    specs = {"tokens": _meta((global_batch, seq_len), torch.int32),
             "labels": _meta((global_batch, seq_len), torch.int32)}
    if cfg.family in ("vlm", "audio"):
        specs["extra"] = _meta((global_batch, cfg.n_extra_embeds,
                                cfg.d_model), torch.bfloat16)
    return specs


def prefill_input_specs(cfg: T.ModelConfig, global_batch: int, seq_len: int
                        ) -> Dict[str, torch.Tensor]:
    specs = {"tokens": _meta((global_batch, seq_len), torch.int32)}
    if cfg.family in ("vlm", "audio"):
        specs["extra"] = _meta((global_batch, cfg.n_extra_embeds,
                                cfg.d_model), torch.bfloat16)
    return specs


def decode_input_specs(cfg: T.ModelConfig, global_batch: int
                       ) -> Dict[str, torch.Tensor]:
    return {"tokens": _meta((global_batch, 1), torch.int32)}


def batch_shardings(cfg: T.ModelConfig, policy: Policy, mesh,
                    global_batch: int, kinds: Dict[str, str]):
    return {k: policy.act_spec(kind, mesh, global_batch)
            for k, kind in kinds.items()}


def _logits_spec(cfg: T.ModelConfig, policy: Policy, mesh,
                 global_batch: int) -> P:
    """[B, vocab] output; vocab shards over TP only when divisible."""
    b = policy.batch_axes(mesh, global_batch)
    v = (policy.tp_axis if cfg.vocab % mesh.shape[policy.tp_axis] == 0
         else None)
    return P(b, v)


def _on_mesh(mesh, what: str):
    """The step's context: plain tensors beside DTensors count as
    replicated where the mesh has a ``device_mesh``.  A mesh of more than
    one device without one cannot hold a step: refused."""
    if getattr(mesh, "device_mesh", None) is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication
    if mesh_size(mesh) != 1:
        raise ValueError(f"{what} on a {mesh_size(mesh)}-device mesh needs "
                         "its device_mesh (an initialised process group)")
    return contextlib.nullcontext


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's value as a plain tensor."""
    return t.full_tensor() if is_dtensor(t) else t


def _batch_kinds(cfg: T.ModelConfig, *names: str) -> Dict[str, str]:
    kinds = {n: "bt" for n in names}
    if cfg.family in ("vlm", "audio"):
        kinds["extra"] = "bpd"
    return kinds


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def loss_and_grads(cfg: T.ModelConfig, params: PyTree,
                   batch: Dict[str, torch.Tensor], cs=None):
    """``(loss, parts, grads)`` of ``loss_fn`` on ``batch`` (``tokens``,
    ``labels``, and ``extra`` for vlm / audio), the grads a tree like
    ``params`` (``torch.autograd.grad``; DTensor grads laid out as their
    params); ``params`` are left as they are."""
    leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    it = iter(leaves)
    diff = adamw.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, parts = T.loss_fn(cfg, diff, batch["tokens"], batch["labels"],
                                batch.get("extra"), cs=cs)
        grads = iter([_like(g, t) for g, t in zip(
            torch.autograd.grad(loss, leaves), leaves)])
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            adamw.tree_map(lambda _: next(grads), params))


def _like(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its param (a partial sum over the
    data-parallel ranks is reduced: the gradient all-reduce or
    reduce-scatter)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def make_train_step(cfg: T.ModelConfig, policy: Policy, mesh,
                    global_batch: int, opt_cfg: adamw.AdamWConfig):
    """Returns ``(fn, (params_shd, opt_shd, batch_shd), (abstract,
    opt_abs))``; ``fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce``, ``z``, ``moe``,
    ``grad_norm`` and ``lr`` (0-d tensors).  ``fn`` donates ``params`` and
    ``opt_state``, as the reference's jit does: their tensors are updated
    in place (``adamw.update_``) and returned.  On a mesh with a
    ``device_mesh`` the inputs are placed first and the params and
    moments come back as DTensors laid out by their specs."""
    ctx = _on_mesh(mesh, "make_train_step")
    cs = make_constraint_fn(policy, mesh, global_batch)
    axes = T.param_logical_axes(cfg)
    abstract = T.abstract_params(cfg)
    params_shd = policy.param_sharding_tree(axes, abstract, mesh)
    opt_abs = adamw.abstract_state(opt_cfg, abstract)
    opt_shd = adamw.AdamWState(
        mu=policy.opt_sharding_tree(axes, abstract, mesh),
        nu=policy.opt_sharding_tree(axes, abstract, mesh), count=P())
    batch_shd = batch_shardings(cfg, policy, mesh, global_batch,
                                _batch_kinds(cfg, "tokens", "labels"))

    def train_step(params, opt_state, batch):
        with ctx():
            params = place_tree(params, params_shd, mesh)
            opt_state = place_tree(opt_state, opt_shd, mesh)
            batch = place_tree(batch, batch_shd, mesh)
            loss, parts, grads = loss_and_grads(cfg, params, batch, cs)
            with torch.no_grad():
                params, opt_state, om = adamw.update_(opt_cfg, grads,
                                                      opt_state, params)
            metrics = {k: _plain(v) for k, v in
                       {"loss": loss, **parts, **om}.items()}
        return params, opt_state, metrics

    return train_step, (params_shd, opt_shd, batch_shd), (abstract, opt_abs)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: T.ModelConfig, policy: Policy, mesh,
                      global_batch: int, seq_len: int, max_len: int):
    """Returns ``(fn, (params_shd, batch_shd, cache_shd), (abstract,
    cache_abs))``; ``fn(params, batch) -> (last logits, cache)``."""
    ctx = _on_mesh(mesh, "make_prefill_step")
    cs = make_constraint_fn(policy, mesh, global_batch)
    if cfg.family == "vlm":
        # image patches are prepended to the sequence: the cache holds them
        max_len = max(max_len, seq_len + cfg.n_extra_embeds)
    axes = T.param_logical_axes(cfg)
    abstract = T.abstract_params(cfg)
    params_shd = policy.param_sharding_tree(axes, abstract, mesh)
    batch_shd = batch_shardings(cfg, policy, mesh, global_batch,
                                _batch_kinds(cfg, "tokens"))
    cache_abs = T.init_cache(cfg, abstract, global_batch, max_len,
                             abstract=True)
    cache_shd = policy.cache_spec_tree(cache_abs, mesh, global_batch)
    logits_shd = _logits_spec(cfg, policy, mesh, global_batch)

    @torch.no_grad()
    def prefill_step(params, batch):
        with ctx():
            params = place_tree(params, params_shd, mesh)
            batch = place_tree(batch, batch_shd, mesh)
            logits, cache = T.prefill(cfg, params, batch["tokens"], max_len,
                                      batch.get("extra"), cs=cs)
            return (place(logits, logits_shd, mesh),
                    place_tree(cache, cache_shd, mesh))

    return prefill_step, (params_shd, batch_shd, cache_shd), (abstract,
                                                               cache_abs)


def make_decode_step(cfg: T.ModelConfig, policy: Policy, mesh,
                     global_batch: int, max_len: int):
    """One-token decode against a KV/state cache of length up to max_len,
    through the sequence-sharded attention (one shard on one device).
    Returns ``(fn, (params_shd, cache_shd, tok_shd), (abstract,
    cache_abs))``; ``fn(params, cache, batch) -> (logits, cache)``."""
    ctx = _on_mesh(mesh, "make_decode_step")
    cs = make_constraint_fn(policy, mesh, global_batch)
    axes = T.param_logical_axes(cfg)
    abstract = T.abstract_params(cfg)
    params_shd = policy.param_sharding_tree(axes, abstract, mesh)
    cache_abs = T.init_cache(cfg, abstract, global_batch, max_len,
                             abstract=True)
    cache_shd = policy.cache_spec_tree(cache_abs, mesh, global_batch)
    tok_shd = {"tokens": policy.act_spec("bt", mesh, global_batch)}
    logits_shd = _logits_spec(cfg, policy, mesh, global_batch)
    dattn = make_distributed_decode_attn(
        mesh, policy.batch_axes(mesh, global_batch),
        policy.cache_seq_axes(mesh, global_batch))

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        with ctx():
            params = place_tree(params, params_shd, mesh)
            cache = place_tree(cache, cache_shd, mesh)
            batch = place_tree(batch, tok_shd, mesh)
            logits, cache = T.decode_step(cfg, params, cache,
                                          batch["tokens"], cs=cs,
                                          decode_attn_fn=dattn)
            return (place(logits, logits_shd, mesh),
                    place_tree(cache, cache_shd, mesh))

    return decode_fn, (params_shd, cache_shd, tok_shd), (abstract, cache_abs)
