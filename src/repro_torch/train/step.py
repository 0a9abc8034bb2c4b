"""Step factories: train / prefill / decode (port of ``repro.train.step``).

Each factory returns ``(fn, shardings, abstracts)`` as the reference's
does: the step function, the spec trees of its inputs under the policy
(``parallel.sharding``) and the abstract inputs (``meta`` tensors).  The
train step takes ``torch.autograd.grad`` of ``models.transformer.loss_fn``
(``ModelConfig.remat`` decides what the backward pass recomputes) and
applies ``optim.adamw.update``.  The port runs a step on one device: on a
mesh of more than one device the factories raise ``NotImplementedError``
(placing params, moments and batches across devices is ROADMAP item
13b).  The steps run eagerly (no jit); the train step donates its params
and optimizer state as the reference's does, updating them in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel.decode_attn import make_distributed_decode_attn
from repro_torch.parallel.sharding import NOT_PORTED, P, Policy, mesh_size

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


def _one_device(mesh, what: str) -> None:
    if mesh_size(mesh) != 1:
        raise NotImplementedError(f"{what} on a {mesh_size(mesh)}-device "
                                  f"mesh: {NOT_PORTED}")


def _batch_kinds(cfg: T.ModelConfig, *names: str) -> Dict[str, str]:
    kinds = {n: "bt" for n in names}
    if cfg.family in ("vlm", "audio"):
        kinds["extra"] = "bpd"
    return kinds


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def loss_and_grads(cfg: T.ModelConfig, params: PyTree,
                   batch: Dict[str, torch.Tensor]):
    """``(loss, parts, grads)`` of ``loss_fn`` on ``batch`` (``tokens``,
    ``labels``, and ``extra`` for vlm / audio), the grads a tree like
    ``params`` (``torch.autograd.grad``); ``params`` are left as they
    are."""
    leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    it = iter(leaves)
    diff = adamw.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, parts = T.loss_fn(cfg, diff, batch["tokens"], batch["labels"],
                                batch.get("extra"))
        grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            adamw.tree_map(lambda _: next(grads), params))


def make_train_step(cfg: T.ModelConfig, policy: Policy, mesh,
                    global_batch: int, opt_cfg: adamw.AdamWConfig):
    """Returns ``(fn, (params_shd, opt_shd, batch_shd), (abstract,
    opt_abs))``; ``fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce``, ``z``, ``moe``,
    ``grad_norm`` and ``lr`` (0-d tensors).  ``fn`` donates ``params`` and
    ``opt_state``, as the reference's jit does: their tensors are updated
    in place (``adamw.update_``) and returned."""
    _one_device(mesh, "make_train_step")
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
        loss, parts, grads = loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            params, opt_state, om = adamw.update_(opt_cfg, grads, opt_state,
                                                  params)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step, (params_shd, opt_shd, batch_shd), (abstract, opt_abs)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: T.ModelConfig, policy: Policy, mesh,
                      global_batch: int, seq_len: int, max_len: int):
    """Returns ``(fn, (params_shd, batch_shd, cache_shd), (abstract,
    cache_abs))``; ``fn(params, batch) -> (last logits, cache)``."""
    _one_device(mesh, "make_prefill_step")
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

    @torch.no_grad()
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch["tokens"], max_len,
                         batch.get("extra"))

    return prefill_step, (params_shd, batch_shd, cache_shd), (abstract,
                                                               cache_abs)


def make_decode_step(cfg: T.ModelConfig, policy: Policy, mesh,
                     global_batch: int, max_len: int):
    """One-token decode against a KV/state cache of length up to max_len,
    through the sequence-sharded attention (one shard on one device).
    Returns ``(fn, (params_shd, cache_shd, tok_shd), (abstract,
    cache_abs))``; ``fn(params, cache, batch) -> (logits, cache)``."""
    _one_device(mesh, "make_decode_step")
    axes = T.param_logical_axes(cfg)
    abstract = T.abstract_params(cfg)
    params_shd = policy.param_sharding_tree(axes, abstract, mesh)
    cache_abs = T.init_cache(cfg, abstract, global_batch, max_len,
                             abstract=True)
    cache_shd = policy.cache_spec_tree(cache_abs, mesh, global_batch)
    tok_shd = {"tokens": policy.act_spec("bt", mesh, global_batch)}
    dattn = make_distributed_decode_attn(
        mesh, policy.batch_axes(mesh, global_batch),
        policy.cache_seq_axes(mesh, global_batch))

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        return T.decode_step(cfg, params, cache, batch["tokens"],
                             decode_attn_fn=dattn)

    return decode_fn, (params_shd, cache_shd, tok_shd), (abstract, cache_abs)
