"""AdamW, functional, with memory-tiering for huge models (port of
``repro.optim.adamw``).

* Moments are stored in configurable dtypes: fp32 by default; a bf16
  first moment for the 398B-class archs (halves the optimizer's memory).
* Gradients arrive in the param dtype (bf16); the update math upcasts to
  fp32, and the global-norm clip runs in fp32.
* The moments' placement is the sharding policy's
  (``parallel.sharding.Policy.opt_sharding_tree``); this module places
  nothing.  On a mesh the leaves are DTensors: the global norm sums each
  rank's shards and all-reduces (the scalars come out replicated), and
  each leaf's update runs on its shards.

The state is a tree of tensors like the params (dicts and lists); the
update runs leaf by leaf in plain torch, with the reference's math:
upcast, clip by the global norm, bias corrections at ``count + 1``,
decoupled weight decay, cast back.  The reference has no kernel here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Tuple

import torch

from repro_torch.parallel.sharding import is_dtensor

PyTree = Any


class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor          # int32, 0-d


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: torch.dtype = torch.float32
    nu_dtype: torch.dtype = torch.float32


def tree_map(fn, *trees: PyTree) -> PyTree:
    """``fn`` over the leaves of trees of one structure (dicts, lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists, in its order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10%; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params: PyTree) -> AdamWState:
    """Zero moments beside ``params`` (on their devices, laid out as they
    are on a mesh) and count 0."""
    mu = tree_map(lambda p: torch.zeros_like(
        p, dtype=cfg.mu_dtype, memory_format=torch.contiguous_format),
        params)
    nu = tree_map(lambda p: torch.zeros_like(
        p, dtype=cfg.nu_dtype, memory_format=torch.contiguous_format),
        params)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=mu, nu=nu,
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_state(cfg: AdamWConfig, abstract_params: PyTree) -> AdamWState:
    """The state's shapes and dtypes as ``meta`` tensors."""
    def meta(dtype):
        return lambda p: torch.empty(p.shape, dtype=dtype, device="meta")
    return AdamWState(mu=tree_map(meta(cfg.mu_dtype), abstract_params),
                      nu=tree_map(meta(cfg.nu_dtype), abstract_params),
                      count=torch.empty((), dtype=torch.int32,
                                        device="meta"))


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor (a partial sum, say) made whole on every rank."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = sum(_replicated(torch.sum(torch.square(l.float())))
             for l in tree_leaves(tree))
    return torch.sqrt(sq)


def _scalars(cfg: AdamWConfig, grads: PyTree, count: torch.Tensor):
    """The step's global norm, clip scale, lr and bias corrections."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, count)
    cf = count.to(torch.float32)
    return gnorm, scale, lr, 1.0 - cfg.b1 ** cf, 1.0 - cfg.b2 ** cf


def _leaf(cfg: AdamWConfig, scale, lr, b1c, b2c, g, m, v, p):
    """One leaf's new (param, mu, nu), in fp32 and cast back."""
    gf = g.float() * scale
    mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
    vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
    del gf
    step = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
    pf = p.float()
    new_p = pf - lr * (step + cfg.weight_decay * pf)
    return new_p.to(p.dtype), mf.to(cfg.mu_dtype), vf.to(cfg.nu_dtype)


def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step: ``(new params, new state, {"grad_norm", "lr"})``.
    The inputs are left as they are: ``update_`` on copies of them."""
    state = AdamWState(tree_map(torch.clone, state.mu),
                       tree_map(torch.clone, state.nu), state.count)
    return update_(cfg, grads, state, tree_map(torch.clone, params))


def update_(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
            params: PyTree) -> Tuple[PyTree, AdamWState, dict]:
    """``update`` in place: each leaf of ``params`` and of the moments is
    overwritten with its new value before the next leaf is computed, so a
    step holds one leaf's temporaries, not a second copy of the state (the
    reference's train step donates its params and state).  Returns
    ``params`` and the state, updated."""
    count = state.count + 1
    gnorm, *sc = _scalars(cfg, grads, count)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        for dst, src in zip((p, m, v), _leaf(cfg, *sc, g, m, v, p)):
            dst.copy_(src)
    metrics = {"grad_norm": gnorm, "lr": sc[1]}
    return params, AdamWState(state.mu, state.nu, count), metrics


def config_for(arch_name: str, total_steps: int = 10000) -> AdamWConfig:
    """Memory-tiered per arch: 398B-class models store mu in bf16."""
    if "jamba" in arch_name:
        return AdamWConfig(total_steps=total_steps, mu_dtype=torch.bfloat16)
    return AdamWConfig(total_steps=total_steps)
