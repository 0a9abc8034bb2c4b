"""The port's gradients of ``loss_fn`` against ``jax.value_and_grad`` of
repro's, on the CPU, for all ten smoke configs: fp32 params here, bf16 in
``tests/test_torch_train_grads_bf16.py`` (a file of its own, so that each
half's reference compiles run on a worker of their own).

The reference's params (``ParamBuilder`` at fp32, and its bf16 params)
are carried across bit for bit; both packages take the gradient of the
same loss on the same seeded tokens (labels the tokens shifted by one).
The reference's ``value_and_grad`` is jitted and runs once per module.

Tolerances, per leaf, as a fraction of the reference gradient's max abs:

* fp32: ``FP32_TOL = 1e-3``, every arch; measured 2.0e-5 (the dense
  archs) to 6.4e-5 (phi35's experts), and 3.6e-4 for whisper's encoder.
* bf16, ``test_torch_models.py``'s tolerances where they hold:
  ``BF16_TOL = 0.05`` for the dense archs (measured 0.023) and
  ``CHAOTIC_TOL = 0.75`` for rwkv6, jamba and whisper (measured 0.13,
  0.33, 0.60).  The MoE and vlm archs are held to ``BF16_GRAD_TOL =
  0.25`` (measured 0.052 granite, 0.085 llava, 0.157 phi35's fp32
  router): a gradient compounds the forward's bf16 roundings with the
  backward's, and a router's gradient moves with every near tie of its
  gates.  The reference is no steadier: when half its embedding table
  moves by one bf16 step, its own gradients move by 0.55-4.5 of a leaf's
  max abs.  The fp32 runs hold the same code paths to 1e-3.
The losses are held to the same tolerances (fraction of the loss).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tcf
from repro_torch.convert import flat_items
from repro_torch.models import transformer as TT
from test_torch_layers import carry
from test_torch_models import (BF16_TOL, CHAOTIC, CHAOTIC_TOL, FP32_TOL,
                               _inputs, _ref_params)
from test_torch_train import one_torch_thread  # noqa: F401

BF16_GRAD_TOL = 0.25


def grad_tol(arch: str, dtype: str) -> float:
    if dtype == "float32":
        return FP32_TOL
    if arch in CHAOTIC:
        return CHAOTIC_TOL
    if tcf.get_smoke(arch).family in ("moe", "vlm"):
        return BF16_GRAD_TOL
    return BF16_TOL


@functools.lru_cache(maxsize=None)
def _value_and_grad(cfg):
    import jax

    from repro.models import transformer as T

    def loss(p, toks, labels, extra):
        return T.loss_fn(cfg, p, toks, labels, extra)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def ref_grads(arch: str, dtype: str) -> dict:
    """The reference's params, tokens, loss, parts and gradients."""
    import jax.numpy as jnp

    from repro.configs import get_smoke
    cfg = get_smoke(arch)
    params = _ref_params(cfg, dtype)
    toks, extra = _inputs(cfg, dtype)
    labels = np.roll(toks, -1, axis=1)
    ex = None if extra is None else jnp.asarray(extra).astype(
        getattr(jnp, dtype))
    (loss, parts), grads = _value_and_grad(cfg)(
        params, jnp.asarray(toks), jnp.asarray(labels), ex)
    return {"params": params, "toks": toks, "labels": labels,
            "extra": None if ex is None else np.asarray(ex, np.float32),
            "loss": float(loss), "parts": {k: float(v)
                                           for k, v in parts.items()},
            "grads": {k: np.asarray(v, np.float32)
                      for k, v in flat_items(grads)},
            "grad_dtypes": {k: str(v.dtype) for k, v in flat_items(grads)}}


def port_grads(arch: str, dtype: str, ref: dict):
    """The port's loss, parts and ``{key: gradient}`` on ``ref``'s
    params and tokens."""
    cfg = tcf.get_smoke(arch)
    params = carry(ref["params"])
    keys = [k for k, _ in flat_items(params)]
    leaves = [t.requires_grad_(True) for t in TT.leaves(params)]
    extra = None if ref["extra"] is None else torch.from_numpy(
        np.array(ref["extra"])).to(getattr(torch, dtype))
    loss, parts = TT.loss_fn(cfg, params, torch.from_numpy(ref["toks"]),
                             torch.from_numpy(ref["labels"]), extra)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in parts.items()}, dict(
        zip(keys, grads))


def check_grads(arch: str, dtype: str, ref: dict) -> None:
    """The port's loss, parts and gradients held to ``ref``'s."""
    tol = grad_tol(arch, dtype)
    loss, parts, grads = port_grads(arch, dtype, ref)
    assert abs(loss - ref["loss"]) <= tol * abs(ref["loss"])
    for k in ("ce", "z", "moe"):
        assert abs(parts[k] - ref["parts"][k]) <= \
            tol * max(abs(ref["parts"][k]), 1e-6), k
    assert grads.keys() == ref["grads"].keys()
    for k, g in grads.items():
        want = ref["grads"][k]
        assert str(g.dtype) == "torch." + ref["grad_dtypes"][k], k
        got = g.float().numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), k
        scale = float(np.abs(want).max())
        assert scale > 0, f"{arch} {k}: no gradient reaches the leaf"
        assert float(np.abs(got - want).max()) <= tol * scale, \
            (arch, dtype, k, float(np.abs(got - want).max()) / scale)


@pytest.fixture(scope="module")
def refs():
    return {a: ref_grads(a, "float32") for a in tcf.ARCH_IDS}


@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_gradients_match_value_and_grad(arch, refs):
    check_grads(arch, "float32", refs[arch])
