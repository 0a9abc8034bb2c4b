"""The port's training path on the card, held against the port's CPU run.

* ``layers._F32Product`` (a bf16 product with an fp32 output, the one
  the card runs) against the same transpose rule on fp32 copies: each
  operand's gradient within one bf16 step of the rounded cotangent's
  exact products, and within ``NARROW_TOL`` of the unrounded cotangent's.
* A smoke train step (``train.step.make_train_step``, remat "dots" on the
  card) for one arch of each family, fp32 params drawn on the CPU and
  carried across (TF32 off): loss, parts, ``grad_norm``, ``lr`` and the
  first moment (the gradient) within ``FP32_TOL = 1e-3`` (fraction of
  the value, of each leaf's max abs) or 3x the CPU's own response to a
  one-ulp nudge, the new params within ``2 lr`` (see the test).
* A restart from a step-5 checkpoint gives the uninterrupted run's losses
  and params bit for bit under ``torch.use_deterministic_algorithms``
  (``CUBLAS_WORKSPACE_CONFIG`` set when this module is imported, before
  the first cuBLAS call).

Needs a CUDA card and no JAX; every test here is marked ``gpu`` and skips
without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_train_gpu.py
"""
import dataclasses
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs as tcf  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import flat_items  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, PipelineConfig  # noqa: E402
from repro_torch.data.store import IndexedSampleStore, StoreConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import Policy  # noqa: E402
from repro_torch.train import step as STEP  # noqa: E402

pytestmark = pytest.mark.gpu

FP32_TOL = 1e-3
NARROW_TOL = 0.02
FAMILIES = ("llama3_8b", "granite_moe_1b", "rwkv6_3b", "jamba_15_large_398b",
            "llava_next_34b", "whisper_tiny")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_to(v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _frac(got, want) -> float:
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("shapes", [((96, 64), (64, 48)),
                                    ((3, 40, 64), (3, 64, 24))])
def test_the_autograd_product_follows_the_transpose_rule(cuda, shapes):
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(s, generator=gen).to(torch.bfloat16)
            for s in shapes)
    g = torch.randn((*shapes[0][:-1], shapes[1][-1]), generator=gen)
    ac, bc = (t.to(cuda).requires_grad_(True) for t in (a, b))
    prod = TL.matmul if len(shapes[0]) == 2 else TL.bmatmul
    out = prod(ac, bc, torch.float32)
    assert out.dtype == torch.float32
    assert _frac(out, a.float() @ b.float()) <= 1e-6
    ga, gb = torch.autograd.grad(out, (ac, bc), g.to(cuda))
    assert ga.dtype == gb.dtype == torch.bfloat16
    g16 = g.to(torch.bfloat16).float()
    for got, want in ((ga, g16 @ b.float().transpose(-1, -2)),
                      (gb, a.float().transpose(-1, -2) @ g16)):
        w = want.to(torch.bfloat16).float()
        assert bool(((got.float().cpu() - w).abs()
                     <= 2.0 ** -7 * w.abs() + 1e-6).all())
    assert _frac(ga, g @ b.float().transpose(-1, -2)) <= NARROW_TOL
    assert _frac(gb, a.float().transpose(-1, -2) @ g) <= NARROW_TOL


def _train(cfg, dev, params, opt_cfg, batch):
    fn, _, _ = STEP.make_train_step(cfg, Policy(), make_host_mesh(dev),
                                    batch["tokens"].shape[0], opt_cfg)
    params = adamw.tree_map(lambda t: t.to(dev, copy=True), params)
    return fn(params, adamw.init(opt_cfg, params), _to(batch, dev))


def _nudged(params):
    """Half the elements of every leaf one fp32 step up."""
    gen = torch.Generator().manual_seed(7)
    return adamw.tree_map(lambda t: torch.where(
        torch.rand(t.shape, generator=gen) < 0.5,
        (t.view(torch.int32) + 1).view(torch.float32), t), params)


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_step_card_against_cpu(cuda, arch):
    """The first moment after one step is ``(1 - b1)`` times the clipped
    gradient: each leaf within ``FP32_TOL`` of the CPU's, or 3x the CPU's
    own response to a one-ulp nudge of half its params where that is
    larger (whisper_tiny's gradients move by 1.3e-3 of max abs).  The new
    params move by at most ``lr`` from the normalized step, which flips
    sign with a near-zero gradient entry: within ``2 lr`` plus
    ``FP32_TOL`` of the leaf's max abs."""
    cfg = tcf.get_smoke(arch)
    params = TT._build_params(cfg, TL.ParamBuilder(
        "init", torch.Generator().manual_seed(0), dtype=torch.float32))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("vlm", "audio"):
        batch["extra"] = torch.randn((2, cfg.n_extra_embeds, cfg.d_model),
                                     generator=gen)
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=0)
    cpu_cfg = dataclasses.replace(cfg, remat="none")
    cp, co, cm = _train(cpu_cfg, "cpu", params, opt_cfg, batch)
    _, own_o, _ = _train(cpu_cfg, "cpu", _nudged(params), opt_cfg, batch)
    gp, go, gm = _train(dataclasses.replace(cfg, remat="dots"), cuda, params,
                        opt_cfg, batch)
    own = max(_frac(a, b) for a, b in zip(TT.leaves(own_o.mu),
                                          TT.leaves(co.mu)))
    tol = max(FP32_TOL, 3 * own)
    for k in cm:
        assert abs(float(gm[k]) - float(cm[k])) <= tol * max(
            abs(float(cm[k])), 1e-6), k
    for (k, g), c in zip(flat_items(go.mu), TT.leaves(co.mu)):
        assert g.device.type == "cuda"
        assert _frac(g, c) <= tol, (arch, k, _frac(g, c), tol)
    lr = float(cm["lr"])
    want = dict(flat_items(cp))
    for k, t in flat_items(gp):
        w = want[k]
        assert float((t.cpu() - w).abs().max()) <= 2 * lr + FP32_TOL * float(
            w.abs().max()), (arch, k)
    assert int(go.count) == int(co.count) == 1


def test_restart_bitexact_on_the_card(cuda, tmp_path):
    cfg = tcf.get_smoke("llama3_8b")
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=10,
                                total_steps=200)
    fn, _, (p_abs, o_abs) = STEP.make_train_step(cfg, Policy(),
                                                 make_host_mesh(cuda), 8,
                                                 opt_cfg)
    store = IndexedSampleStore(StoreConfig(n_samples=128, seq_len=64,
                                           vocab=cfg.vocab), device=cuda)
    pipe = DataPipeline(store, PipelineConfig(global_batch=8))

    def batch(step):
        b = pipe.get_batch(step)
        return {"tokens": b["tokens"], "labels": b["labels"]}

    torch.use_deterministic_algorithms(True)
    try:
        params = TT.init_params(cfg, torch.Generator(device=cuda)
                                .manual_seed(0))
        opt = adamw.init(opt_cfg, params)
        for step in range(5):
            params, opt, _ = fn(params, opt, batch(step))
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, {"params": params, "opt": opt})
        losses1 = []
        for step in range(5, 8):
            params, opt, m = fn(params, opt, batch(step))
            losses1.append(float(m["loss"]))
        st = mgr.restore(5, {"params": p_abs, "opt": o_abs}, device=cuda)
        p2, o2 = st["params"], st["opt"]
        losses2 = []
        for step in range(5, 8):
            p2, o2, m = fn(p2, o2, batch(step))
            losses2.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert losses1 == losses2 and np.isfinite(losses1).all()
    for a, b in zip(TT.leaves(params), TT.leaves(p2)):
        assert torch.equal(a, b)
