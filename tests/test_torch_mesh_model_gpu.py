"""The model plane through DTensor on the card: the step factories on the
1x1 ``DeviceMesh`` of a one-rank NCCL group against the same factories
on the host mesh (plain tensors), at smoke width, bf16 params drawn on
the card, so every weight product is the card's (one cuBLAS call with
fp32 accumulation, ``layers._F32Product`` for an fp32 output).

For llama3_8b, granite_moe_1b (the grouped MoE dispatch under ``cs``)
and jamba_15_large_398b (mamba's recurrence on local shards): a train
step's metrics and first moments (the gradients), a prefill's and two
decode steps' logits and the updated params, each within
``MESH_TOL = 1e-3`` of max abs of the plain path's (the same kernels on
the same shapes; the tolerance allows a reduction to add in another
order).  For the bf16 params that is less than one rounding step of the
leaf's largest entries and less than the step's ``lr``, so an update
left out or of the wrong sign fails.

Needs a CUDA card and no JAX; every test here is marked ``gpu`` and skips
without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_mesh_model_gpu.py
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import configs as tcf  # noqa: E402
from repro_torch.convert import flat_items  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, model_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import place_tree, policy_for  # noqa: E402
from repro_torch.train import step as STEP  # noqa: E402

pytestmark = pytest.mark.gpu

MESH_TOL = 1e-3
ARCHS = ("llama3_8b", "granite_moe_1b", "jamba_15_large_398b")
GB, SEQ, MAX_LEN = 4, 16, 32


@pytest.fixture(scope="module")
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    # the MoE combine's index_add_ and the embedding's backward sum in a
    # fixed order, so the two paths add alike
    torch.use_deterministic_algorithms(True)
    try:
        yield (model_mesh((1, 1), ("data", "model"), "cuda"),
               make_host_mesh("cuda"))
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def _plain(t):
    return t.full_tensor() if hasattr(t, "placements") else t


def _gap(got, want) -> float:
    g, w = _plain(got).float(), _plain(want).float()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)


def _inputs(cfg):
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = TT.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (GB, SEQ + 3), generator=gen,
                         device="cuda", dtype=torch.int32)
    return params, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_1x1_mesh_matches_the_plain_path(meshes, arch):
    cfg = tcf.get_smoke(arch)
    params, toks = _inputs(cfg)
    batch = {"tokens": toks[:, :SEQ], "labels": toks[:, 1:SEQ + 1]}
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=0)
    out = {}
    for name, mesh in zip(("mesh", "plain"), meshes):
        fn, (p_shd, o_shd, _), _ = STEP.make_train_step(
            cfg, policy_for(arch), mesh, GB, opt_cfg)
        p = place_tree(adamw.tree_map(torch.clone, params), p_shd, mesh)
        o = place_tree(adamw.init(opt_cfg, p), o_shd, mesh)
        out[name] = fn(p, o, batch)
    (mp, mo, mm), (pp, po, pm) = out["mesh"], out["plain"]
    assert all(hasattr(v, "placements") for _, v in flat_items(mp))
    for k in pm:
        assert abs(float(mm[k]) - float(pm[k])) <= MESH_TOL * max(
            abs(float(pm[k])), 1e-12), k
    for (k, a), (_, b) in zip(flat_items(mo.mu), flat_items(po.mu)):
        assert _gap(a, b) <= MESH_TOL, k              # the gradients
    for (k, a), (_, b) in zip(flat_items(mp), flat_items(pp)):
        assert _gap(a, b) <= MESH_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_the_1x1_mesh_match_the_plain_path(meshes,
                                                                 arch):
    cfg = tcf.get_smoke(arch)
    params, toks = _inputs(cfg)
    logits = {}
    for name, mesh in zip(("mesh", "plain"), meshes):
        pol = policy_for(arch)
        pre, (p_shd, _, _), _ = STEP.make_prefill_step(cfg, pol, mesh, GB,
                                                       SEQ, MAX_LEN)
        dec, _, _ = STEP.make_decode_step(cfg, pol, mesh, GB, MAX_LEN)
        p = place_tree(params, p_shd, mesh)
        lg, cache = pre(p, {"tokens": toks[:, :SEQ]})
        logits[name] = [lg]
        for i in range(2):
            lg, cache = dec(p, cache, {"tokens": toks[:, SEQ + i:SEQ + i + 1]})
            logits[name].append(lg)
    for a, b in zip(logits["mesh"], logits["plain"]):
        assert hasattr(a, "placements") and _gap(a, b) <= MESH_TOL
