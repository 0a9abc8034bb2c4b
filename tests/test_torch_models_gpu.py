"""The port's model plane and serving engine on the card, held against the
port's CPU run.

Each smoke config's params are drawn on the CPU from a seeded generator
and carried to the card; ``forward``, ``prefill`` and 4 ``decode_step``s
run on both devices (the card fed the CPU's tokens) and must agree within
``tests/test_torch_models.py``'s tolerances.  ``moe._dispatch_group``'s
routing integers must be equal on equal fp32 inputs (TF32 stays off);
decode must agree with forward on the card; the smoke engine must give
the CPU engine's tokens.  Needs a CUDA card and no JAX; every test here is
marked ``gpu`` and skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_models_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as tcf
from repro_torch.convert import flat_items
from repro_torch.launch import serve as lserve
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import EngineConfig
from test_torch_models import MAX_LEN, _hybrid_nomoe, tol

pytestmark = pytest.mark.gpu


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
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _params(cfg, dtype, seed=0):
    return TT._build_params(cfg, TL.ParamBuilder(
        "init", torch.Generator().manual_seed(seed),
        dtype=getattr(torch, dtype)))


def _frac(got, want) -> float:
    g, w = got.float().cpu(), want.float().cpu()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_smoke_arch_on_the_card_matches_the_cpu(arch, dtype, cuda):
    cfg = tcf.get_smoke(arch)
    params = _params(cfg, dtype)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    extra = None
    if cfg.family in ("vlm", "audio"):
        extra = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_extra_embeds, cfg.d_model)).astype(np.float32)).to(
                getattr(torch, dtype))
    runs = {}
    for dev in ("cpu", cuda):
        p, t, e = _to(params, dev), toks.to(dev), _to(extra, dev)
        logits, _ = TT.forward(cfg, p, t, e)
        lg, cache = TT.prefill(cfg, p, t, MAX_LEN, extra_embeds=e)
        outs = [logits, lg]
        for i in range(4):
            nxt = (torch.argmax(lg, -1)[:, None].to(torch.int32)
                   if dev == "cpu" else runs["cpu"]["fed"][i].to(dev))
            lg, cache = TT.decode_step(cfg, p, cache, nxt)
            outs.append(lg)
            runs.setdefault(str(dev), {"fed": []})["fed"].append(nxt.cpu())
        runs[str(dev)].update(outs=outs, cache=cache)
    gaps = [_frac(g, c) for g, c in zip(runs["cuda"]["outs"],
                                        runs["cpu"]["outs"])]
    assert max(gaps) <= tol(arch, dtype), gaps
    for (k, g), (_, c) in zip(flat_items(runs["cuda"]["cache"]),
                              flat_items(runs["cpu"]["cache"])):
        assert g.dtype == c.dtype and g.shape == c.shape, k
        if not g.is_floating_point():
            assert torch.equal(g.cpu(), c), k


@pytest.mark.parametrize("T,K,E,tied", [(64, 2, 8, False),
                                        (600, 2, 8, False),
                                        (256, 8, 32, False),
                                        (256, 3, 7, True)])
def test_dispatch_routing_on_the_card_equals_the_cpu(T, K, E, tied, cuda):
    rng = np.random.default_rng(T + K)
    xt = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((64, E)).astype(np.float32))
    if tied:                                        # experts 3, 4, 6 tie
        router[:, 4] = router[:, 3]
        router[:, 6] = router[:, 3]
    runs = [TMOE._dispatch_group(xt.to(d), router.to(d), K, 128, E)
            for d in ("cpu", cuda)]
    (cbuf, cinfo, _), (gbuf, ginfo, _) = runs
    for name, c, g in zip(("tok_s", "gate_s", "slot", "keep"), cinfo, ginfo):
        if name != "gate_s":
            assert torch.equal(g.cpu(), c), name
    assert torch.equal(gbuf.cpu(), cbuf)


@pytest.mark.parametrize("arch,dtype", [("llama3_8b", "bfloat16"),
                                        ("rwkv6_3b", "bfloat16"),
                                        ("hybrid_nomoe", "float32")])
def test_decode_consistent_with_forward_on_the_card(arch, dtype, cuda):
    """The hybrid in fp32: the reference's Mamba forward convolves in bf16
    and its decode in fp32, a gap past this tolerance at most draws."""
    cfg = (_hybrid_nomoe(TT.ModelConfig) if arch == "hybrid_nomoe"
           else tcf.get_smoke(arch))
    params = _to(_params(cfg, dtype), cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)).to(cuda)
    full, _ = TT.forward(cfg, params, toks)
    _, cache = TT.prefill(cfg, params, toks[:, :11], max_len=16)
    step, _ = TT.decode_step(cfg, params, cache, toks[:, 11:12])
    np.testing.assert_allclose(step.cpu().numpy(),
                               full[:, -1].cpu().numpy(), rtol=0.08,
                               atol=0.15)


def test_smoke_engine_on_the_card_equals_the_cpu(cuda):
    cfg = tcf.get_smoke("llama3_8b")
    params = _params(cfg, "bfloat16")
    runs = {}
    for dev in ("cpu", cuda):
        eng = lserve.make_engine(cfg, EngineConfig(batch_slots=4, max_len=64),
                                 device=dev, params=_to(params, dev))
        reqs = lserve.make_requests(cfg.vocab, 8, 12, 8, seed=0)
        lserve.serve(eng, reqs)
        assert all(r.done for r in reqs)
        assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
        assert eng.watchdog.violations == 0
        runs[str(dev)] = (eng, reqs)
    (ceng, creqs), (geng, greqs) = runs["cpu"], runs["cuda"]
    assert ceng.steps == geng.steps
    assert ceng.log.replay_key() == geng.log.replay_key()
    assert [r.out for r in greqs] == [r.out for r in creqs]
