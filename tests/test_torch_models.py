"""The port's model stack and configs (``repro_torch.models.transformer``,
``repro_torch.configs``) against repro's, on the CPU.

Per ``ARCH_ID`` (each smoke config): the reference's params, carried
across bit for bit, run ``forward``, ``prefill`` (a 48-slot cache) and 4
``decode_step``s in both packages on the same tokens (each decode feeds
both packages the reference's argmax), with the reference's bf16 params
here and with fp32 params (the same ``ParamBuilder`` at ``dtype=float32``) in
``tests/test_torch_models_fp32.py``.  The reference runs once per module
(``ref_runs``), jitted: its eager calls compile each ``lax.scan`` anew,
the jitted ones once a shape, and give the same numbers.

Tolerances, as a fraction of the reference logits' max abs:

* fp32, every arch (``tests/test_torch_models_fp32.py``): ``FP32_TOL =
  1e-3``.  Measured gaps are 2e-6 to 1.2e-4 (whisper's decode), fp32
  steps amplified by the depth.
* bf16, the attention-and-MLP archs (dense, moe, vlm): ``BF16_TOL = 0.05``.
  One layer's output is within two bf16 steps (2^-7) of the reference's
  (``tests/test_torch_layers.py``); the two layers, the residual stream
  and the 64-wide unembedding take the measured gap to 0.011-0.022.
* bf16, ``rwkv6_3b``, ``jamba_15_large_398b``, ``whisper_tiny``:
  ``CHAOTIC_TOL = 0.75``, looser than 5%, for this reason: at smoke size
  these three (a decay recurrence, a selective scan, an encoder feeding
  cross-attention at random init) amplify a last-bit difference to a
  third of the logits.  The reference itself moves by 0.34, 0.64 and 0.73
  (of max abs 2.7, 2.2, 2.0) when half its embedding table moves by one
  bf16 step; the port's gaps are 0.90, 1.45 and 0.84.
  ``test_bf16_gap_of_the_recurrent_archs_is_the_references_own`` measures
  that response in each run and holds the port's gap to 3x it, and the
  fp32 runs hold the same code paths to 1e-3.

Also: ``test_decode_consistent_with_forward``'s three archs on the port;
``init_params`` / ``abstract_params`` / ``param_logical_axes`` trees; the
full configs (values, ``param_count``, ``active_param_count``, ``cells``,
``ALIASES``, ``SHAPES``) of all ten; the param and cache converters.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tcf
from repro_torch.convert import (flat_items, cache_from_numpy, cache_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.models import transformer as TT
from test_torch_layers import carry, to_numpy, to_torch

FP32_TOL = 1e-3
BF16_TOL = 0.05
CHAOTIC_TOL = 0.75
CHAOTIC = ("rwkv6_3b", "jamba_15_large_398b", "whisper_tiny")
B, S, MAX_LEN, DECODES = 2, 16, 48, 4


def tol(arch: str, dtype: str) -> float:
    if dtype == "float32":
        return FP32_TOL
    return CHAOTIC_TOL if arch in CHAOTIC else BF16_TOL


def _hybrid_nomoe(ModelConfig):
    return ModelConfig(
        name="hybrid_nomoe", family="hybrid", n_layers=4, pattern_len=4,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
        mixer="mamba", attn_positions=(2,), remat="none",
        sub_quadratic=True)


def _ref_params(cfg, dtype: str, seed: int = 0):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as L
    from repro.models import transformer as T
    return T._build_params(cfg, L.ParamBuilder(
        "init", jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype)))


def _inputs(cfg, dtype: str):
    """Seeded tokens [B,S] and extra embeds (vlm / audio), as numpy."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = None
    if cfg.family in ("vlm", "audio"):
        extra = rng.standard_normal((B, cfg.n_extra_embeds, cfg.d_model)
                                    ).astype(np.float32)
    return toks, extra


@functools.lru_cache(maxsize=None)
def _jitted():
    import jax

    from repro.models import transformer as T
    return (jax.jit(T.forward, static_argnums=(0,)),
            jax.jit(T.prefill, static_argnums=(0, 3)),
            jax.jit(T.decode_step, static_argnums=(0,)))


def _run_ref(arch: str, dtype: str) -> dict:
    import jax.numpy as jnp

    from repro.configs import get_smoke
    cfg = get_smoke(arch)
    fwd, pre, dec = _jitted()
    params = _ref_params(cfg, dtype)
    toks, extra = _inputs(cfg, dtype)
    ex = None if extra is None else jnp.asarray(extra).astype(
        getattr(jnp, dtype))
    logits, aux = fwd(cfg, params, jnp.asarray(toks), ex)
    out = {"params": params, "toks": toks,
           "extra": None if ex is None else np.asarray(ex),
           "forward": np.asarray(logits), "aux": float(aux)}
    lg, cache = pre(cfg, params, jnp.asarray(toks), MAX_LEN, ex)
    out["prefill"] = np.asarray(lg)
    out["prefill_cache"] = {k: np.asarray(v) for k, v in flat_items(cache)}
    steps, fed = [], []
    for _ in range(DECODES):
        nxt = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
        lg, cache = dec(cfg, params, cache, jnp.asarray(nxt))
        fed.append(nxt)
        steps.append(np.asarray(lg))
    out["decode"], out["fed"] = steps, fed
    out["cache"] = {k: np.asarray(v) for k, v in flat_items(cache)}
    return out


@pytest.fixture(scope="module")
def ref_runs():
    return {a: _run_ref(a, "bfloat16") for a in tcf.ARCH_IDS}


def _bf16():
    import ml_dtypes
    return ml_dtypes.bfloat16


def _gap(port, ref) -> float:
    p, r = to_numpy(port), to_numpy(ref)
    assert p.shape == r.shape and np.isfinite(p).all()
    return float(np.abs(p - r).max())


def check_against_reference(arch: str, dtype: str, ref: dict) -> None:
    """The port's forward, prefill, decode steps and caches on ``ref``'s
    params and tokens, held to ``ref`` (one of ``_run_ref``'s runs)."""
    cfg = tcf.get_smoke(arch)
    params = carry(ref["params"])
    extra = None if ref["extra"] is None else to_torch(ref["extra"])
    toks = torch.from_numpy(ref["toks"])
    bound = tol(arch, dtype) * float(np.abs(ref["forward"]).max())

    logits, aux = TT.forward(cfg, params, toks, extra)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.vocab)
    assert _gap(logits, ref["forward"]) <= bound
    assert abs(float(aux) - ref["aux"]) <= 1e-2 * max(1.0, abs(ref["aux"]))

    lg, cache = TT.prefill(cfg, params, toks, MAX_LEN, extra_embeds=extra)
    assert _gap(lg, ref["prefill"]) <= bound
    got = cache_to_numpy(cache, bf16=_bf16())
    assert got.keys() == ref["prefill_cache"].keys()
    for k, v in ref["prefill_cache"].items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if v.dtype.kind in "iu":
            assert np.array_equal(got[k], v), k
    for nxt, want in zip(ref["fed"], ref["decode"]):
        lg, cache = TT.decode_step(cfg, params, cache, torch.from_numpy(nxt))
        assert lg.shape == (B, cfg.vocab)
        assert _gap(lg, want) <= bound
    got = cache_to_numpy(cache, bf16=_bf16())
    for k, v in ref["cache"].items():
        assert got[k].dtype == v.dtype, k
        if v.dtype.kind in "iu":                      # len, pos: exact
            assert np.array_equal(got[k], v), k
        elif dtype == "float32":
            scale = max(float(np.abs(v).max()), 1e-6)
            assert _gap(torch.from_numpy(got[k]), v) <= FP32_TOL * scale, k


@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_forward_prefill_decode_match_reference(arch, ref_runs):
    check_against_reference(arch, "bfloat16", ref_runs[arch])


@pytest.mark.parametrize("arch", CHAOTIC)
def test_bf16_gap_of_the_recurrent_archs_is_the_references_own(arch,
                                                               ref_runs):
    """The reference's forward moves, when half its embedding table moves
    by one bf16 step, by at least a third of the port's gap from it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke
    ref = ref_runs[arch]
    cfg = get_smoke(arch)
    params = dict(ref["params"])
    tab = params["embed"]["table"]
    half = jax.random.bernoulli(jax.random.PRNGKey(7), 0.5, tab.shape)
    params["embed"] = {"table": jnp.where(
        half, jnp.nextafter(tab, jnp.full_like(tab, jnp.inf)), tab)}
    extra = None if ref["extra"] is None else jnp.asarray(ref["extra"])
    nudged, _ = _jitted()[0](cfg, params, jnp.asarray(ref["toks"]), extra)
    own = _gap(np.array(nudged), ref["forward"])
    logits, _ = TT.forward(tcf.get_smoke(arch), carry(ref["params"]),
                           torch.from_numpy(ref["toks"]),
                           None if extra is None else to_torch(extra))
    assert _gap(logits, ref["forward"]) <= 3 * own


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b", "hybrid_nomoe"])
def test_decode_consistent_with_forward(arch):
    """Twin of ``tests/test_models.py::test_decode_consistent_with_forward``
    on the port: the same params and tokens (the reference's, carried
    across), its tolerances (rtol 0.08, atol 0.15)."""
    import jax

    from repro.configs import get_smoke
    from repro.models import transformer as T
    if arch == "hybrid_nomoe":
        cfg, tcfg = _hybrid_nomoe(T.ModelConfig), _hybrid_nomoe(TT.ModelConfig)
    else:
        cfg, tcfg = get_smoke(arch), tcf.get_smoke(arch)
    key = jax.random.PRNGKey(0)
    params = carry(T.init_params(cfg, key))
    toks = to_torch(jax.random.randint(key, (2, 12), 0, cfg.vocab))
    full_logits, _ = TT.forward(tcfg, params, toks)
    _, cache = TT.prefill(tcfg, params, toks[:, :11], max_len=16)
    step_logits, _ = TT.decode_step(tcfg, params, cache, toks[:, 11:12])
    np.testing.assert_allclose(step_logits.numpy(),
                               full_logits[:, -1].numpy(), rtol=0.08,
                               atol=0.15)


def test_forward_runs_rotary_at_the_default_theta_like_repro():
    """The reference's ``forward`` ignores ``rope_theta`` (``attention_fwd``
    takes none) while ``prefill`` uses it: at llama3_8b's 5e5, prefill's
    last logits leave ``forward``'s.  The port keeps both."""
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.models import transformer as T
    cfg = dataclasses.replace(get_smoke("llama3_8b"), rope_theta=5e5)
    tcfg = dataclasses.replace(tcf.get_smoke("llama3_8b"), rope_theta=5e5)
    params = _ref_params(cfg, "float32")
    toks, _ = _inputs(cfg, "float32")
    fwd, pre, _ = _jitted()
    ref_f, _ = fwd(cfg, params, jnp.asarray(toks), None)
    ref_p, _ = pre(cfg, params, jnp.asarray(toks), 32, None)
    tp = carry(params)
    got_f, _ = TT.forward(tcfg, tp, torch.from_numpy(toks))
    got_p, _ = TT.prefill(tcfg, tp, torch.from_numpy(toks), 32)
    scale = float(np.abs(np.asarray(ref_f)).max())
    assert _gap(got_f, ref_f) <= FP32_TOL * scale
    assert _gap(got_p, ref_p) <= FP32_TOL * scale
    assert _gap(got_p, np.asarray(ref_f)[:, -1]) > 10 * FP32_TOL * scale


# ---------------------------------------------------------------------------
# Param trees and configs
# ---------------------------------------------------------------------------

def _spec(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat_items(tree)}


@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_init_params_gives_the_reference_tree(arch):
    import jax

    from repro.configs import get_smoke
    from repro.models import transformer as T
    ref = T.init_params(get_smoke(arch), jax.random.PRNGKey(0))
    port = TT.init_params(tcf.get_smoke(arch),
                          torch.Generator().manual_seed(0))
    assert _spec(port) == _spec(ref)
    # the same keys in the same order
    assert list(dict(flat_items(port))) == list(dict(flat_items(ref)))
    assert TT.param_logical_axes(tcf.get_smoke(arch)) == \
        T.param_logical_axes(get_smoke(arch))


def test_abstract_params_of_the_full_configs_match_reference():
    """All ten full configs on the meta device: nothing allocated."""
    from repro.configs import get_config
    from repro.models import transformer as T
    for arch in tcf.ARCH_IDS:
        port = TT.abstract_params(tcf.get_config(arch))
        assert all(t.device.type == "meta" for _, t in flat_items(port))
        assert _spec(port) == _spec(T.abstract_params(get_config(arch))), \
            arch
        cache = TT.init_cache(tcf.get_config(arch), port, 2, 64,
                              abstract=True)
        ref_cache = T.init_cache(get_config(arch), None, 2, 64,
                                 abstract=True)
        assert _spec(cache) == _spec(ref_cache), arch


def test_configs_equal_the_reference():
    import repro.configs as rcf
    assert tcf.ARCH_IDS == rcf.ARCH_IDS
    assert tcf.ALIASES == rcf.ALIASES
    assert {k: dataclasses.astuple(v) for k, v in tcf.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in rcf.SHAPES.items()}
    assert tcf.all_cells() == rcf.all_cells()
    for arch in tcf.ARCH_IDS + list(tcf.ALIASES):
        for get in ("get_config", "get_smoke"):
            port, ref = getattr(tcf, get)(arch), getattr(rcf, get)(arch)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.pattern() == ref.pattern()
        assert [n for n, _ in tcf.cells(arch)] == \
            [n for n, _ in rcf.cells(arch)]


@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    import repro.configs as rcf
    port, ref = tcf.get_config(arch), rcf.get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_full_configs_match_assignment():
    """Twin of ``tests/test_models.py``'s four config cases."""
    expect = {
        "phi35_moe_42b": (32, 4096, 32, 8, 6400, 32064),
        "granite_moe_1b": (24, 1024, 16, 8, 512, 49155),
        "rwkv6_3b": (32, 2560, None, None, 8960, 65536),
        "llava_next_34b": (60, 7168, 56, 8, 20480, 64000),
        "jamba_15_large_398b": (72, 8192, 64, 8, 24576, 65536),
        "stablelm_12b": (40, 5120, 32, 8, 13824, 100352),
        "llama3_8b": (32, 4096, 32, 8, 14336, 128256),
        "deepseek_coder_33b": (62, 7168, 56, 8, 19200, 32256),
        "yi_34b": (60, 7168, 56, 8, 20480, 64000),
        "whisper_tiny": (4, 384, 6, 6, 1536, 51865),
    }
    for arch, (nl, d, H, kv, ff, V) in expect.items():
        cfg = tcf.get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
            (nl, d, ff, V)
        if H is not None:
            assert (cfg.n_heads, cfg.n_kv_heads) == (H, kv)
    assert (tcf.get_config("granite_moe_1b").moe_experts,
            tcf.get_config("granite_moe_1b").moe_top_k) == (32, 8)
    pat = tcf.get_config("jamba_15_large_398b").pattern()
    assert [m for m, _ in pat].count("attention") == 1
    assert [f for _, f in pat].count("moe") == 4
    approx = {"llama3_8b": 8.0e9, "yi_34b": 34.4e9,
              "deepseek_coder_33b": 33.3e9, "jamba_15_large_398b": 398e9,
              "phi35_moe_42b": 41.9e9}
    for arch, n in approx.items():
        assert abs(tcf.get_config(arch).param_count() - n) / n < 0.22


def test_converters_round_trip_bit_for_bit():
    import ml_dtypes
    cfg = tcf.get_smoke("jamba_15_large_398b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(3))
    flat = params_to_numpy(params)
    back = params_from_numpy(flat, device="cpu")
    for (k, a), (k2, b) in zip(flat_items(params), flat_items(back)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    as_bf16 = params_to_numpy(params, bf16=ml_dtypes.bfloat16)
    assert as_bf16["embed.table"].dtype == ml_dtypes.bfloat16
    assert torch.equal(params_from_numpy(as_bf16, "cpu")["embed"]["table"],
                       params["embed"]["table"])
    _, cache = TT.prefill(cfg, params, torch.zeros((1, 5), dtype=torch.int32),
                          8)
    back = cache_from_numpy(cache_to_numpy(cache), device="cpu")
    for (k, a), (_, b) in zip(flat_items(cache), flat_items(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 4
