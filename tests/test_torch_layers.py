"""The port's model layers (``repro_torch.models.layers``, ``mamba``,
``rwkv6``, ``moe``) against repro's, on the CPU.

Every function runs on the same inputs in both packages: params built by
the reference's ``ParamBuilder`` (seeded ``jax.random``) and carried
across bit for bit (``convert.params_from_numpy``; bf16 as its bits),
inputs drawn from a seeded numpy generator.  Each layer runs twice, with
fp32 and with bf16 params and inputs.

Tolerances.  The port's products accumulate in fp32 like the reference's
(``preferred_element_type``), so one layer differs only in summation order
and in the last bit of ``exp`` / ``sin`` / ``cos``.  fp32: ``FP32_TOL =
1e-4`` of the output's max abs (2^-24 steps summed over the <= 269 terms
of a product or a scan, with margin).  bf16: ``BF16_TOL = 2^-6`` of the
output's max abs, two bf16 steps (2^-8 each) of the one rounding a layer
output takes plus a flip of its input's last bit.  MoE routing (``eidx``,
``slot``, ``keep``, ``tok_s``) and the embedding gather are integer and
exact.

Then twins of the 11 cases of ``tests/test_layers_math.py`` on the port
alone (flash vs naive, decode attention vs the last row, the sequential
Mamba and RWKV forwards vs their step-by-step decode, rotary, rms_norm),
with that file's tolerances.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.convert import flat_items, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import rwkv6 as TR

FP32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
DTYPES = ("float32", "bfloat16")


# ---------------------------------------------------------------------------
# Carrying arrays between the packages
# ---------------------------------------------------------------------------

def to_torch(a) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor, bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t) -> np.ndarray:
    """A tensor (or a JAX array) as fp32 numpy, for comparison."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def carry(tree) -> dict:
    """The reference's param (or cache) tree as the port's, bit for bit."""
    return params_from_numpy({k: np.asarray(v) for k, v in flat_items(tree)},
                             device="cpu")


def close(port, ref, tol: float, what: str) -> float:
    """Assert max |port - ref| <= tol * max |ref|; returns the gap."""
    p, r = to_numpy(port), to_numpy(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.isfinite(p).all(), what
    gap = float(np.abs(p - r).max()) if p.size else 0.0
    bound = tol * max(float(np.abs(r).max()), 1e-6)
    assert gap <= bound, f"{what}: gap {gap:.3e} > {bound:.3e}"
    return gap


def tol_of(dtype: str) -> float:
    return FP32_TOL if dtype == "float32" else BF16_TOL


def _jnp():
    import jax.numpy as jnp
    return jnp


def jdtype(dtype: str):
    return getattr(_jnp(), dtype)


def randn(seed: int, shape, dtype: str, scale: float = 1.0):
    """Seeded normal inputs: (reference array, port tensor), equal bits."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    ref = _jnp().asarray(a).astype(jdtype(dtype))
    return ref, to_torch(ref)


def ref_pb(dtype: str, seed: int = 0):
    import jax

    from repro.models import layers as L
    return L.ParamBuilder("init", jax.random.PRNGKey(seed),
                          dtype=jdtype(dtype))


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_match_reference(dtype):
    from repro.models import layers as L
    x, tx = randn(0, (2, 8, 32), dtype, 3.0)
    w, tw = randn(1, (32,), "float32")
    b, tb = randn(2, (32,), "float32")
    close(TL.rms_norm(tx, tw), L.rms_norm(x, w), tol_of(dtype), "rms_norm")
    close(TL.layer_norm(tx, tw, tb), L.layer_norm(x, w, b), tol_of(dtype),
          "layer_norm")


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rotary_matches_reference(theta):
    from repro.models import layers as L
    pos = np.arange(24, dtype=np.int32)[None] * 37
    cos, sin = L.rotary_embedding(_jnp().asarray(pos), 16, theta)
    tcos, tsin = TL.rotary_embedding(torch.from_numpy(pos), 16, theta)
    # |cos|, |sin| <= 1 at angles up to 851 rad: a few fp32 steps of it
    close(tcos, cos, 1e-5, "cos")
    close(tsin, sin, 1e-5, "sin")
    for dtype in DTYPES:
        x, tx = randn(3, (1, 24, 2, 16), dtype)
        close(TL.apply_rotary(tx, to_torch(cos), to_torch(sin)),
              L.apply_rotary(x, cos, sin), tol_of(dtype), "apply_rotary")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Skv,qc,kc,q_offset,causal", [
    (40, 40, 16, 32, 0, True), (40, 40, 16, 32, 0, False),
    (8, 40, 512, 512, 32, True), (24, 24, 512, 512, 0, True)])
def test_flash_attention_matches_reference(dtype, Sq, Skv, qc, kc, q_offset,
                                           causal):
    from repro.models import layers as L
    q, tq = randn(0, (2, Sq, 4, 16), dtype)
    k, tk = randn(1, (2, Skv, 2, 16), dtype)                 # GQA 4:2
    v, tv = randn(2, (2, Skv, 2, 16), dtype)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, q_offset=q_offset)
    close(TL.flash_attention(tq, tk, tv, **kw),
          L.flash_attention(q, k, v, **kw), tol_of(dtype), "flash")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_reference(dtype):
    from repro.models import layers as L
    q, tq = randn(0, (3, 1, 4, 16), dtype)
    k, tk = randn(1, (3, 20, 2, 16), dtype)
    v, tv = randn(2, (3, 20, 2, 16), dtype)
    length = np.array([1, 13, 20], np.int32)                 # length mask
    close(TL.decode_attention(tq, tk, tv, torch.from_numpy(length)),
          L.decode_attention(q, k, v, _jnp().asarray(length)),
          tol_of(dtype), "decode_attention")


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_blocks_match_reference(dtype):
    from repro.models import layers as L
    p = L.build_attention(ref_pb(dtype), 64, 4, 2, 16)
    tp = carry(p)
    x, tx = randn(0, (2, 12, 64), dtype)
    enc, tenc = randn(1, (2, 7, 64), dtype)
    pos = np.arange(12)[None]
    close(TL.attention_fwd(tp, tx, torch.from_numpy(pos)),
          L.attention_fwd(p, x, _jnp().asarray(pos)), tol_of(dtype),
          "attention_fwd")
    close(TL.attention_fwd(tp, tx, torch.from_numpy(pos), kv_override=tenc),
          L.attention_fwd(p, x, _jnp().asarray(pos), kv_override=enc),
          tol_of(dtype), "cross attention_fwd")
    kc, tkc = randn(2, (2, 16, 2, 16), dtype)
    vc, tvc = randn(3, (2, 16, 2, 16), dtype)
    ln = np.array([5, 15], np.int32)
    cache = {"k": kc, "v": vc, "len": _jnp().asarray(ln)}
    tcache = {"k": tkc, "v": tvc, "len": torch.from_numpy(ln)}
    x1, tx1 = randn(4, (2, 1, 64), dtype)
    y, c = L.attention_decode(p, x1, cache, _jnp().asarray(ln))
    ty, tc = TL.attention_decode(tp, tx1, tcache, torch.from_numpy(ln))
    close(ty, y, tol_of(dtype), "attention_decode")
    for key in ("k", "v"):
        close(tc[key], c[key], tol_of(dtype), f"attention_decode {key}")
    assert np.array_equal(tc["len"].numpy(), np.asarray(c["len"]))
    assert torch.equal(tcache["k"], tkc)          # input cache unchanged


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_and_embedding_match_reference(dtype):
    from repro.models import layers as L
    pb = ref_pb(dtype)
    p, e = L.build_mlp(pb, 64, 96), L.build_embedding(pb, 256, 64)
    tp, te = carry(p), carry(e)
    x, tx = randn(0, (2, 8, 64), dtype)
    close(TL.mlp_fwd(tp, tx), L.mlp_fwd(p, x), tol_of(dtype), "mlp_fwd")
    toks = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)
    got = TL.embed_fwd(te, torch.from_numpy(toks))
    assert np.array_equal(to_numpy(got),
                          to_numpy(L.embed_fwd(e, _jnp().asarray(toks))))
    close(TL.unembed_fwd(te, tx), L.unembed_fwd(e, x), tol_of(dtype),
          "unembed_fwd")


def _tree_spec(tree):
    """{flat key: (shape, dtype name)} of a tree of arrays or tensors."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat_items(tree)}


def test_build_functions_give_the_reference_trees():
    """Every ``build_*`` gives the reference's names, shapes, dtypes and
    logical axes, in all three ParamBuilder modes."""
    from repro.models import layers as L
    from repro.models import mamba as M
    from repro.models import moe as MOE
    from repro.models import rwkv6 as R
    cases = [("build_attention", (64, 4, 2, 16)), ("build_mlp", (64, 96)),
             ("build_embedding", (256, 64))]
    mods = [(L, TL, n, a) for n, a in cases] + [
        (M, TM, "build_mamba", (32,)), (R, TR, "build_rwkv6", (128,)),
        (MOE, TMOE, "build_moe", (64, 96, 8))]
    gen = torch.Generator().manual_seed(0)
    for ref_mod, port_mod, name, args in mods:
        ref = getattr(ref_mod, name)(ref_pb("bfloat16"), *args)
        port = getattr(port_mod, name)(TL.ParamBuilder("init", gen), *args)
        meta = getattr(port_mod, name)(TL.ParamBuilder("abstract"), *args)
        assert _tree_spec(port) == _tree_spec(ref), name
        assert _tree_spec(meta) == _tree_spec(ref), name
        assert all(t.device.type == "meta" for _, t in flat_items(meta))
        axes = getattr(port_mod, name)(TL.ParamBuilder("axes"), *args)
        ref_axes = getattr(ref_mod, name)(L.ParamBuilder("axes"), *args)
        assert axes == ref_axes, name


# ---------------------------------------------------------------------------
# mamba.py and rwkv6.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_matches_reference(dtype):
    from repro.models import mamba as M
    p = M.build_mamba(ref_pb(dtype), 32)
    tp = carry(p)
    x, tx = randn(0, (2, 40, 32), dtype, 0.3)
    close(TM.mamba_fwd(tp, tx), M.mamba_fwd(p, x), tol_of(dtype),
          "mamba_fwd")
    a, bu, C = M._ssm_inputs(p, x[..., :1].repeat(64, -1))
    ta, tbu, tC = TM._ssm_inputs(tp, tx[..., :1].repeat(1, 1, 64))
    for got, want, what in ((ta, a, "a"), (tbu, bu, "bu"), (tC, C, "C")):
        close(got, want, tol_of(dtype), f"_ssm_inputs {what}")
    cache = M.mamba_init_cache(p, 2, dtype=jdtype(dtype))
    tcache = TM.mamba_init_cache(tp, 2, dtype=getattr(torch, dtype))
    for t in range(3):
        y, cache = M.mamba_decode(p, x[:, t:t + 1], cache)
        ty, tcache = TM.mamba_decode(tp, tx[:, t:t + 1], tcache)
        close(ty, y, tol_of(dtype), f"mamba_decode {t}")
        close(tcache["h"], cache["h"], tol_of(dtype), f"mamba h {t}")
        close(tcache["conv"], cache["conv"], tol_of(dtype), f"conv {t}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_matches_reference(dtype):
    from repro.models import rwkv6 as R
    p = R.build_rwkv6(ref_pb(dtype), 128)
    tp = carry(p)
    x, tx = randn(0, (2, 20, 128), dtype, 0.3)
    close(TR.rwkv6_fwd(tp, tx), R.rwkv6_fwd(p, x), tol_of(dtype),
          "rwkv6_fwd")
    prev, tprev = randn(1, (2, 20, 128), dtype, 0.3)
    got = TR._projections(tp, tx, tprev)
    want = R._projections(p, x, prev)
    for g, w, what in zip(got, want, "rkvgd"):
        close(g, w, tol_of(dtype), f"_projections {what}")
    gn = R._group_norm(want[0], p["ln_w"], p["ln_b"], 2)
    close(TR._group_norm(got[0], tp["ln_w"], tp["ln_b"], 2), gn,
          tol_of(dtype), "_group_norm")
    cache = R.rwkv6_init_cache(p, 2, dtype=jdtype(dtype))
    tcache = TR.rwkv6_init_cache(tp, 2, dtype=getattr(torch, dtype))
    for t in range(3):
        y, cache = R.rwkv6_decode(p, x[:, t:t + 1], cache)
        ty, tcache = TR.rwkv6_decode(tp, tx[:, t:t + 1], tcache)
        close(ty, y, tol_of(dtype), f"rwkv6_decode {t}")
        close(tcache["wkv"], cache["wkv"], tol_of(dtype), f"wkv {t}")
        close(tcache["shift"], cache["shift"], 0.0, f"shift {t}")


# ---------------------------------------------------------------------------
# moe.py: routing is integer and exact
# ---------------------------------------------------------------------------

def _dispatch_both(xt: np.ndarray, router: np.ndarray, K: int, C: int):
    from repro.models import moe as MOE
    jnp = _jnp()
    E = router.shape[1]
    buf, info, aux = MOE._dispatch_group(jnp.asarray(xt),
                                         jnp.asarray(router), K, C, E)
    tbuf, tinfo, taux = TMOE._dispatch_group(torch.from_numpy(xt),
                                             torch.from_numpy(router), K, C,
                                             E)
    return (buf, info, aux), (tbuf, tinfo, taux)


def _assert_same_routing(ref, port):
    (buf, info, aux), (tbuf, tinfo, taux) = ref, port
    for name, r, t in zip(("tok_s", "gate_s", "slot", "keep"), info, tinfo):
        if name == "gate_s":
            close(t, r, FP32_TOL, "gate_s")
        else:
            assert np.array_equal(t.numpy(), np.asarray(r)), name
    assert np.array_equal(to_numpy(tbuf), to_numpy(buf))    # exact gather
    close(taux, aux, FP32_TOL, "aux")


@pytest.mark.parametrize("T,K,E,C", [(64, 2, 8, 128), (300, 4, 8, 128),
                                     (600, 2, 8, 128)])
def test_moe_dispatch_routing_is_exact(T, K, E, C):
    """Random routing, with drops where T*K/E passes C (600 x 2 / 8)."""
    rng = np.random.default_rng(T)
    xt = rng.standard_normal((T, 16)).astype(np.float32)
    router = rng.standard_normal((16, E)).astype(np.float32)
    ref, port = _dispatch_both(xt, router, K, C)
    _assert_same_routing(ref, port)
    if T * K // E > C:
        assert not bool(port[1][3].all())                   # some dropped


def test_moe_dispatch_ties_take_the_lower_expert_first():
    """Router columns that repeat give exactly equal probabilities: the
    top-k takes the lower expert index first, as ``lax.top_k`` does."""
    rng = np.random.default_rng(5)
    xt = rng.standard_normal((40, 16)).astype(np.float32)
    col = rng.standard_normal((16, 1)).astype(np.float32)
    other = rng.standard_normal((16, 2)).astype(np.float32)
    router = np.concatenate([other[:, :1], col, col, other[:, 1:], col, col],
                            axis=1)                      # experts 1,2,4,5 tie
    ref, port = _dispatch_both(xt, router, 3, 128)
    _assert_same_routing(ref, port)
    probs = torch.softmax(torch.from_numpy(xt) @ torch.from_numpy(router), -1)
    assert bool((probs[:, 1] == probs[:, 4]).all())
    _, eidx = TMOE.stable_top_k(probs, 3)
    tied = probs[:, 1] >= probs.max(-1).values       # the tie is the top
    assert bool(tied.any())
    assert np.array_equal(eidx[tied, :3].numpy(),
                          np.tile([1, 2, 4], (int(tied.sum()), 1)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_fwd_matches_reference(dtype):
    from repro.models import moe as MOE
    p = MOE.build_moe(ref_pb(dtype), 32, 64, 8)
    tp = carry(p)
    x, tx = randn(0, (2, 40, 32), dtype)
    for cf in (1.25, 8.0):
        y, aux = MOE.moe_fwd(p, x, top_k=2, capacity_factor=cf)
        ty, taux = TMOE.moe_fwd(tp, tx, top_k=2, capacity_factor=cf)
        close(ty, y, tol_of(dtype), f"moe_fwd cf={cf}")
        close(taux, aux, FP32_TOL, "aux")
    xt = tx.reshape(-1, 32)
    buf, info, _ = TMOE._dispatch_group(xt, tp["router"], 2, 128, 8)
    ye = buf * 2                                          # any expert output
    y = MOE._combine_group(_jnp().asarray(to_numpy(ye)).astype(
        jdtype(dtype)), tuple(_jnp().asarray(t.numpy() if t.dtype !=
                                             torch.bfloat16 else to_numpy(t))
                              for t in info), 80, jdtype(dtype))
    close(TMOE._combine_group(ye, info, 80, getattr(torch, dtype)), y,
          tol_of(dtype), "_combine_group")
    assert TMOE.capacity(80, 2, 8, 1.25) == 128
    assert TMOE.capacity(200, 8, 4, 1.25) == 512          # 501 -> 512


def test_moe_dispatch_conservation():
    """Twin of ``tests/test_models.py::test_moe_dispatch_conservation``:
    gates renormalized, outputs finite at capacity, aux near 1."""
    gen = torch.Generator().manual_seed(0)
    p = TMOE.build_moe(TL.ParamBuilder("init", gen), 32, 64, 8)
    x = torch.randn((2, 16, 32), generator=gen).to(torch.bfloat16)
    y, aux = TMOE.moe_fwd(p, x, top_k=2, capacity_factor=1.0)
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
    assert float(aux) > 0.5
    _, (tok_s, gate_s, slot, keep), _ = TMOE._dispatch_group(
        x.reshape(-1, 32), p["router"], 2, 128, 8)
    sums = torch.zeros(32).index_add_(0, tok_s.long(), gate_s)
    assert torch.allclose(sums, torch.ones(32), atol=1e-6)
    assert bool(keep.all()) and len(set(slot.tolist())) == slot.numel()


# ---------------------------------------------------------------------------
# Twins of tests/test_layers_math.py, on the port alone
# ---------------------------------------------------------------------------

def _naive_attention(q, k, v, causal=True):
    B, Sq, H, D = q.shape
    rep = H // k.shape[2]
    kg = k.repeat_interleave(rep, dim=2).float()
    vg = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg) / math.sqrt(D)
    if causal:
        mask = torch.tril(torch.ones((Sq, k.shape[1]), dtype=torch.bool))
        s = torch.where(mask[None, None], s, torch.tensor(-1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vg)


def _rand(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("Sq,Skv,qc,kc", [
    (64, 64, 16, 16), (40, 40, 16, 32), (128, 128, 512, 512),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_naive(Sq, Skv, qc, kc, causal):
    q = _rand(0, (2, Sq, 4, 16))
    k, v = _rand(1, (2, Skv, 2, 16)), _rand(2, (2, Skv, 2, 16))
    out = TL.flash_attention(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
    ref = _naive_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_decode_attention_matches_naive_last_row():
    S = 24
    q = _rand(0, (2, S, 4, 16))
    k, v = _rand(1, (2, S, 2, 16)), _rand(2, (2, S, 2, 16))
    full = _naive_attention(q, k, v, causal=True)
    pad = torch.zeros((2, 8, 2, 16))
    out = TL.decode_attention(q[:, -1:], torch.cat([k, pad], 1),
                              torch.cat([v, pad], 1), torch.full((2,), S))
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


def _stepwise(decode, p, x, cache):
    outs = []
    for t in range(x.shape[1]):
        o, cache = decode(p, x[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1)


def test_mamba_chunked_scan_matches_sequential():
    gen = torch.Generator().manual_seed(0)
    p = TM.build_mamba(TL.ParamBuilder("init", gen, dtype=torch.float32), 16)
    x = torch.randn((2, TM.CHUNK + 13, 16), generator=gen) * 0.3
    y_seq = _stepwise(TM.mamba_decode, p, x,
                      TM.mamba_init_cache(p, 2, dtype=torch.float32))
    np.testing.assert_allclose(TM.mamba_fwd(p, x).numpy(), y_seq.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_rwkv6_chunked_matches_stepwise():
    gen = torch.Generator().manual_seed(0)
    p = TR.build_rwkv6(TL.ParamBuilder("init", gen, dtype=torch.float32),
                       TR.HEAD_DIM * 2)
    x = torch.randn((2, TR.T_CHUNK + 7, TR.HEAD_DIM * 2), generator=gen) * 0.3
    y_seq = _stepwise(TR.rwkv6_decode, p, x,
                      TR.rwkv6_init_cache(p, 2, dtype=torch.float32))
    np.testing.assert_allclose(TR.rwkv6_fwd(p, x).numpy(), y_seq.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_rotary_orthogonal_and_position_zero_identity():
    cos, sin = TL.rotary_embedding(torch.zeros((1, 4)), 16)
    x = _rand(0, (1, 4, 2, 16))
    np.testing.assert_allclose(TL.apply_rotary(x, cos, sin).numpy(),
                               x.numpy(), rtol=1e-6)
    cos, sin = TL.rotary_embedding(torch.arange(4.0)[None] * 37.0, 16)
    y = TL.apply_rotary(x, cos, sin)
    np.testing.assert_allclose(np.linalg.norm(y.numpy(), axis=-1),
                               np.linalg.norm(x.numpy(), axis=-1), rtol=1e-5)


def test_rms_norm_properties():
    x = _rand(0, (2, 8, 32)) * 10
    w = torch.ones(32)
    y = TL.rms_norm(x, w).numpy()
    np.testing.assert_allclose(np.sqrt((y ** 2).mean(-1)), 1.0, rtol=1e-3)
    np.testing.assert_allclose(TL.rms_norm(x, 3.0 * w).numpy(), 3 * y,
                               rtol=1e-5)
