"""The port's AdamW (``repro_torch.optim.adamw``) against repro's, on the
CPU.

* ``lr_schedule`` at every step 0..N of two configs.
* ``update``, three steps on a seeded tree of fp32 and bf16 leaves (the
  default config, one that clips and one that does not, and jamba's bf16
  first moment): new params, ``mu``, ``nu``, ``grad_norm`` and ``lr``
  within ``FP32_TOL = 1e-5`` of each leaf's max abs; a bf16 leaf (params,
  jamba's ``mu``) within one bf16 step of the reference's value (the
  two packages' fp32 math may differ in a last bit, and the cast to bf16
  then rounds the other way); ``count`` exact.
* ``update_``, the in-place step the train step runs (``update`` runs it
  on copies of its inputs), against the reference in the same way.
* Twins of ``tests/test_substrates.py``'s four AdamW cases.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim import adamw
from test_torch_train import one_torch_thread  # noqa: F401

FP32_TOL = 1e-5
BF16_STEP = 2.0 ** -7          # one bf16 step, relative to the value


def _ref():
    import jax.numpy as jnp

    from repro.optim import adamw as R
    return R, jnp


def _tree_np(seed: int):
    """A seeded tree: fp32 and bf16 leaves, a list of dicts."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "blocks": [{"a": rng.standard_normal((4, 5)).astype(np.float32),
                        "b": rng.standard_normal((16,)).astype(np.float32)}
                       for _ in range(2)],
            "emb": rng.standard_normal((32, 8)).astype(np.float32)}


BF16_LEAVES = ("emb", "blocks.1.a")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _map(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _to_ref(tree):
    _, jnp = _ref()
    return _map(lambda k, a: jnp.asarray(a).astype(
        jnp.bfloat16 if k in BF16_LEAVES else jnp.float32), tree)


def _to_port(tree):
    return _map(lambda k, a: torch.from_numpy(a).to(
        torch.bfloat16 if k in BF16_LEAVES else torch.float32), tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, bf16: bool, what: str) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    if bf16:
        assert np.all(np.abs(g - w) <= BF16_STEP * np.abs(w) + 1e-30), what
    else:
        bound = FP32_TOL * max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= bound, what


def _configs():
    return {"default": ({}, {}),
            "no_clip_short": (dict(lr_peak=1e-2, warmup_steps=1,
                                   total_steps=4, clip_norm=1e9), {}),
            "jamba": ("jamba_15_large_398b", {})}


def _pair(name):
    R, jnp = _ref()
    kw, _ = _configs()[name]
    if isinstance(kw, str):
        return R.config_for(kw, total_steps=50), adamw.config_for(
            kw, total_steps=50)
    return R.AdamWConfig(**kw), adamw.AdamWConfig(**kw)


@pytest.mark.parametrize("name", ["default", "no_clip_short"])
def test_lr_schedule_matches_reference(name):
    R, jnp = _ref()
    rcfg, cfg = _pair(name)
    steps = range(0, min(cfg.total_steps, 300) + 3)
    got = [float(adamw.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(R.lr_schedule(rcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=0)


@pytest.mark.parametrize("name", ["default", "no_clip_short", "jamba"])
def test_update_matches_reference(name):
    R, jnp = _ref()
    rcfg, cfg = _pair(name)
    params_np = _tree_np(0)
    rp, tp = _to_ref(params_np), _to_port(params_np)
    rs, ts = R.init(rcfg, rp), adamw.init(cfg, tp)
    assert ts.count.dtype == torch.int32 and ts.count.dim() == 0
    for step in range(3):
        g_np = _map(lambda k, a: (a * (3.0 + step)).astype(np.float32),
                    _tree_np(10 + step))
        rp, rs, rm = R.update(rcfg, _to_ref(g_np), rs, rp)
        tp, ts, tm = adamw.update(cfg, _to_port(g_np), ts, tp)
        assert int(ts.count) == int(rs.count) == step + 1
        _close(tm["grad_norm"], rm["grad_norm"], False, "grad_norm")
        _close(tm["lr"], rm["lr"], False, "lr")
        for tree_t, tree_r, what in ((tp, rp, "params"), (ts.mu, rs.mu, "mu"),
                                     (ts.nu, rs.nu, "nu")):
            want = dict(_flat(tree_r))
            for k, t in _flat(tree_t):
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
                _close(t, want[k], t.dtype == torch.bfloat16,
                       f"step {step} {what} {k}")


def test_update_leaves_its_inputs_as_they_are():
    cfg = adamw.AdamWConfig(warmup_steps=0)
    params = _to_port(_tree_np(0))
    state = adamw.init(cfg, params)
    before = [t.clone() for t in adamw.tree_leaves([params, list(state)])]
    adamw.update(cfg, _to_port(_tree_np(1)), state, params)
    after = adamw.tree_leaves([params, list(state)])
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("name", ["default", "jamba"])
def test_update_in_place_equals_update(name):
    """``update_`` (the train step's donation) writes the reference's
    values into the tensors it was given, and ``update``'s bit for bit."""
    R, _ = _ref()
    rcfg, cfg = _pair(name)
    params = _to_port(_tree_np(0))
    rp = _to_ref(_tree_np(0))
    state, rs = adamw.init(cfg, params), R.init(rcfg, rp)
    for step in range(3):
        g_np = _tree_np(10 + step)
        grads = _to_port(g_np)
        want_p, want_s, want_m = adamw.update(cfg, grads, state, params)
        rp, rs, rm = R.update(rcfg, _to_ref(g_np), rs, rp)
        ids = [id(t) for t in adamw.tree_leaves([params, state.mu,
                                                 state.nu])]
        params, state, m = adamw.update_(cfg, grads, state, params)
        assert ids == [id(t) for t in adamw.tree_leaves(
            [params, state.mu, state.nu])]
        for a, b in zip(adamw.tree_leaves([params, list(state), m]),
                        adamw.tree_leaves([want_p, list(want_s), want_m])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(state.count) == int(rs.count) == step + 1
        _close(m["grad_norm"], rm["grad_norm"], False, "grad_norm")
        for tree_t, tree_r, what in ((params, rp, "params"),
                                     (state.mu, rs.mu, "mu"),
                                     (state.nu, rs.nu, "nu")):
            want = dict(_flat(tree_r))
            for k, t in _flat(tree_t):
                _close(t, want[k], t.dtype == torch.bfloat16,
                       f"step {step} {what} {k}")


def test_abstract_state_is_meta_of_the_state():
    cfg = adamw.config_for("jamba_15_large_398b")
    params = _to_port(_tree_np(0))
    ab = adamw.abstract_state(cfg, params)
    st = adamw.init(cfg, params)
    for a, s in zip(adamw.tree_leaves(list(ab)), adamw.tree_leaves(list(st))):
        assert a.device.type == "meta"
        assert a.shape == s.shape and a.dtype == s.dtype


# ---- twins of tests/test_substrates.py ---------------------------------------

def test_adamw_minimizes_quadratic():
    cfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0)
    params = {"x": torch.tensor(5.0)}
    state = adamw.init(cfg, params)
    for _ in range(150):
        grads = {"x": 2 * params["x"]}
        params, state, _ = adamw.update(cfg, grads, state, params)
    assert abs(float(params["x"])) < 0.3


def test_lr_schedule_shape():
    cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[4] < lrs[3] < lrs[2]


def test_grad_clipping():
    cfg = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0)
    params = {"x": torch.zeros((4,))}
    state = adamw.init(cfg, params)
    _, _, m = adamw.update(cfg, {"x": torch.full((4,), 100.0)}, state, params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_jamba_uses_bf16_mu():
    cfg = adamw.config_for("jamba_15_large_398b")
    assert cfg.mu_dtype == torch.bfloat16
    assert adamw.config_for("llama3_8b").mu_dtype == torch.float32
