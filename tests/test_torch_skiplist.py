"""The port's skiplist build and eager search, bit for bit against repro."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as sl
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import skiplist as tsl

SHAPES = [(16, 64, 4), (100, 256, 8), (1000, 2048, 12), (4000, 8192, 14)]
KEY_MAX = 2**31 - 1


def _jax_arrays(st):
    return {k: np.asarray(v) for k, v in st._asdict().items() if v is not None}


def _assert_same_state(jax_state, torch_state):
    want, got = _jax_arrays(jax_state), state_to_numpy(torch_state)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _keys(n, seed, span=1 << 22):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(span, n, replace=False)).astype(np.int32)


def _both(keys, vals, **kw):
    js = sl.build(jnp.asarray(keys), jnp.asarray(vals), **kw)
    ts = tsl.build(keys, vals, device="cpu", **kw)
    return js, ts


def _queries(keys, batch, seed, span=1 << 22):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, span, batch - batch // 2),
                           [KEY_MAX, 0, keys[0], keys[-1]]]).astype(np.int32)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n,cap,levels", SHAPES)
def test_build_matches_repro(n, cap, levels, foresight):
    keys = _keys(n, n)
    js, ts = _both(keys, keys + 1, capacity=cap, levels=levels,
                   foresight=foresight, seed=n)
    _assert_same_state(js, ts)


@pytest.mark.parametrize("foresight", [True, False])
def test_empty_matches_repro(foresight):
    _assert_same_state(sl.empty(64, 6, foresight=foresight, seed=3),
                       tsl.empty(64, 6, foresight=foresight, seed=3,
                                 device="cpu"))


@pytest.mark.parametrize("foresight", [True, False])
def test_build_of_no_keys_is_empty_with_split_key(foresight):
    """repro's build raises at n=0 (it gathers ``keys[clip(pos, 0, -1)]``
    from an empty array); the port builds the empty list, with the rng
    advanced by the split every build makes."""
    ts = tsl.build(np.zeros(0, np.int32), np.zeros(0, np.int32), capacity=8,
                   levels=3, foresight=foresight, seed=4, device="cpu")
    want = sl.empty(8, 3, foresight=foresight, seed=4)
    want = want._replace(rng=jax.random.split(want.rng)[0])
    _assert_same_state(want, ts)


@pytest.mark.parametrize("foresight", [True, False])
def test_build_one_key_matches_repro(foresight):
    keys = np.array([7], np.int32)
    js, ts = _both(keys, keys + 1, capacity=8, levels=3, foresight=foresight)
    _assert_same_state(js, ts)


@pytest.mark.parametrize("foresight", [True, False])
def test_build_valid_suffix_matches_repro(foresight):
    keys = _keys(300, 2)
    valid = np.arange(300) < 211
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys * 2), capacity=512,
                  levels=9, foresight=foresight, seed=2,
                  valid=jnp.asarray(valid))
    ts = tsl.build(keys, keys * 2, capacity=512, levels=9,
                   foresight=foresight, seed=2, valid=valid, device="cpu")
    _assert_same_state(js, ts)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n,cap,levels,stop_level", [
    (100, 256, 8, 0), (1000, 2048, 12, 0), (1000, 2048, 12, 2)])
def test_search_matches_repro(n, cap, levels, stop_level, foresight):
    keys = _keys(n, n + 1)
    js, ts = _both(keys, keys * 3, capacity=cap, levels=levels,
                   foresight=foresight, seed=1)
    q = _queries(keys, 300, n)
    want = sl.search(js, jnp.asarray(q), stop_level=stop_level)
    got = tsl.search(ts, torch.from_numpy(q), stop_level=stop_level)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tsl.contains(ts, torch.from_numpy(q)),
                                  np.asarray(sl.contains(js, jnp.asarray(q))))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n,cap,levels", [(0, 8, 3), (100, 256, 8),
                                          (4000, 8192, 20)])
def test_search_fast_and_top_level_match_repro(n, cap, levels, foresight):
    keys = _keys(n, 5)
    q = (_queries(keys, 200, 6) if n else np.array([1, KEY_MAX], np.int32))
    ts = tsl.build(keys, keys + 1, capacity=cap, levels=levels,
                   foresight=foresight, seed=5, device="cpu")
    # repro cannot build n=0 (see above), so its search runs on our state
    arrays = {"nxt": None, "fused": None, **state_to_numpy(ts)}
    js = sl.SkipListState(**{k: None if v is None else jnp.asarray(v)
                             for k, v in arrays.items()})
    np.testing.assert_array_equal(tsl.effective_top_level(ts).numpy(),
                                  np.asarray(sl.effective_top_level(js)))
    found, vals = tsl.search_fast(ts, torch.from_numpy(q))
    jf, jv = sl.search_fast(js, jnp.asarray(q))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("foresight", [True, False])
def test_key_max_query_hits_the_tail(foresight):
    """Querying KEY_MAX reports found=True, val=-1, as in repro."""
    keys = _keys(50, 8)
    js, ts = _both(keys, keys + 1, capacity=128, levels=7,
                   foresight=foresight)
    q = np.array([KEY_MAX], np.int32)
    r = tsl.search(ts, torch.from_numpy(q))
    assert bool(r.found[0]) and int(r.vals[0]) == -1
    assert int(r.node[0]) == tsl.TAIL
    f, v = tsl.search_fast(ts, torch.from_numpy(q))
    assert bool(f[0]) and int(v[0]) == -1
    rj = sl.search(js, jnp.asarray(q))
    assert bool(rj.found[0]) and int(rj.vals[0]) == -1


def test_convert_round_trips_a_repro_state_bit_for_bit():
    keys = _keys(200, 9)
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys), capacity=512,
                  levels=10, foresight=True, seed=11)
    ts = state_from_numpy(_jax_arrays(js), "cpu")
    assert ts.rng.dtype == torch.uint32
    _assert_same_state(js, ts)


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(1, 5, dtype=np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsl.empty(16, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsl.build(keys, keys, capacity=16, levels=4)
    arrays = state_to_numpy(tsl.build(keys, keys, capacity=16, levels=4,
                                      device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(arrays)


def test_build_rejects_too_small_capacity():
    keys = np.arange(1, 8, dtype=np.int32)
    with pytest.raises(ValueError, match="capacity"):
        tsl.build(keys, keys, capacity=8, levels=4, device="cpu")
