"""The port's write side and introspection, bit for bit against repro."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as sl
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import prng
from repro_torch.core import skiplist as tsl
from test_torch_skiplist import _assert_same_state, _jax_arrays, _keys

KEY_MAX = 2**31 - 1


def _to_jax(ts):
    arrays = {"nxt": None, "fused": None, **state_to_numpy(ts)}
    return sl.SkipListState(**{k: None if v is None else jnp.asarray(v)
                               for k, v in arrays.items()})


def _start(kind, foresight):
    """The same start state in both packages: empty, or built from keys."""
    if kind == "empty":
        return (sl.empty(256, 8, foresight=foresight, seed=5),
                tsl.empty(256, 8, foresight=foresight, seed=5, device="cpu"))
    keys = _keys(200, 21, span=600)
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys * 2), capacity=512,
                  levels=9, foresight=foresight, seed=21)
    ts = tsl.build(keys, keys * 2, capacity=512, levels=9,
                   foresight=foresight, seed=21, device="cpu")
    return js, ts


def _op_stream(n, seed, span=600, types=(0, 1, 2)):
    rng = np.random.default_rng(seed)
    ops = rng.choice(np.array(types, np.int32), n)
    ks = rng.integers(0, span, n).astype(np.int32)
    return ops, ks, (ks * 7 + 1).astype(np.int32)


def _apply_both(js, ts, ops, ks, vs):
    js2, jr = sl.apply_ops(js, jnp.asarray(ops), jnp.asarray(ks),
                           jnp.asarray(vs))
    ts2, tr = tsl.apply_ops(ts, torch.from_numpy(ops), torch.from_numpy(ks),
                            torch.from_numpy(vs))
    return js2, ts2, np.asarray(jr), tr.numpy()


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("kind", ["empty", "built"])
def test_apply_ops_matches_repro(kind, foresight):
    """A mixed stream (reads, inserts, upserts, deletes of present and
    missing keys): every state array, the rng included, and every result."""
    js, ts = _start(kind, foresight)
    ops, ks, vs = _op_stream(300, 7)
    js2, ts2, jr, tr = _apply_both(js, ts, ops, ks, vs)
    assert tr.dtype == np.int32
    np.testing.assert_array_equal(tr, jr)
    _assert_same_state(js2, ts2)
    for op in (tsl.OP_READ, tsl.OP_INSERT, tsl.OP_DELETE):  # both outcomes
        assert set(tr[ops == op]) == {0, 1}, op


def test_apply_ops_clamps_op_types_like_lax_switch():
    js, ts = _start("built", True)
    ops = np.array([-3, 3, 7, -1, 2, 1], np.int32)
    ks = np.array([5, 6, 6, 6, 5, 5], np.int32)
    js2, ts2, jr, tr = _apply_both(js, ts, ops, ks, ks)
    np.testing.assert_array_equal(tr, jr)
    _assert_same_state(js2, ts2)


def _single_ops_both(js, ts, ops):
    """Run ``ops`` [(kind, key, val)] one call at a time in both packages,
    comparing the state and the flag after each."""
    flags = []
    for kind, k, *v in ops:
        if kind == "insert":
            v, = v
            js, jok = sl.insert(js, jnp.int32(k), jnp.int32(v))
            ts, tok = tsl.insert(ts, k, v)
        else:
            js, jok = sl.delete(js, jnp.int32(k))
            ts, tok = tsl.delete(ts, k)
        assert tok.dtype == torch.bool and tok.shape == ()
        assert bool(tok) == bool(jok), (kind, k)
        _assert_same_state(js, ts)
        flags.append(bool(tok))
    return js, ts, flags


@pytest.mark.parametrize("foresight", [True, False])
def test_pop_past_cap_reads_the_last_free_slot_like_repro(foresight):
    """Deletes of KEY_MAX push the tail on the free list again and again;
    past ``capacity`` the pushes are dropped and ``free_top`` rises on.
    The next insert pops ``free_list[capacity - 1]`` (the reference's
    clamped gather) and lowers ``free_top`` by one, in both packages."""
    kw = dict(capacity=8, levels=3, foresight=foresight, seed=3)
    keys = np.array([5, 9, 13], np.int32)
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys * 2), **kw)
    ts = tsl.build(keys, keys * 2, device="cpu", **kw)
    _, ts2, flags = _single_ops_both(
        js, ts, [("delete", KEY_MAX)] * 12 + [("insert", 7, 70)])
    assert flags == [True] * 13
    assert int(ts2.free_top) == 11 and int(ts2.free_list[7]) == tsl.TAIL


@pytest.mark.parametrize("foresight", [True, False])
def test_insert_and_delete_match_repro(foresight):
    js, ts = _start("built", foresight)
    present = int(_keys(200, 21, span=600)[10])
    ops = [("insert", 999, 42),          # new key
           ("insert", present, 777),     # upsert: rng advances, no slot
           ("delete", 998),              # missing
           ("delete", present),
           ("delete", 999),
           ("insert", 5000, 1),          # reuses a freed slot
           ("insert", -5, 2)]
    _, ts2, flags = _single_ops_both(js, ts, ops)
    assert flags == [True, False, False, True, True, True, True]
    assert int(ts2.free_top) == 0 and int(ts2.bump) == int(ts.bump) + 1


@pytest.mark.parametrize("foresight", [True, False])
def test_freelist_reuse_cycles_match_repro(foresight):
    js, ts = _start("built", foresight)
    keys = _keys(200, 21, span=600)
    rng = np.random.default_rng(7)
    ops = []
    for i, victim in enumerate(rng.choice(keys, 8, replace=False)):
        ops += [("delete", int(victim)), ("insert", 200000 + i, i)]
    _, ts2, flags = _single_ops_both(js, ts, ops)
    assert all(flags)
    assert int(ts2.free_top) == 0 and int(ts2.bump) == int(ts.bump)


@pytest.mark.parametrize("foresight", [True, False])
def test_capacity_exhaustion_matches_repro(foresight):
    """Ten inserts into ``empty(8, 4)``: six fit.  The four that find no
    slot (free list empty, bump == capacity) write nothing out of range and
    advance only the rng."""
    js = sl.empty(8, 4, foresight=foresight)
    ts = tsl.empty(8, 4, foresight=foresight, device="cpu")
    ops = [("insert", k + 1, k) for k in range(10)]
    _, ts2, flags = _single_ops_both(js, ts, ops)
    assert flags == [True] * 6 + [False] * 4
    assert int(ts2.bump) == 8 and int(ts2.n) == 6
    # The same through apply_ops, with a delete freeing one slot.
    ops = np.array([1] * 10 + [2, 1, 1], np.int32)
    ks = np.array(list(range(1, 11)) + [3, 50, 51], np.int32)
    js2, ts3, jr, tr = _apply_both(sl.empty(8, 4, foresight=foresight),
                                   tsl.empty(8, 4, foresight=foresight,
                                             device="cpu"), ops, ks, ks)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tr[-3:], [1, 1, 0])
    _assert_same_state(js2, ts3)


def _snapshot(ts):
    return {k: t.clone() for k, t in ts._asdict().items() if t is not None}


@pytest.mark.parametrize("foresight", [True, False])
def test_updates_leave_their_input_state_unchanged(foresight):
    """A published version must stay as it was: insert, delete and
    apply_ops return new tensors and never write into their input."""
    _, ts = _start("built", foresight)
    before = _snapshot(ts)
    key = int(_keys(200, 21, span=600)[3])
    outs = [tsl.insert(ts, 12345, 1)[0], tsl.insert(ts, key, 9)[0],
            tsl.delete(ts, key)[0],
            tsl.apply_ops(ts, *map(torch.from_numpy, _op_stream(50, 1)))[0]]
    for name, t in before.items():
        assert torch.equal(getattr(ts, name), t), name
        for out in outs:
            assert (getattr(out, name).untyped_storage().data_ptr()
                    != getattr(ts, name).untyped_storage().data_ptr()), name


def test_scalar_height_bits_match_jax():
    """Each insert samples one height from a key split off the state's rng,
    with shape ``()``."""
    key = jax.random.PRNGKey(17)
    tkey = prng.PRNGKey(17)
    for _ in range(20):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        want = np.asarray(sl.sample_heights(sub, (), 12))
        got = tsl.sample_heights(tsub, (), 12)
        assert got.shape == () and int(got) == int(want)
        np.testing.assert_array_equal(prng.bits(tsub, ()).numpy(),
                                      np.asarray(jax.random.bits(sub, ())))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("kind", ["empty", "built"])
def test_introspection_after_updates_matches_repro(kind, foresight):
    js, ts = _start(kind, foresight)
    js, ts, _, _ = _apply_both(js, ts, *_op_stream(200, 11))
    if foresight:
        got = tsl.check_foresight_invariant(ts)
        assert got.shape == () and bool(got)
        assert bool(sl.check_foresight_invariant(js))
    for got, want in zip(tsl.sorted_live_kv(ts), sl.sorted_live_kv(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tsl.to_sorted_keys(ts, 400).numpy(),
                                  np.asarray(sl.to_sorted_keys(js, 400)))
    for lo, hi, max_out in [(0, 600, 50), (100, 200, 64), (300, 301, 4),
                            (-10, 5, 8), (590, 10**6, 32)]:
        got = tsl.range_scan(ts, lo, hi, max_out)
        want = sl.range_scan(js, jnp.int32(lo), jnp.int32(hi), max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_check_foresight_invariant_sees_a_torn_record():
    js, ts = _start("built", True)
    fused = state_to_numpy(ts)["fused"]
    fused[2, 0, 1] += 1                  # the head's foreseen key, level 2
    bad = state_from_numpy({**state_to_numpy(ts), "fused": fused}, "cpu")
    assert not bool(tsl.check_foresight_invariant(bad))
    assert not bool(sl.check_foresight_invariant(_to_jax(bad)))
    with pytest.raises(ValueError, match="foresight"):
        tsl.check_foresight_invariant(_start("built", False)[1])


def test_convert_carries_updated_states_both_ways():
    """After updates the free list, bump and rng have moved; a state
    crosses to repro and back bit for bit, and both packages continue the
    same stream from it identically."""
    js, ts = _start("built", True)
    js, ts, _, _ = _apply_both(js, ts, *_op_stream(150, 3))
    assert int(ts.free_top) > 0
    back = state_from_numpy(_jax_arrays(js), "cpu")
    _assert_same_state(js, back)
    js2, ts2, jr, tr = _apply_both(_to_jax(ts), back, *_op_stream(100, 4))
    np.testing.assert_array_equal(tr, jr)
    _assert_same_state(js2, ts2)


@pytest.mark.parametrize("foresight", [True, False])
def test_delete_of_key_max_frees_the_tail_like_repro(foresight):
    """KEY_MAX lies outside the key domain and a search for it finds the
    tail sentinel; repro's delete then reports success, pushes node 1 (the
    tail) on the free list and lowers ``n``.  The port does the same."""
    js, ts = _start("built", foresight)
    _, ts2, flags = _single_ops_both(js, ts, [("delete", KEY_MAX)])
    assert flags == [True]
    assert int(ts2.free_list[0]) == tsl.TAIL and int(ts2.n) == int(ts.n) - 1
