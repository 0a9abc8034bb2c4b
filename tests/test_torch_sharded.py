"""The port's sharded engine against repro's, bit for bit, on the CPU.

Twins of ``tests/test_sharded_index.py`` (the two store cases wait for the
data plane, and the VMEM refusal is a TPU limit the port does not have:
see ``test_port_takes_a_tile_over_the_vmem_budget``), plus equality of
every stacked array of ``build_sharded`` / ``empty_sharded`` /
``shard_state``, routed updates that leave their input unchanged, the
per-shard ``rng`` of repeated inserts, and the refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as shd
from repro.core import skiplist as sl
from repro.kernels import ops as kops
from repro_torch.convert import (sharded_from_numpy, sharded_to_numpy,
                                 state_from_numpy)
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops


def _keys(n, seed=0, span=1 << 22):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(span, n, replace=False)).astype(np.int32), rng


def _np(shl):
    """{"shards.<field>": array, "boundaries": array} of a repro index."""
    out = {f"shards.{k}": np.asarray(v)
           for k, v in shl.shards._asdict().items() if v is not None}
    out["boundaries"] = np.asarray(shl.boundaries)
    return out


def _port(shl):
    return sharded_from_numpy(_np(shl), "cpu")


def _assert_same(port, ref):
    """Every stacked array and the boundaries are equal."""
    got, want = sharded_to_numpy(port), _np(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pair(n=2000, n_shards=4, levels=12, foresight=True, seed=0):
    """(repro index, port index built independently, keys, rng)."""
    keys, rng = _keys(n, seed)
    vals = (keys * 3).astype(np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(vals),
                            n_shards=n_shards, levels=levels,
                            foresight=foresight, seed=seed)
    port = tsh.build_sharded(keys, vals, n_shards=n_shards, levels=levels,
                             foresight=foresight, seed=seed, device="cpu")
    return ref, port, keys, rng


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n,n_shards,capacity,levels",
                         [(2000, 4, 0, 12), (10, 8, 0, 6), (1500, 9, 512, 10),
                          (0, 3, 16, 5)])
def test_build_sharded_equals_repro(n, n_shards, capacity, levels, foresight):
    keys, _ = _keys(n, n + n_shards)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys + 1),
                            n_shards=n_shards, capacity=capacity,
                            levels=levels, foresight=foresight, seed=7)
    port = tsh.build_sharded(keys, keys + 1, n_shards=n_shards,
                             capacity=capacity, levels=levels,
                             foresight=foresight, seed=7, device="cpu")
    _assert_same(port, ref)
    assert port.shard_capacity == ref.shard_capacity
    assert tsh.shard_capacity_for(n, n_shards) == \
        shd.shard_capacity_for(n, n_shards)


def test_build_sharded_with_valid_prefix_equals_repro():
    keys, _ = _keys(300, 3)
    valid = np.arange(300) < 211
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys),
                            n_shards=5, levels=8, valid=jnp.asarray(valid))
    port = tsh.build_sharded(keys, keys, n_shards=5, levels=8, valid=valid,
                             device="cpu")
    _assert_same(port, ref)


@pytest.mark.parametrize("foresight", [True, False])
def test_empty_sharded_equals_repro(foresight):
    ref = shd.empty_sharded(n_shards=4, capacity=16, levels=6,
                            foresight=foresight, seed=3)
    port = tsh.empty_sharded(n_shards=4, capacity=16, levels=6,
                             foresight=foresight, seed=3, device="cpu")
    _assert_same(port, ref)
    assert int(tsh.total_n(port)) == 0


def test_capacity_helpers_equal_repro():
    for w in (1, 2, 8):
        assert tsl.pack_fill(w) == sl.pack_fill(w)
    for n in (0, 1, 7, 1000):
        assert tsl.node_slots_for(n, 1) == sl.node_slots_for(n, 1)
    for cap in (8, 64, 2**21):
        assert tsl.usable_capacity(cap) == sl.usable_capacity(cap)


def test_route_respects_boundaries():
    ref, shl, keys, rng = _pair()
    _assert_same(shl, ref)
    b = shl.boundaries.numpy()
    assert b[0] == np.int32(-(2**31))
    for s in range(1, shl.n_shards):
        assert int(tsh.route(shl.boundaries, torch.tensor([b[s]]))[0]) == s
        assert int(tsh.route(shl.boundaries,
                             torch.tensor([b[s] - 1]))[0]) == s - 1
    q = np.concatenate([keys, rng.integers(-2**31, 2**31 - 1, 500),
                        [-2**31, 2**31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(
        tsh.route(shl.boundaries, torch.from_numpy(q)).numpy(),
        np.asarray(shd.route(ref.boundaries, jnp.asarray(q))))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_search_matches_monolithic(foresight, n_shards):
    ref, shl, keys, rng = _pair(foresight=foresight, n_shards=n_shards)
    _assert_same(shl, ref)
    cap = int(2 ** np.ceil(np.log2(2 * 2000 + 4)))
    mono = tsl.build(keys, keys * 3, capacity=cap, levels=12,
                     foresight=foresight, device="cpu")
    q = np.concatenate([rng.choice(keys, 256),
                        rng.integers(0, 1 << 22, 256)]).astype(np.int32)
    got = tsh.search_sharded(shl, torch.from_numpy(q))
    _eq(got, shd.search_sharded(ref, jnp.asarray(q)))
    _eq(got, [t.numpy() for t in tsl.search_fast(mono, torch.from_numpy(q))])
    np.testing.assert_array_equal(
        tsh.contains_sharded(shl, torch.from_numpy(q)).numpy(),
        got[0].numpy())


@pytest.mark.parametrize("foresight", [True, False])
def test_sharded_kernel_matches_monolithic(foresight):
    ref, shl, keys, rng = _pair(foresight=foresight)
    q = np.concatenate([rng.choice(keys, 100),
                        rng.integers(0, 1 << 22, 100)]).astype(np.int32)
    want = kops.search_kernel(ref, jnp.asarray(q))   # ShardedSkipList dispatch
    got = tops.search_kernel(shl, torch.from_numpy(q))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    mono = sl.search(sl.build(jnp.asarray(keys), jnp.asarray(keys * 3),
                              capacity=4096, levels=12, foresight=foresight),
                     jnp.asarray(q))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(mono.found))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(mono.vals))


def test_shard_state_conversion_equals_repro_and_monolithic():
    """levels=16, cap=2**18: the reference's kernels refuse this monolith
    (32 MiB > 12 MiB of VMEM) and point to ``shard_state``; the port's
    conversion builds the same shards, and both answer as the monolith."""
    keys, rng = _keys(120_000, seed=1, span=1 << 30)
    ref_mono = sl.build(jnp.asarray(keys), jnp.asarray(keys // 2),
                        capacity=2**18, levels=16, foresight=True)
    mono = tsl.build(keys, keys // 2, capacity=2**18, levels=16,
                     device="cpu")
    assert not kops.fits_vmem(ref_mono) and not tops.fits_vmem(mono)
    S = tops.auto_shards(mono.capacity - 2, 16)
    assert S == kops.auto_shards(mono.capacity - 2, 16)
    shl = tops.shard_state(mono, S)
    _assert_same(shl, kops.shard_state(ref_mono, S))
    assert tops.fits_vmem(shl)
    q = np.concatenate([rng.choice(keys, 128),
                        rng.integers(0, 1 << 30, 128)]).astype(np.int32)
    rk = tops.search_kernel(shl, torch.from_numpy(q))
    rc = tsl.search(mono, torch.from_numpy(q))
    np.testing.assert_array_equal(rk.found.numpy(), rc.found.numpy())
    np.testing.assert_array_equal(rk.vals.numpy(), rc.vals.numpy())


def test_shard_state_after_updates_equals_repro():
    keys, rng = _keys(1500)
    ref_mono = sl.build(jnp.asarray(keys), jnp.asarray(keys * 3),
                        capacity=4096, levels=12)
    ops = rng.integers(1, 3, 200).astype(np.int32)
    kk = np.concatenate([rng.choice(keys, 100),
                         rng.integers(0, 1 << 22, 100)]).astype(np.int32)
    ref_mono, _ = sl.apply_ops(ref_mono, jnp.asarray(ops), jnp.asarray(kk),
                               jnp.asarray(kk))
    mono = state_from_numpy({k: np.asarray(v) for k, v in
                             ref_mono._asdict().items() if v is not None},
                            "cpu")
    shl = tops.shard_state(mono, 4)
    _assert_same(shl, kops.shard_state(ref_mono, 4))
    assert int(tsh.total_n(shl)) == int(mono.n)
    assert bool(tsh.check_sharded_invariant(shl))
    q = torch.from_numpy(rng.choice(keys, 200).astype(np.int32))
    _eq(tsh.search_sharded(shl, q), tsl.search_fast(mono, q))


def test_build_sharded_uneven_and_empty_shards():
    """n << S*m leaves trailing shards empty; routing must avoid them."""
    keys = np.arange(10, 110, 10, dtype=np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys),
                            n_shards=8, levels=6)
    shl = tsh.build_sharded(keys, keys, n_shards=8, levels=6, device="cpu")
    _assert_same(shl, ref)
    f, v = tsh.search_sharded(shl, torch.from_numpy(keys))
    assert bool(f.all())
    q = torch.tensor([5, 115, 1 << 20], dtype=torch.int32)
    assert not bool(tsh.search_sharded(shl, q)[0].any())
    _eq(tsh.search_sharded(shl, q), shd.search_sharded(ref, jnp.asarray(q)))
    assert bool(tsh.check_sharded_invariant(shl))


@pytest.mark.parametrize("foresight", [True, False])
def test_range_scan_spans_shard_boundary(foresight):
    ref, shl, keys, _ = _pair(foresight=foresight)
    b1 = int(shl.boundaries[1])
    lo, hi = b1 - 60000, b1 + 60000
    got = tsh.range_scan_sharded(shl, lo, hi, 256)
    _eq(got, shd.range_scan_sharded(ref, jnp.int32(lo), jnp.int32(hi), 256))
    ks, vs, count = got
    expect = [int(k) for k in keys if lo <= k < hi]
    assert len(expect) > 0
    assert ks[:int(count)].tolist() == expect[:256]
    np.testing.assert_array_equal(vs[:int(count)].numpy(),
                                  np.array(expect[:256]) * 3)


def test_range_scan_sharded_empty_and_full():
    ref, shl, keys, _ = _pair()
    gap_lo, gap_hi = int(keys[5]) + 1, int(keys[6])
    if gap_hi > gap_lo:
        got = tsh.range_scan_sharded(shl, gap_lo, gap_hi, 16)
        assert int(got[2]) == 0
        _eq(got, shd.range_scan_sharded(ref, jnp.int32(gap_lo),
                                        jnp.int32(gap_hi), 16))
    got = tsh.range_scan_sharded(shl, 0, (1 << 22) + 1, 64)
    assert int(got[2]) == 64
    assert got[0].tolist() == keys[:64].tolist()
    _eq(got, shd.range_scan_sharded(ref, jnp.int32(0),
                                    jnp.int32((1 << 22) + 1), 64))


def test_range_scan_through_empty_trailing_shards():
    keys = np.arange(10, 110, 10, dtype=np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys),
                            n_shards=8, levels=6)
    shl = tsh.build_sharded(keys, keys, n_shards=8, levels=6, device="cpu")
    for lo, hi, m in ((15, 200, 32), (0, 10**6, 4), (95, 96, 8)):
        _eq(tsh.range_scan_sharded(shl, lo, hi, m),
            shd.range_scan_sharded(ref, jnp.int32(lo), jnp.int32(hi), m))


@pytest.mark.parametrize("foresight", [True, False])
def test_apply_ops_sharded_matches_monolithic(foresight):
    ref, shl, keys, rng = _pair(n=1000, foresight=foresight)
    ops = rng.integers(0, 3, 300).astype(np.int32)
    kk = np.concatenate([rng.choice(keys, 150),
                         rng.integers(0, 1 << 22, 150)]).astype(np.int32)
    vv = kk * 5
    cap = int(2 ** np.ceil(np.log2(2 * 1000 + 4)))
    mono = tsl.build(keys, keys * 3, capacity=cap, levels=12,
                     foresight=foresight, device="cpu")
    mono2, res_m = tsl.apply_ops(mono, ops, kk, vv)
    ref2, res_r = shd.apply_ops_sharded(ref, jnp.asarray(ops),
                                        jnp.asarray(kk), jnp.asarray(vv))
    shl2, res_s = tsh.apply_ops_sharded(shl, ops, kk, vv)
    np.testing.assert_array_equal(res_s.numpy(), np.asarray(res_r))
    np.testing.assert_array_equal(res_s.numpy(), res_m.numpy())
    _assert_same(shl2, ref2)
    assert bool(tsh.check_sharded_invariant(shl2))
    assert int(tsh.total_n(shl2)) == int(mono2.n)
    q = torch.from_numpy(np.concatenate(
        [kk, rng.integers(0, 1 << 22, 200)]).astype(np.int32))
    _eq(tsh.search_sharded(shl2, q), tsl.search_fast(mono2, q))


def test_apply_ops_sharded_leaves_its_input_unchanged():
    ref, shl, keys, rng = _pair(n=600, n_shards=4)
    before = sharded_to_numpy(shl)
    ops = rng.integers(0, 3, 120).astype(np.int32)
    kk = rng.integers(0, 1 << 22, 120).astype(np.int32)
    out, _ = tsh.apply_ops_sharded(shl, ops, kk, kk)
    after = sharded_to_numpy(shl)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for a, b in zip(out.shards, shl.shards):
        assert a is None or a.data_ptr() != b.data_ptr()
    out, _ = tsh.apply_ops_sharded(shl, ops, kk, kk, rebalance=True)
    after = sharded_to_numpy(shl)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_two_inserts_into_one_shard_advance_its_rng():
    """The second insert routed to a shard must draw new height bits, in
    one batch and across two batches: the shard's rng is written back into
    the stack, and every field of the stack equals repro's after each."""
    ref, shl, keys, _ = _pair(n=400, n_shards=4, levels=10)
    b1 = int(shl.boundaries[1])
    new = np.setdiff1d(np.arange(b1 - 40, b1), keys)[-2:].astype(np.int32)
    ins = np.full(2, tsl.OP_INSERT, np.int32)
    r1, res_r = shd.apply_ops_sharded(ref, jnp.asarray(ins),
                                      jnp.asarray(new), jnp.asarray(new))
    p1, res_p = tsh.apply_ops_sharded(shl, ins, new, new)
    np.testing.assert_array_equal(res_p.numpy(), [1, 1])
    np.testing.assert_array_equal(res_p.numpy(), np.asarray(res_r))
    _assert_same(p1, r1)
    assert not torch.equal(p1.shards.rng[0], shl.shards.rng[0])
    assert torch.equal(p1.shards.rng[1:], shl.shards.rng[1:])
    r2, p2 = ref, shl
    for k in new:                        # the same inserts, one per batch
        r2, _ = shd.apply_ops_sharded(r2, jnp.asarray(ins[:1]),
                                      jnp.asarray([k]), jnp.asarray([k]))
        p2, _ = tsh.apply_ops_sharded(p2, ins[:1], [k], [k])
        _assert_same(p2, r2)
    _assert_same(p2, r1)


def test_apply_ops_sharded_empty_batch():
    ref, shl, _, _ = _pair(n=100, n_shards=2, levels=6)
    z = np.zeros(0, np.int32)
    out, res = tsh.apply_ops_sharded(shl, z, z, z)
    assert res.shape == (0,) and res.dtype == torch.int32
    _assert_same(out, ref)


def test_check_sharded_invariant_equals_repro_and_catches_faults():
    ref, shl, keys, _ = _pair(n=500, n_shards=4, levels=8)
    assert bool(tsh.check_sharded_invariant(shl, expect_n=500))
    assert not bool(tsh.check_sharded_invariant(shl, expect_n=499))
    faults = {
        "boundaries": lambda d: d["boundaries"].__setitem__(
            2, d["boundaries"][1] - 1),
        "shards.keys": lambda d: d["shards.keys"].__setitem__(
            (1, 5), d["boundaries"][0] + 1),
        "shards.fused": lambda d: d["shards.fused"].__setitem__(
            (2, 0, 0, 1), 17),
    }
    for name, break_it in faults.items():
        arrays = {k: v.copy() for k, v in _np(ref).items()}
        break_it(arrays)
        port = sharded_from_numpy(arrays, "cpu")
        want = shd.check_sharded_invariant(shd.ShardedSkipList(
            shards=ref.shards._replace(**{
                k[len("shards."):]: jnp.asarray(v) for k, v in arrays.items()
                if k.startswith("shards.")}),
            boundaries=jnp.asarray(arrays["boundaries"])))
        assert not bool(want), name
        assert bool(tsh.check_sharded_invariant(port)) == bool(want), name


def test_convert_round_trip_and_refusals():
    ref, shl, _, _ = _pair(n=300, n_shards=3, levels=6)
    again = sharded_from_numpy(sharded_to_numpy(shl), "cpu")
    _assert_same(again, ref)
    with pytest.raises(NotImplementedError, match="sharded_from_numpy"):
        state_from_numpy({k[len("shards."):]: v for k, v in
                          _np(ref).items() if k.startswith("shards.")},
                         "cpu")
    with pytest.raises(ValueError, match="stacked"):
        sharded_from_numpy({"shards.keys": np.zeros(8, np.int32),
                            "boundaries": np.zeros(1, np.int32)}, "cpu")
    fat = shd.build_sharded(jnp.arange(10, 500, 7, dtype=jnp.int32),
                            jnp.arange(70, dtype=jnp.int32), n_shards=3,
                            levels=6, node_width=8)
    again = sharded_from_numpy(_np(fat), "cpu")
    assert again.node_width == 8
    _assert_same(again, fat)
    _assert_same(sharded_from_numpy(sharded_to_numpy(again), "cpu"), fat)


def test_eager_search_refuses_a_stack_past_int32():
    """The reference's eager stack index (sid * L + lvl) * cap + x wraps
    in int32 past 2**31 - 1 (64 shards x 21 levels x 2**21 slots is 2.8e9):
    no reference answer exists there, so the port refuses; the kernel
    path, which indexes per shard, takes the same shape."""
    st = tsl.empty(8, 4, device="cpu")
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    big = tsh.ShardedSkipList(
        st._replace(keys=meta(64, 2**21), fused=meta(64, 21, 2**21, 2)),
        torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tsh.search_sharded(big, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tsh.range_scan_sharded(big, 0, 10, 4)
    tops.check_index_range(21, 2**21, 64)           # the kernels take it
    with pytest.raises(ValueError, match="sid \\* capacity"):
        tops.check_index_range(21, 2**21, 2**11)
    with pytest.raises(ValueError, match="lvl \\* capacity"):
        tops.check_index_range(2**11, 2**21, 1)


def test_port_takes_a_tile_over_the_vmem_budget():
    """The twin of ``test_search_kernel_sharded_rejects_oversized_tile``,
    inverted on purpose: the reference refuses one shard of 16 levels x
    2**18 slots (32 MiB > its 12 MiB VMEM budget, a TPU limit), while the
    port's kernels read the index from device memory and answer."""
    ref = shd.build_sharded(jnp.asarray([5, 9], jnp.int32),
                            jnp.asarray([1, 2], jnp.int32), n_shards=1,
                            capacity=2**18, levels=16)
    assert not kops.fits_vmem(ref)
    with pytest.raises(ValueError, match="more shards"):
        kops.search_kernel(ref, jnp.asarray([5], jnp.int32))
    shl = tsh.build_sharded(np.array([5, 9], np.int32),
                            np.array([1, 2], np.int32), n_shards=1,
                            capacity=2**18, levels=16, device="cpu")
    assert not tops.fits_vmem(shl)
    before = tft.foresight_traverse_clustered.launches
    res = tops.search_kernel(shl, torch.tensor([5, 9, 7], dtype=torch.int32))
    np.testing.assert_array_equal(res.found.numpy(), [True, True, False])
    np.testing.assert_array_equal(res.vals.numpy(), [1, 2, -1])
    assert tft.foresight_traverse_clustered.launches == before   # CPU: plain
