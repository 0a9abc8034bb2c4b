"""The grouping pass of the dense sharded walks, held to repro on the CPU.

``group_by_shard_plain`` (``repro_torch.kernels.shard_group``) orders a
routed batch's lanes by shard exactly as the stable argsort of the
reference's clustered plan (``repro.kernels.ops.cluster_queries``) does;
walking the grouped lanes with the plain K3 / K4 and scattering the
results back to lane order gives the plain dense walk and the reference's
``search_kernel_sharded(cluster=False)``, bit for bit.  The CUDA kernel
itself is held to this plain version on the card
(``tests/test_torch_sharded_gpu.py``, ``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as shd
from repro.kernels import ops as kops
from repro_torch.convert import sharded_from_numpy
from repro_torch.core import sharded as tsh
from repro_torch.core.skiplist import NULL_VAL
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import shard_group as tsg

N, S, SPAN = 1500, 8, 1 << 22


@functools.cache
def _index(foresight):
    """The reference's n=1500, S=8 index and its port (through numpy); the
    tests read them and never write them."""
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(SPAN, N, replace=False)).astype(np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys * 3),
                            n_shards=S, levels=12, foresight=foresight,
                            seed=0)
    arrays = {f"shards.{k}": np.asarray(v)
              for k, v in ref.shards._asdict().items() if v is not None}
    arrays["boundaries"] = np.asarray(ref.boundaries)
    return ref, sharded_from_numpy(arrays, "cpu"), keys


def _lanes(keys, traffic, batch, seed=3):
    rng = np.random.default_rng(seed)
    if traffic == "half_hit":
        q = np.concatenate([rng.choice(keys, batch // 2),
                            rng.integers(0, SPAN, batch - batch // 2)])
    elif traffic == "zipf":                       # benchmarks/common.py:55-60
        q = keys[(rng.zipf(1.2, batch) - 1) % len(keys)]
    else:                                         # every lane in one shard
        q = rng.choice(keys[:N // (2 * S)], batch)
    return q.astype(np.int32)


@pytest.mark.parametrize("traffic", ["half_hit", "zipf", "one_shard"])
@pytest.mark.parametrize("batch", [37, 1000])
def test_grouping_equals_cluster_queries(traffic, batch):
    ref, shl, keys = _index(True)
    q = tops._pad(torch.from_numpy(_lanes(keys, traffic, batch)))[0]
    plan = kops.cluster_queries(ref.boundaries, jnp.asarray(q.numpy()))
    sid = tsh.route(shl.boundaries, q)
    perm, offsets = tsg.group_by_shard_plain(sid, S)
    assert perm.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(q[perm.long()].numpy(),
                                  np.asarray(plan.q_sorted))
    np.testing.assert_array_equal(sid[perm.long()].numpy(),
                                  np.asarray(plan.sid_sorted))
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(np.bincount(
            sid.numpy(), minlength=S + 1))]))
    q_s, sid_s, perm_w, off_w = tsg.group_by_shard(sid, q, S)
    assert torch.equal(perm_w, perm) and torch.equal(off_w, offsets)
    assert torch.equal(q_s, q[perm.long()])
    assert torch.equal(sid_s, sid[perm.long()])


def test_lanes_outside_the_shards_go_last_in_batch_order():
    sid = torch.tensor([3, -1, 0, 8, 3, 9, -5, 0, 1], dtype=torch.int32)
    q_s, sid_s, perm, offsets = tsg.group_by_shard(
        sid, torch.arange(9, dtype=torch.int32) * 10, S)
    assert perm.tolist() == [2, 7, 8, 0, 4, 1, 3, 5, 6]
    assert sid_s.tolist() == [0, 0, 1, 3, 3, -1, 8, 9, -5]
    assert q_s.tolist() == [20, 70, 80, 0, 40, 10, 30, 50, 60]
    assert offsets.tolist() == [0, 2, 3, 3, 5, 5, 5, 5, 5, 9]
    empty = torch.empty(0, dtype=torch.int32)
    assert [t.tolist() for t in tsg.group_by_shard(empty, empty, S)] == [
        [], [], [], [0] * (S + 2)]
    with pytest.raises(ValueError, match="n_shards"):
        tsg.group_by_shard(sid, sid, 0)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("traffic", ["half_hit", "zipf", "one_shard"])
def test_grouped_walk_scattered_back_equals_dense_and_repro(foresight,
                                                            traffic):
    ref, shl, keys = _index(foresight)
    q = torch.from_numpy(_lanes(keys, traffic, 300, seed=5))
    sid = tsh.route(shl.boundaries, q)
    tables = tops._tables(shl)
    plain = (tft.foresight_traverse_sharded_plain if foresight
             else tft.base_traverse_sharded_plain)
    q_s, sid_s, perm, _ = tsg.group_by_shard(sid, q, S)
    node_s, key_s = plain(*tables, sid_s, q_s)
    node, ckey = torch.empty_like(q), torch.empty_like(q)
    node[perm.long()], ckey[perm.long()] = node_s, key_s
    dense = plain(*tables, sid, q)
    assert torch.equal(node, dense[0]) and torch.equal(ckey, dense[1])

    want = kops.search_kernel_sharded(ref, jnp.asarray(q.numpy()),
                                      cluster=False)
    found = ckey == q
    gnode = sid.long() * shl.shard_capacity + node.long()
    vals = torch.where(found, shl.shards.vals.reshape(-1)[gnode], NULL_VAL)
    np.testing.assert_array_equal(found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(gnode.numpy(), np.asarray(want.node))


@pytest.mark.parametrize("foresight", [True, False])
def test_grouped_walk_gives_zero_to_lanes_outside_the_shards(foresight):
    _, shl, keys = _index(foresight)
    q = torch.from_numpy(_lanes(keys, "half_hit", 200))
    sid = tsh.route(shl.boundaries, q)
    sid[::7], sid[3::7] = -1, S
    tables = tops._tables(shl)
    plain = (tft.foresight_traverse_sharded_plain if foresight
             else tft.base_traverse_sharded_plain)
    q_s, sid_s, perm, offsets = tsg.group_by_shard(sid, q, S)
    assert int(offsets[S + 1] - offsets[S]) == int(((sid < 0) | (sid >= S))
                                                    .sum())
    node_s, key_s = plain(*tables, sid_s, q_s)
    node, ckey = torch.empty_like(q), torch.empty_like(q)
    node[perm.long()], ckey[perm.long()] = node_s, key_s
    dense = plain(*tables, sid, q)
    assert torch.equal(node, dense[0]) and torch.equal(ckey, dense[1])
    assert int(node[::7].abs().sum() + ckey[3::7].abs().sum()) == 0
