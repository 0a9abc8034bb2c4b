"""The port's mesh index (K10) and in-place rebalancing on the card, held
against the port's CPU run.

A process group of one rank (an in-process ``HashStore``, no TCP
rendezvous) carries the card's tensors over NCCL and the CPU run over
gloo, so a one-device mesh of each kind runs in this process.  Needs a
CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and skips
without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_mesh_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.convert import mesh_to_numpy, sharded_to_numpy
from repro_torch.core import mesh_index as mi
from repro_torch.core import rebalance_traced as rbt
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import mesh_launch as ml
from repro_torch.kernels import ops as tops

pytestmark = pytest.mark.gpu
DEVICES = ("cuda", "cpu")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def meshes(cuda):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_index_mesh
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    yield {"cuda": make_index_mesh(1), "cpu": make_index_mesh(1, "cpu")}
    dist.destroy_process_group()


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _keys(n=1500, span=1 << 22, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(span, n, replace=False)).astype(np.int32)
    q = np.concatenate([rng.choice(keys, 2048),
                        rng.integers(0, span, 2048)]).astype(np.int32)
    return keys, q


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8])
def test_mesh_searches_on_the_card_equal_the_cpu(meshes, foresight, width):
    keys, q_np = _keys()
    out, mx = {}, {}
    for dev in DEVICES:
        mx[dev] = mi.build_mesh_index(
            keys, keys * 3, n_devices=1, n_shards=8, levels=12, seed=0,
            foresight=foresight, node_width=width, rank=0, device=dev)
        q = torch.from_numpy(q_np).to(dev)
        before = ml.search_kernel_mesh.launches
        out[dev] = [*mi.search_mesh(mx[dev], q, mesh=meshes[dev]),
                    *ml.search_kernel_mesh(mx[dev], q, mesh=meshes[dev]),
                    *tops.search_kernel(mx[dev], q, mesh=meshes[dev])]
        if dev == "cuda":
            assert ml.search_kernel_mesh.launches == before + 2
    _same(mesh_to_numpy(mx["cuda"]), mesh_to_numpy(mx["cpu"]))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)
    found, vals = out["cuda"][:2]
    np.testing.assert_array_equal(found.cpu().numpy(), np.isin(q_np, keys))
    np.testing.assert_array_equal(
        vals.cpu().numpy(), np.where(np.isin(q_np, keys), q_np * 3, -1))


@pytest.mark.parametrize("foresight", [True, False])
def test_k10_launches_k5_k6_once_a_search(meshes, foresight):
    keys, q_np = _keys()
    mx = mi.build_mesh_index(keys, keys * 3, n_devices=1, n_shards=8,
                             levels=12, foresight=foresight, rank=0,
                             device="cuda")
    wrapper = (tft.foresight_traverse_clustered if foresight
               else tft.base_traverse_clustered)
    before = wrapper.launches, ml.search_kernel_mesh.launches
    ml.search_kernel_mesh(mx, torch.from_numpy(q_np).cuda(),
                          mesh=meshes["cuda"])
    assert (wrapper.launches, ml.search_kernel_mesh.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8])
def test_rebalancing_mesh_apply_on_the_card_equals_the_cpu(meshes, foresight,
                                                           width):
    em = {dev: mi.empty_mesh_index(
        n_devices=1, n_shards=8, capacity=16, levels=8, foresight=foresight,
        node_width=width, key_span=1 << 16, rank=0, device=dev)
        for dev in DEVICES}
    zrng = np.random.default_rng(7)
    for b in range(4):
        kk = (1000 + (zrng.zipf(1.2, 32 * width) - 1) % 4096
              ).astype(np.int32)
        ins = np.full(kk.size, tsl.OP_INSERT, np.int32)
        res, stats = {}, {}
        for dev in DEVICES:
            em[dev], res[dev], stats[dev] = mi.apply_ops_mesh(
                em[dev], *(torch.from_numpy(a).to(dev)
                           for a in (ins, kk, kk * 2)),
                mesh=meshes[dev], rebalance=True, seed=b)
        assert torch.equal(res["cuda"].cpu(), res["cpu"])
        _same(mesh_to_numpy(em["cuda"]), mesh_to_numpy(em["cpu"]))
        for a, c in zip(stats["cuda"], stats["cpu"]):
            assert a.dtype == c.dtype and torch.equal(a.cpu(), c)
    assert rbt.live_shard_count(em["cuda"].local) > 1
    assert bool(mi.check_mesh_invariant(em["cuda"], mesh=meshes["cuda"]))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8])
def test_in_place_passes_on_cuda_tensors_equal_the_cpu(cuda, foresight,
                                                       width):
    keys, _ = _keys(n=48, span=1 << 16)
    kk = (int(keys[2]) + (np.random.default_rng(9).zipf(1.2, 96 * width)
                          - 1) % 4096).astype(np.int32)
    ins = np.full(kk.size, tsl.OP_INSERT, np.int32)
    got = {}
    for dev in DEVICES:
        x = rbt.pad_shards(tsh.build_sharded(
            keys, keys * 3, n_shards=4, capacity=16, levels=8,
            foresight=foresight, node_width=width, device=dev), 16)
        x = rbt.split_shard_traced(x, 1, int(x.boundaries[1]) + 1, seed=5)
        x = rbt.merge_shards_traced(x, 1, seed=3)
        x, stats = rbt.watermark_rebalance_traced(x, seed=2)
        x, splits = rbt.exhaustion_guard_traced(
            x, torch.from_numpy(ins).to(dev), torch.from_numpy(kk).to(dev),
            seed=11)
        y, res = tsh.apply_ops_sharded(x, ins, kk, kk * 2, rebalance=True,
                                       seed=4)
        got[dev] = (sharded_to_numpy(x), sharded_to_numpy(y), res.cpu(),
                    stats, splits, rbt.live_shard_count(y))
    _same(got["cuda"][0], got["cpu"][0])
    _same(got["cuda"][1], got["cpu"][1])
    assert torch.equal(got["cuda"][2], got["cpu"][2])
    assert got["cuda"][3:] == got["cpu"][3:]
    assert got["cuda"][1]["boundaries"].shape == (16,)


def test_cross_device_load_on_the_card_equals_the_cpu(cuda):
    live, routed = [5, 0, 9, 1], [0, 0, 0, 0]
    a = rbt.cross_device_load(torch.tensor(live, device="cuda"),
                              torch.tensor(routed, device="cuda"))
    b = rbt.cross_device_load(torch.tensor(live), torch.tensor(routed))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y)


def test_a_card_index_refuses_the_cpu_mesh(meshes):
    keys, _ = _keys()
    mx = mi.build_mesh_index(keys, keys, n_devices=1, n_shards=8, rank=0,
                             device="cuda")
    with pytest.raises(ValueError, match="mesh is cpu"):
        mi.search_mesh(mx, torch.zeros(4, dtype=torch.int32, device="cuda"),
                       mesh=meshes["cpu"])
