"""The rebalance kernel (K12, ``csrc/rebalance.cu``) on the card against its
plain version on the CPU, every array bit for bit.

The same port build on both devices; the card runs every pass through one
cooperative launch of K12 (``kernels.rebalance.rebalance_pass``), the CPU
through the host loops of ``core.rebalance_traced``.  Every state array
(``rng`` and the boundaries included), every result and every split and
merge count must agree.  Node widths 1, 8 and 128, foresight and base.
The flatten gathers each shard top-down over its towers: a split and a
merge are also held on shards whose towers are all of height 1 or all but
one node's, on shards at their full fill, and on a merge whose second
shard is empty; a level-0 cycle must fail the launch.
Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_rebalance_kernel_gpu.py
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.convert import sharded_to_numpy
from repro_torch.core import rebalance_traced as rbt
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import rebalance as rk

pytestmark = pytest.mark.gpu
DEVICES = ("cuda", "cpu")
WIDTHS = (1, 8, 128)
SPAN = 1 << 22


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _same(got, want):
    a, b = sharded_to_numpy(got), sharded_to_numpy(want)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _start(width, foresight, *, n_shards=4, ceiling=16, seed=0):
    """48 keys a fill unit over 4 shards of 16 node slots (12 of 14 full,
    tests/test_rebalance.py:220's start), padded to ``ceiling`` slots, on
    both devices."""
    fill = tsl.pack_fill(width)
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(SPAN, 48 * fill, replace=False)
                   ).astype(np.int32)
    out = {}
    for dev in DEVICES:
        shl = tsh.build_sharded(keys, keys * 3, n_shards=n_shards,
                                capacity=16, levels=8, foresight=foresight,
                                seed=seed, node_width=width, device=dev)
        out[dev] = rbt.pad_shards(shl, ceiling)
    return keys, out


def _zipf(keys, width, n_batches=4, seed=7):
    """Zipf(1.2)-ranked inserts folded into shard 0's key range."""
    fill = tsl.pack_fill(width)
    rng = np.random.default_rng(seed)
    hot = int(keys[2])
    return [(hot + (rng.zipf(1.2, 32 * fill) - 1) % (4096 * fill)
             ).astype(np.int32) for _ in range(n_batches)]


def _apply_both(st, ops, kk, seed):
    """The batch through the rebalancing apply at the ceiling on both
    devices (``_in_place``, as the page table and the mesh apply it)."""
    res = {}
    before = rk.rebalance_pass.launches
    for dev in DEVICES:
        inp = sharded_to_numpy(st[dev])
        st_new, res[dev] = tsh.apply_ops_sharded(
            st[dev], *(torch.from_numpy(a).to(dev) for a in (ops, kk, kk * 2)),
            rebalance=True, seed=seed, _in_place=True)
        _same_arrays(sharded_to_numpy(st[dev]), inp)   # input unchanged
        st[dev] = st_new
    assert rk.rebalance_pass.launches == before + 2    # guard + watermark
    assert torch.equal(res["cuda"].cpu(), res["cpu"])
    _same(st["cuda"], st["cpu"])
    return res["cpu"]


def _same_arrays(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_zipf_inserts_then_deletes_split_and_merge_like_the_cpu(
        cuda, width, foresight):
    keys, st = _start(width, foresight)
    live = int(rbt.live_shard_count(st["cpu"]))
    for b, kk in enumerate(_zipf(keys, width)):
        ops = np.full(kk.size, tsl.OP_INSERT, np.int32)
        _apply_both(st, ops, kk, seed=b)
    grown = int(rbt.live_shard_count(st["cuda"]))
    assert grown > live, "the stream split no shard"
    # delete most keys: the watermark pass merges the emptied shards
    drop = keys[: int(0.8 * keys.size)]
    for b, kk in enumerate(np.array_split(drop, 2)):
        ops = np.full(kk.size, tsl.OP_DELETE, np.int32)
        _apply_both(st, ops, kk.astype(np.int32), seed=10 + b)
    assert int(rbt.live_shard_count(st["cuda"])) < grown, "no merge ran"
    assert bool(tsh.check_sharded_invariant(st["cuda"]))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8])
def test_dead_slots_run_out_like_the_cpu(cuda, width, foresight):
    """One dead slot: the guard splits once, then stops; the inserts past
    the shard's capacity fail on both devices alike."""
    keys, st = _start(width, foresight, ceiling=5)
    failed = 0
    for b, kk in enumerate(_zipf(keys, width, n_batches=3)):
        ops = np.full(kk.size, tsl.OP_INSERT, np.int32)
        res = _apply_both(st, ops, kk, seed=b)
        failed += int((res == 0).sum())
    assert int(rbt.live_shard_count(st["cuda"])) == 5
    assert failed > 0


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_passes_and_given_edits_with_counts_like_the_cpu(cuda, width,
                                                         foresight):
    keys, st = _start(width, foresight)
    fill = tsl.pack_fill(width)
    kk = (int(keys[2]) + (np.random.default_rng(9).zipf(1.2, 96 * fill) - 1)
          % (4096 * fill)).astype(np.int32)
    ins = np.full(kk.size, tsl.OP_INSERT, np.int32)
    got = {}
    for dev in DEVICES:
        x = st[dev]
        at = torch.tensor(int(x.boundaries[1].cpu()) + 1, dtype=torch.int32,
                          device=dev)
        x = rbt.split_shard_traced(x, 1, at, seed=5)
        x = rbt.merge_shards_traced(x, torch.tensor(1, device=dev), seed=3)
        x, stats = rbt.watermark_rebalance_traced(x, seed=2)
        y, splits = rbt.exhaustion_guard_traced(
            x, torch.from_numpy(ins).to(dev), torch.from_numpy(kk).to(dev),
            seed=11)
        assert stats.splits.device.type == dev and stats.splits.dim() == 0
        assert splits.device.type == dev and splits.dtype == torch.int32
        got[dev] = (x, y, [int(stats.splits), int(stats.merges),
                           int(splits)], int(rbt.live_shard_count(y)))
    _same(got["cuda"][0], got["cpu"][0])
    _same(got["cuda"][1], got["cpu"][1])
    assert got["cuda"][2:] == got["cpu"][2:]
    assert got["cpu"][2][2] > 0, "the guard split nothing"


@pytest.mark.parametrize("foresight", [True, False])
def test_a_pass_with_nothing_to_do_is_one_launch_and_changes_nothing(
        cuda, foresight):
    keys, st = _start(1, foresight)
    x = st["cuda"]
    y, stats = rbt.watermark_rebalance_traced(x, high_water=0.99,
                                              low_water=0.01)
    before = rk.rebalance_pass.launches
    y, stats = rbt.watermark_rebalance_traced(x, high_water=0.99,
                                              low_water=0.01)
    z, splits = rbt.exhaustion_guard_traced(
        x, torch.full((4,), tsl.OP_INSERT, dtype=torch.int32, device="cuda"),
        torch.from_numpy(keys[:4]).cuda())
    assert rk.rebalance_pass.launches == before + 2
    assert (int(stats.splits), int(stats.merges), int(splits)) == (0, 0, 0)
    _same(y, x)
    _same(z, x)


@pytest.mark.parametrize("case", ["dead", "live"])
@pytest.mark.parametrize("width", [1, 8])
def test_guard_median_at_the_minimum_and_indivisible_mass_like_the_cpu(
        cuda, width, case):
    """A slot whose count says more than its keys, so its projection
    overflows: a dead slot (no key, live or incoming: the median is the
    minimum, KEY_MAX, and so is the next larger key) or a live shard with
    one incoming key (the median lies past its keys, at KEY_MAX).  Either
    way the key mass is indivisible and the guard stops without a split,
    on both devices alike."""
    keys, st = _start(width, True)
    usable = tsl.usable_capacity(16, width)
    got = {}
    for dev in DEVICES:
        x = rbt.working_copy(st[dev])
        if case == "dead":
            s, kk, op = x.n_shards - 1, keys[:1], tsl.OP_READ
        else:
            kk = np.asarray([int(keys[-1]) + 7], np.int32)
            s = int(tsh.route(x.boundaries.cpu(), torch.from_numpy(kk))[0])
            op = tsl.OP_INSERT
        x.shards.n[s] = 2 * usable - (op == tsl.OP_INSERT)
        y, splits = rbt.exhaustion_guard_traced(
            x, torch.full((1,), op, dtype=torch.int32, device=dev),
            torch.from_numpy(kk).to(dev), seed=1)
        got[dev] = (y, int(splits))
    _same(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1] == got["cpu"][1] == 0


def _to(shl, dev):
    return tsh.ShardedSkipList(
        tsl.SkipListState(*(None if t is None else t.to(dev)
                            for t in shl.shards)), shl.boundaries.to(dev))


def _cut_towers(st, tall=None):
    """Every tower of ``st`` (a shard's views) cut to level 0 but node
    ``tall``'s, raised to every level: above level 0 the head points at
    ``tall`` (or the tail) and ``tall`` at the tail."""
    live = (torch.arange(st.capacity) >= 2) & (st.height > 0)
    st.height[live] = 1
    top = tsl.TAIL if tall is None else tall
    if tall is not None:
        st.height[tall] = st.levels
    for lvl in range(1, st.levels):
        if st.foresight:
            st.fused[lvl, tsl.HEAD] = torch.tensor(
                [top, int(st.keys[top])], dtype=torch.int32)
            if tall is not None:
                st.fused[lvl, tall] = torch.tensor([tsl.TAIL, 2**31 - 1],
                                                   dtype=torch.int32)
        else:
            st.nxt[lvl, tsl.HEAD] = top
            if tall is not None:
                st.nxt[lvl, tall] = tsl.TAIL


def _split_then_merge(shl, s, at):
    """A given split of shard s at ``at``, then the merge of its halves,
    on both devices from the same CPU state: every array equal."""
    st = {"cpu": shl, "cuda": _to(shl, "cuda")}
    got = {}
    for dev in DEVICES:
        x = rbt.split_shard_traced(
            st[dev], s, torch.tensor(at, dtype=torch.int32, device=dev),
            seed=5)
        y = rbt.merge_shards_traced(x, torch.tensor(s, device=dev), seed=3)
        got[dev] = (x, y)
    _same(got["cuda"][0], got["cpu"][0])
    _same(got["cuda"][1], got["cpu"][1])


@pytest.mark.parametrize("shape", ["flat", "one_tall"])
@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_split_and_merge_over_cut_towers_like_the_cpu(cuda, width,
                                                      foresight, shape):
    """Shard 1 of 4 (64 node slots, 10 levels) with every tower of height
    1, or every tower but its middle node's: the flatten gathers it from
    one segment, or two, and the split and merge equal the plain version."""
    fill = tsl.pack_fill(width)
    keys = np.sort(np.random.default_rng(3).choice(
        SPAN, 4 * 50 * fill, replace=False)).astype(np.int32)
    shl = rbt.pad_shards(tsh.build_sharded(
        keys, keys * 3, n_shards=4, capacity=64, levels=10,
        foresight=foresight, seed=2, node_width=width, device="cpu"), 8)
    nodes = int(shl.shards.bump[1]) - 2
    _cut_towers(tsh.shard_view(shl.shards, 1),
                None if shape == "flat" else 2 + nodes // 2)
    part = keys[50 * fill:100 * fill]
    _split_then_merge(shl, 1, int(part[part.size // 2]) + 1)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_split_and_merge_at_full_fill_like_the_cpu(cuda, width, foresight):
    """Four shards of 64 node slots built at their full fill (every node
    slot used), padded to 8: shard 2 split at its median and merged back."""
    fill = tsl.pack_fill(width)
    usable = tsl.usable_capacity(64, width)
    keys = np.sort(np.random.default_rng(4).choice(
        SPAN, 4 * usable, replace=False)).astype(np.int32)
    shl = rbt.pad_shards(tsh.build_sharded(
        keys, keys * 3, n_shards=4, capacity=64, levels=10,
        foresight=foresight, seed=2, node_width=width, device="cpu"), 8)
    assert int(shl.shards.n[2]) == usable and \
        int(shl.shards.bump[2]) == 64, "the shard is not at full fill"
    part = keys[2 * usable:3 * usable]
    _split_then_merge(shl, 2, int(part[usable // 2]))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_merge_into_an_empty_shard_like_the_cpu(cuda, width, foresight):
    """Every key of shard 2 deleted, then shards 1 and 2 merged: the
    second flatten gathers nothing."""
    keys, st = _start(width, foresight)
    cpu = st["cpu"]
    b = cpu.boundaries.numpy()
    gone = keys[(keys >= b[2]) & (keys < b[3])]
    ops = np.full(gone.size, tsl.OP_DELETE, np.int32)
    cpu, _ = tsh.apply_ops_sharded(cpu, ops, gone, gone)
    assert int(cpu.shards.n[2]) == 0
    st = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    got = {dev: rbt.merge_shards_traced(st[dev], torch.tensor(1, device=dev),
                                        seed=4) for dev in DEVICES}
    _same(got["cuda"], got["cpu"])


_CYCLE = """
import numpy as np
import torch
from repro_torch.core import rebalance_traced as rbt
from repro_torch.core import sharded as tsh
keys = np.arange(10, 4010, 10, dtype=np.int32)
shl = rbt.pad_shards(tsh.build_sharded(
    keys, keys, n_shards=2, capacity=512, levels=8, foresight={foresight},
    seed=1, device="cuda"), 4)
# shard 0's level 0 only: node 150 points back at node 20, so the walk of
# the segment that holds it loops
st = tsh.shard_view(shl.shards, 0)
if st.foresight:
    st.fused[0, 150] = torch.tensor([20, int(st.keys[20])], dtype=torch.int32)
else:
    st.nxt[0, 150] = 20
rbt.split_shard_traced(shl, 0, torch.tensor(1000, dtype=torch.int32,
                                            device="cuda"), seed=1)
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("foresight", [True, False])
def test_a_level0_cycle_fails_the_flatten_and_does_not_hang(cuda,
                                                           foresight):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_CYCLE.format(
            foresight=foresight))],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "NO TRAP" not in proc.stdout, \
        proc.stdout + proc.stderr
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr, proc.stderr
