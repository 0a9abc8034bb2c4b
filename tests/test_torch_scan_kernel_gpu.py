"""The scan kernel (K13, ``csrc/range_scan.cu``) on the card against its
plain version on the CPU, bit for bit.

The same port build on both devices; ``range_scan``, ``to_sorted_keys``
and ``range_scan_sharded`` run one launch of K13 on the card
(``kernels.range_scan.range_scan_batch``) and the host loops on the CPU.
Keys, vals and counts must agree on the cases the scans must meet:
``max_out`` hit, ``lo`` past every key, ``hi`` at ``KEY_MAX``, a spill
across shards, across emptied shards and into the dead slots, and a fat
run straddling ``lo``; and, for the warp's top-down gather (a scalar scan
of ``rs.GATHER_FROM`` pairs or more, every fat scan), ``max_out`` of 1,
32, 33, either side of ``GATHER_FROM`` and the whole list,
``max_out`` cutting inside a segment and inside a fat run, lists whose
towers are all of height 1 or all but one node's, and a level-0 cycle,
which must fail the launch.  Node widths 1, 8 and 128, foresight and base.
Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_scan_kernel_gpu.py
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import rebalance_traced as rbt
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import range_scan as rs

pytestmark = pytest.mark.gpu
DEVICES = ("cuda", "cpu")
KEY_MAX = 2**31 - 1
KEY_MIN = -2**31
SPAN = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32)


def _cases(keys, width):
    """(lo, hi, max_out): max_out hit, the whole list, lo past every key,
    hi at KEY_MAX, lo below every key, an empty range, lo inside a run
    (fat: a run straddles it), lo on a key."""
    k = keys
    mid = int(k[k.size // 2])
    return [(int(k[3]), int(k[-3]), 5), (int(k[0]), int(k[-1]) + 1, k.size),
            (int(k[-1]) + 1, KEY_MAX, 8), (mid, KEY_MAX, 40),
            (-5, int(k[10]), 64), (mid, mid, 4),
            (mid + 1, mid + 3 * max(1, width), 30),
            (int(k[k.size // 3]), int(k[k.size // 3]) + 500, 1000)]


def _same_scan(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g.cpu(), w), (g, w)


def _mono(width, foresight, n=300):
    keys = _keys(n)
    cap = 2 * n + 16 if width == 1 else 2 * n // tsl.pack_fill(width) + 16
    return keys, {dev: tsl.build(keys, keys * 3 + 1, capacity=cap, levels=9,
                                 foresight=foresight, seed=2,
                                 node_width=width, device=dev)
                  for dev in DEVICES}


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_monolithic_scans_and_sorted_keys_equal_the_cpu(cuda, width,
                                                        foresight):
    keys, st = _mono(width, foresight)
    before = rs.range_scan_batch.launches
    cases = _cases(keys, width)
    for lo, hi, m in cases:
        _same_scan(tsl.range_scan(st["cuda"], lo, hi, m),
                   tsl.range_scan(st["cpu"], lo, hi, m))
    for m in (1, 40, keys.size + 5):
        _same_scan([tsl.to_sorted_keys(st["cuda"], m)],
                   [tsl.to_sorted_keys(st["cpu"], m)])
    assert rs.range_scan_batch.launches == before + len(cases) + 3


def _sharded(width, foresight):
    """400 keys over 8 shards of 128 node slots, padded to 12 slots; then
    the keys of shards 2 and 3 deleted (live but empty shards to spill
    across)."""
    keys = _keys(400, seed=1)
    out = {}
    for dev in DEVICES:
        shl = rbt.pad_shards(tsh.build_sharded(
            keys, keys * 5, n_shards=8, capacity=128, levels=8,
            foresight=foresight, seed=3, node_width=width, device=dev), 12)
        b = shl.boundaries.cpu().numpy()
        gone = keys[(keys >= b[2]) & (keys < b[4])]
        ops = np.full(gone.size, tsl.OP_DELETE, np.int32)
        shl, _ = tsh.apply_ops_sharded(shl, ops, gone, gone)
        out[dev] = shl
    live = np.setdiff1d(keys, gone)
    return live, b, out


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_sharded_scans_spill_like_the_cpu(cuda, width, foresight):
    keys, b, st = _sharded(width, foresight)
    cases = _cases(keys, width) + [
        (int(b[1]) + 1, int(b[6]), 200),       # across two emptied shards
        (int(b[7]), KEY_MAX, 100),              # the last live shard, then
        (int(keys[-1]), KEY_MAX, 3),            # the dead slots
        (int(b[2]), int(b[4]), 10)]             # only emptied shards
    before = rs.range_scan_batch.launches
    for lo, hi, m in cases:
        got = tsh.range_scan_sharded(st["cuda"], lo, hi, m)
        want = tsh.range_scan_sharded(st["cpu"], lo, hi, m)
        _same_scan(got, want)
        sel = keys[(keys >= lo) & (keys < hi)][:m]
        assert int(want[2]) == sel.size
        np.testing.assert_array_equal(want[0][:sel.size].numpy(), sel)
    assert rs.range_scan_batch.launches == before + len(cases)


def test_a_batch_of_scans_is_one_launch(cuda):
    keys, st = _mono(8, True)
    cases = _cases(keys, 8)
    lo = torch.tensor([c[0] for c in cases], dtype=torch.int32)
    hi = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    stacks = {dev: tsl._stack_of_one(st[dev]) for dev in DEVICES}
    before = rs.range_scan_batch.launches
    got = rs.range_scan_batch(stacks["cuda"], None, lo.cuda(), hi.cuda(), 64)
    want = rs.range_scan_batch(stacks["cpu"], None, lo, hi, 64)
    assert rs.range_scan_batch.launches == before + 1
    _same_scan(got, want)


def _to(st, dev):
    return tsl.SkipListState(*(None if t is None else t.to(dev) for t in st))


def _cut_towers(st, tall=None):
    """Every tower of ``st`` (views: writes reach a stack) cut to level 0
    but node ``tall``'s, raised to every level: above level 0 the head
    points at ``tall`` (or the tail) and ``tall`` at the tail."""
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
                st.fused[lvl, tall] = torch.tensor([tsl.TAIL, KEY_MAX],
                                                   dtype=torch.int32)
        else:
            st.nxt[lvl, tsl.HEAD] = top
            if tall is not None:
                st.nxt[lvl, tall] = tsl.TAIL


def _long_cases(keys, width):
    """(lo, hi, max_out) for the top-down gather: max_out of 1, 32, 33,
    either side of GATHER_FROM (lane 0's walk, then the warp's gather), 64
    and the whole list from the first key; max_out cutting inside a
    segment (77, 129) and, at width 8 and 128, inside a run (an odd count
    past a run's start); a range cut by hi inside the list; everything
    from KEY_MIN; one key."""
    k = keys
    fill = tsl.pack_fill(width)
    return ([(int(k[0]), KEY_MAX, m)
             for m in sorted({1, 32, 33, rs.GATHER_FROM - 1, rs.GATHER_FROM,
                              64, 77, 129, k.size, k.size + 9})]
            + [(int(k[7]) + 1, int(k[-20]), 101),
               (int(k[3 * fill + 1]), KEY_MAX, 5 * fill + 3),
               (KEY_MIN, KEY_MAX, 2 * k.size),
               (int(k[100]), int(k[100]) + 1, 40)])


@pytest.mark.parametrize("shape", ["built", "flat", "one_tall"])
@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_long_scans_over_any_towers_equal_the_cpu(cuda, width, foresight,
                                                  shape):
    """600 keys on 10 levels, their towers as built, all of height 1, or
    all of height 1 but one node's at every level: every long scan and
    ``to_sorted_keys`` equal the plain version."""
    keys = _keys(600, seed=4)
    fill = tsl.pack_fill(width)
    nodes = -(-keys.size // fill)
    cpu = tsl.build(keys, keys * 7 + 2, capacity=2 * nodes + 8, levels=10,
                    foresight=foresight, seed=5, node_width=width,
                    device="cpu")
    if shape != "built":
        _cut_towers(cpu, None if shape == "flat" else 2 + nodes // 2)
    st = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    for lo, hi, m in _long_cases(keys, width):
        _same_scan(tsl.range_scan(st["cuda"], lo, hi, m),
                   tsl.range_scan(st["cpu"], lo, hi, m))
    for m in (1, 32, 33, rs.GATHER_FROM - 1, rs.GATHER_FROM, 100,
              nodes + 5):
        _same_scan([tsl.to_sorted_keys(st["cuda"], m)],
                   [tsl.to_sorted_keys(st["cpu"], m)])


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_long_sharded_scans_spill_like_the_cpu(cuda, width, foresight):
    """The top-down gather shard by shard: across the two emptied shards,
    into the dead slots, max_out of 1, 32, 33, either side of GATHER_FROM
    and every key."""
    keys, b, st = _sharded(width, foresight)
    cases = [(int(b[1]) + 1, KEY_MAX, m) for m in sorted(
        {1, 32, 33, rs.GATHER_FROM - 1, rs.GATHER_FROM, 65, 150})]
    cases += [(KEY_MIN, KEY_MAX, keys.size), (KEY_MIN, KEY_MAX, 2 * keys.size),
              (int(b[5]) - 1, KEY_MAX, 97), (int(b[1]), int(b[5]), 70)]
    for lo, hi, m in cases:
        got = tsh.range_scan_sharded(st["cuda"], lo, hi, m)
        want = tsh.range_scan_sharded(st["cpu"], lo, hi, m)
        _same_scan(got, want)
        sel = keys[(keys >= lo) & (keys < hi)][:m]
        assert int(want[2]) == sel.size


_CYCLE = """
import torch
from repro_torch.core import skiplist as tsl
keys = list(range(10, 6000, 10))
st = tsl.build(keys, list(range(len(keys))), capacity=1024, levels=8,
               foresight={foresight}, seed=1, device="cuda")
# level 0 only: node 302 points back at node 102, so the walk of the
# segment that holds it loops
y, back = 302, 102
if st.foresight:
    st.fused[0, y] = torch.tensor([back, int(st.keys[back])],
                                  dtype=torch.int32)
else:
    st.nxt[0, y] = back
tsl.range_scan(st, 0, 2**31 - 1, 500)
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("foresight", [True, False])
def test_a_level0_cycle_fails_a_long_scan_and_does_not_hang(cuda,
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
