"""The scan kernel (K13, ``csrc/range_scan.cu``) on the card against its
plain version on the CPU, bit for bit.

The same port build on both devices; ``range_scan``, ``to_sorted_keys``
and ``range_scan_sharded`` run one launch of K13 on the card
(``kernels.range_scan.range_scan_batch``) and the host loops on the CPU.
Keys, vals and counts must agree on the cases the scans must meet:
``max_out`` hit, ``lo`` past every key, ``hi`` at ``KEY_MAX``, a spill
across shards, across emptied shards and into the dead slots, and a fat
run straddling ``lo``.  Node widths 1, 8 and 128, foresight and base.
Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_scan_kernel_gpu.py
"""
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
