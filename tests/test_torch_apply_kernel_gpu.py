"""The update kernel (``csrc/apply_ops.cu``) on the card against its plain
version on the CPU: seeded mixed streams (op types -1 .. 3, a list filled
until allocation is refused, ``KEY_MAX``'s cases) on monolithic and
stacked states, scalar and fat (node widths 6, 8, 33, 128 and 256),
foresight and base; every state array, the rng included, and every result
equal.  Streams that make the kernel's window of walks conflict: runs of
consecutive keys, a key inserted, deleted and inserted again, a freed id
reused, fat splits and minimum-lane deletes, a 3-level list, batches of
fewer ops than a window and of a window and one op; a free-list pop past
``cap``.  Also: every writer reaches the kernel on CUDA tensors, the fat
cases and the window checks are counted on the device, an input state is
left unchanged, and a table with a cycle fails the launch (the walk's
trap) instead of hanging.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_apply_kernel_gpu.py
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.core.versioned import VersionedIndex
from repro_torch.kernels import apply_ops as tap

pytestmark = pytest.mark.gpu
KEY_MAX = 2**31 - 1
SPAN = 1 << 14


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stream(seed, n, keys, span=SPAN, fill=0):
    """``fill`` fresh inserts, ``n`` mixed ops of types -1 .. 3 on keys half
    present, then ``KEY_MAX``'s insert, read, delete and read."""
    rng = np.random.default_rng(seed)
    fresh = rng.choice(np.setdiff1d(np.arange(span), keys), fill,
                       replace=False)
    ops = np.concatenate([np.full(fill, 1), rng.integers(-1, 4, n),
                          [1, 0, 2, 0]]).astype(np.int32)
    ks = np.concatenate([fresh, np.where(
        rng.random(n) < 0.5, rng.choice(keys, n), rng.integers(0, span, n)),
        np.full(4, KEY_MAX)]).astype(np.int32)
    return [torch.from_numpy(a) for a in
            (ops, ks, (ks * 5 + 3).astype(np.int32))]


def _same(got: tsl.SkipListState, want: tsl.SkipListState, what=""):
    for name, t in got._asdict().items():
        if t is not None:
            assert torch.equal(t.cpu(), getattr(want, name).cpu()), \
                f"{what} {name}"


def _on(dev, *ts):
    return [t.to(dev) for t in ts]


@pytest.mark.parametrize("width", [1, 6, 8, 33, 128, 256])
@pytest.mark.parametrize("foresight", [True, False])
def test_monolithic_kernel_equals_plain(cuda, foresight, width):
    keys = np.sort(np.random.default_rng(width).choice(
        SPAN, 900, replace=False)).astype(np.int32)
    cap = 1000 if width == 1 else tsl.node_slots_for(900, width) + 3
    kw = dict(capacity=cap, levels=10, foresight=foresight, seed=width,
              node_width=width)
    st = tsl.build(keys, keys * 2, device=cuda, **kw)
    cpu = tsl.build(keys, keys * 2, device="cpu", **kw)
    fill = 400 if width <= 8 else 1400       # past the runs' room
    stream = _stream(3 + width, 1200, keys, fill=fill)
    before = tap.apply_ops_batch.launches
    new, res = tsl.apply_ops(st, *_on(cuda, *stream))
    assert tap.apply_ops_batch.launches == before + 1
    new_cpu, res_cpu = tsl.apply_ops(cpu, *stream)
    assert torch.equal(res.cpu(), res_cpu)
    _same(new, new_cpu, "state")
    _same(st, cpu, "input unchanged")
    assert (res_cpu[:fill] == 0).any()       # the list filled up


@pytest.mark.parametrize("width", [1, 8, 128])
@pytest.mark.parametrize("foresight", [True, False])
def test_stacked_kernel_equals_plain(cuda, foresight, width):
    """8 shards, one left without ops, one taking a third of the batch."""
    keys = np.sort(np.random.default_rng(9).choice(
        1 << 20, 4000, replace=False)).astype(np.int32)
    kw = dict(n_shards=8, levels=10, foresight=foresight, seed=2,
              node_width=width)
    shl = tsh.build_sharded(keys, keys * 3, device=cuda, **kw)
    cpu = tsh.build_sharded(keys, keys * 3, device="cpu", **kw)
    b = cpu.boundaries.numpy()
    ops, ks, vs = _stream(5 + width, 1500, keys, span=1 << 20, fill=200)
    k = ks.numpy()
    k = np.where((k >= b[3]) & (k < b[4]), b[5], k)      # shard 3: no ops
    k[::3] = b[6] + k[::3] % (b[7] - b[6])               # shard 6: a third
    ks = torch.from_numpy(k.astype(np.int32))
    vs = ks * 5 + 3
    before = tap.apply_ops_batch.launches
    got, res = tsh.apply_ops_sharded(shl, *_on(cuda, ops, ks, vs))
    assert tap.apply_ops_batch.launches == before + 1
    want, res_cpu = tsh.apply_ops_sharded(cpu, ops, ks, vs)
    assert torch.equal(res.cpu(), res_cpu)
    _same(got.shards, want.shards, "stack")
    _same(shl.shards, cpu.shards, "input unchanged")


def test_fat_cases_are_counted_on_the_device(cuda):
    """A stream that runs every fat case (the first node of an empty list,
    shifts, a split, upserts, deletes of a minimum and of an inner lane,
    emptied runs), counted on the card as the plain version counts it."""
    rng = np.random.default_rng(1)
    fill = rng.permutation(10).astype(np.int32)
    ks = np.concatenate([fill, fill[:4], rng.integers(0, 10, 32),
                         rng.permutation(10), fill[:3]]).astype(np.int32)
    ops = np.concatenate([np.full(14, 1), rng.integers(1, 3, 32),
                          np.full(10, 2), np.full(3, 1)]).astype(np.int32)
    stream = [torch.from_numpy(a) for a in (ops, ks, ks * 5 + 1)]
    empty = tsl.empty(8, 6, node_width=8, device=cuda)
    tap.reset_fat_cases(cuda)
    tsl.apply_ops(empty, *_on(cuda, *stream))
    tsl.FAT_CASES.clear()
    tsl.apply_ops(tsl.empty(8, 6, node_width=8, device="cpu"), *stream)
    got = tap.fat_cases(cuda)
    assert got == tsl.FAT_CASES
    for case in tap.CASE_NAMES:
        assert got[case] > 0, case


def test_every_writer_reaches_the_kernel(cuda):
    keys = np.arange(10, 2000, 10, dtype=np.int32)
    st = tsl.build(keys, keys, capacity=512, levels=8, device=cuda)
    n0 = tap.apply_ops_batch.launches
    st2, ok = tsl.insert(st, 15, 7)
    assert bool(ok) and ok.device.type == "cuda" and ok.shape == ()
    st3, ok = tsl.delete(st2, 15)
    assert bool(ok) and not bool(tsl.delete(st3, 15)[1])
    vi = VersionedIndex(st)
    res = vi.update(*_on(cuda, *[torch.tensor(a, dtype=torch.int32) for a in
                                 ([1, 0, 2], [5, 5, 10], [1, 1, 1])]))
    assert res.tolist() == [1, 1, 1]
    assert tap.apply_ops_batch.launches == n0 + 4


def _kernel_and_plain(cuda, st_cpu, stream):
    """``stream`` through ``apply_ops`` on a card copy of ``st_cpu`` (the
    kernel, one launch) and on the CPU (the plain version): every array,
    the rng included, and every result equal.  Returns the kernel's
    window checks."""
    st = tsl.SkipListState(*(None if t is None else t.to(cuda)
                             for t in st_cpu))
    tap.reset_fat_cases(cuda)
    before = tap.apply_ops_batch.launches
    new, res = tsl.apply_ops(st, *_on(cuda, *stream))
    assert tap.apply_ops_batch.launches == before + 1
    new_cpu, res_cpu = tsl.apply_ops(st_cpu, *stream)
    assert torch.equal(res.cpu(), res_cpu)
    _same(new, new_cpu, "state")
    checks = tap.window_checks(cuda)
    assert checks["ops_stood"] + checks["walks_resumed"] == len(stream[1])
    assert checks["resumed_steps"] >= checks["walks_resumed"]
    return checks


def _ops(*parts):
    """(type, key) runs -> the three int32 op tensors, vals key * 5 + 3."""
    ops = np.concatenate([np.full(len(k), t) for t, k in parts])
    ks = np.concatenate([np.asarray(k) for _, k in parts])
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (ops, ks, ks * 5 + 3)]


I, R, D = 1, 0, 2


def _conflict_case(case, width):
    """(start keys, levels, stream) of a case that makes the window's
    recorded predecessors fail their check."""
    W = tap.WINDOW
    keys = np.arange(1000, 1000 + 40 * 64, 64, dtype=np.int32)
    if case == "runs":              # 16-op grants of consecutive ids
        grants = [np.arange(b, b + 16) for b in (1100, 1300, 990, 1116)]
        return keys, 10, _ops(*[(I, g) for g in grants], (R, grants[0]),
                              (D, grants[1]), (I, grants[1][::-1]),
                              (D, np.concatenate(grants[2:])))
    if case == "reinsert":          # one key in, out and in in a window
        k = [1050, 1050, 1050, 1064, 1064, 1064, 1051]
        return keys, 10, _ops(*[(t, [q]) for t, q in zip(
            (I, D, I, D, I, D, I), k)], (R, k), (I, np.arange(1040, 1080)))
    if case == "reuse":             # a freed id taken by the next insert
        pairs = [(D, [int(k)]) if i % 2 == 0 else (I, [int(k) + 7])
                 for i, k in enumerate(np.repeat(keys[2:22], 2))]
        return keys, 10, _ops(*pairs, (R, keys[:30]))
    if case == "three_levels":
        return keys, 3, _ops((I, np.arange(1001, 1001 + 3 * W, 3)),
                             (D, keys[::2]), (I, keys[::4] + 1),
                             (R, np.arange(1000, 1100)))
    if case == "short":             # fewer ops than a window
        return keys, 10, _ops((I, [1001, 1002, 1003]), (D, [1064]),
                              (R, [1001, 1064, 1128]))
    assert case == "window_plus_one"
    return keys, 10, _ops((I, np.arange(1001, 1001 + W)), (D, [1001]))


@pytest.mark.parametrize("case", ["runs", "reinsert", "reuse",
                                  "three_levels", "short",
                                  "window_plus_one"])
@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_window_conflicts_kernel_equals_plain(cuda, foresight, width, case):
    keys, levels, stream = _conflict_case(case, width)
    st = tsl.build(keys, keys * 2, capacity=tsl.node_slots_for(
        len(keys), width) + 260, levels=levels, foresight=foresight,
        seed=7, node_width=width, device="cpu")
    checks = _kernel_and_plain(cuda, st, stream)
    if case in ("runs", "reinsert", "reuse", "three_levels"):
        assert checks["walks_resumed"] > 0, checks


@pytest.mark.parametrize("foresight", [True, False])
def test_fat_splits_and_minimum_deletes_inside_a_window(cuda, foresight):
    """B = 8 runs filled to a split and emptied from their minimum, a few
    ops apart, every window; each fat case ran on the card."""
    keys = np.arange(0, 8 * 24, 8, dtype=np.int32)      # 4 runs of 6
    fill = np.arange(1, 8 * 24, 8)[:20]
    stream = _ops((I, fill), (I, fill + 2), (D, keys[::3]), (I, fill + 4),
                  (I, keys[1::2]), (D, np.arange(0, 60)),
                  (I, [-5, -4, 9999]), (R, keys))
    st = tsl.build(keys, keys * 2, capacity=40, levels=6,
                   foresight=foresight, seed=3, node_width=8, device="cpu")
    _kernel_and_plain(cuda, st, stream)
    got = tap.fat_cases(cuda)
    for case in ("insert_room", "insert_split", "insert_upsert",
                 "delete_min", "delete_plain", "delete_emptied"):
        assert got[case] > 0, (case, got)


@pytest.mark.parametrize("foresight", [True, False])
def test_pop_past_cap_kernel_equals_plain(cuda, foresight):
    """12 deletes of KEY_MAX push the tail past ``cap``; the insert after
    them pops ``free_list[cap - 1]``, in one batch on both."""
    keys = np.array([5, 9, 13], np.int32)
    st = tsl.build(keys, keys * 2, capacity=8, levels=3, foresight=foresight,
                   seed=3, device="cpu")
    _kernel_and_plain(cuda, st, _ops((D, [KEY_MAX] * 12), (I, [7])))


_CYCLE = """
import torch
from repro_torch.core import skiplist as tsl
st = tsl.build(list(range(10, 400, 10)), list(range(39)), capacity=64,
               levels=6, foresight={foresight}, seed=1, device="cuda")
# the head points at itself below every key: every walk loops
if st.foresight:
    st.fused[:, tsl.HEAD] = torch.tensor([tsl.HEAD, -2**31], dtype=torch.int32)
else:
    st.nxt[:, tsl.HEAD] = tsl.HEAD
tsl.apply_ops(st, *[torch.tensor(a, dtype=torch.int32, device="cuda")
                    for a in ([1, 0], [55, 55], [1, 1])])
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("foresight", [True, False])
def test_a_cycle_fails_the_launch_and_does_not_hang(cuda, foresight):
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
