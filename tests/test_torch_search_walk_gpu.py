"""The recording search walk (K14, ``csrc/search_walk.cu``) on the card
against its plain versions, bit for bit in every output.

``search``, ``contains`` and ``search_validated`` launch K14 once a call on
the card (``kernels.search_walk``, counted in ``search_walk.launches``);
``search_fast`` launches K1 or K2 (``kernels.ops.search_kernel``) and no
K14.  All run their host loops on the CPU.  Each card result must equal
the plain version run on the same card state and the CPU run on the same
state built there: found, vals, node, preds, steps and gathers.  Cases: foresight and base lists at node widths 1, 8 and 128,
``stop_level`` 0 and 2, lists after inserts and deletes through the update
kernel (K11: node ids out of key order, freed slots reused), a 2^16-key
list after 4096 mixed ops, an empty batch, ``KEY_MAX`` queries, the
validated read on 40% corrupt foreseen keys and on a lag-1 view, a strided
query view; and a corrupt table, whose walk must end in the kernel's
trap.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_search_walk_gpu.py
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import skiplist as tsl
from repro_torch.core import validated as tval
from repro_torch.core.versioned import VersionedIndex
from repro_torch.kernels import foresight_traverse as ft
from repro_torch.kernels import search_walk as sw

pytestmark = pytest.mark.gpu
DEVICES = ("cuda", "cpu")
KEY_MAX = 2**31 - 1
KEY_MIN = -2**31
SPAN = 1 << 16
FIELDS = tsl.SearchResult._fields


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _keys(n, seed=0, span=SPAN):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(span, n, replace=False)).astype(np.int32)


def _queries(keys, seed, batch=300, span=SPAN):
    rng = np.random.default_rng(seed)
    edge = [KEY_MAX, int(keys[0]), int(keys[0]) - 1, KEY_MIN + 1]
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, span, batch // 2), edge]
                          ).astype(np.int32)


def _same(got, want, fields):
    for name, g, w in zip(fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w.cpu()), name


def _mixed_ops(keys, n, seed, span=SPAN):
    """Deletes of live keys, inserts of new ones (freed slots reused) and
    reads, interleaved."""
    rng = np.random.default_rng(seed)
    ops = rng.choice(np.array([tsl.OP_READ, tsl.OP_INSERT, tsl.OP_DELETE],
                              np.int32), n, p=[0.2, 0.4, 0.4])
    ks = np.where(ops == tsl.OP_INSERT, rng.integers(0, span, n),
                  rng.choice(keys, n)).astype(np.int32)
    return ops, ks, ks * 5 + 2


def _states(width, foresight, n=300, churn=0, span=SPAN, levels=9):
    """The same list built on the card and on the CPU, after ``churn``
    mixed ops (through the update kernel on the card, its plain version on
    the CPU); (keys, {device: state})."""
    keys = _keys(n, span=span)
    cap = (2 * n + 2 * churn + 16 if width == 1
           else (2 * n + 2 * churn) // tsl.pack_fill(width) + 16)
    out = {}
    for dev in DEVICES:
        st = tsl.build(keys, keys * 3 + 1, capacity=cap, levels=levels,
                       foresight=foresight, seed=2, node_width=width,
                       device=dev)
        if churn:
            ops = _mixed_ops(keys, churn, 7, span)
            st, _ = tsl.apply_ops(st, *(torch.from_numpy(a).to(dev)
                                        for a in ops))
        out[dev] = st
    return keys, out


def _check_search(st, q_np, stop=0):
    """K14 on the card against the plain version on the card and the CPU;
    returns the card's result."""
    q = {dev: torch.from_numpy(q_np).to(dev) for dev in DEVICES}
    before = sw.search_walk.launches
    got = tsl.search(st["cuda"], q["cuda"], stop_level=stop)
    assert sw.search_walk.launches == before + 1
    _same(got, tsl.search_plain(st["cuda"], q["cuda"], stop_level=stop),
          FIELDS)
    _same(got, tsl.search(st["cpu"], q["cpu"], stop_level=stop), FIELDS)
    assert sw.search_walk.launches == before + 1
    walk = ft.foresight_traverse if st["cuda"].foresight else ft.base_traverse
    walks = walk.launches
    fast = tsl.search_fast(st["cuda"], q["cuda"])
    assert sw.search_walk.launches == before + 1
    assert walk.launches == walks + 1
    _same(fast, tsl.search_fast_plain(st["cuda"], q["cuda"]),
          ("found", "vals"))
    _same(fast, tsl.search_fast(st["cpu"], q["cpu"]), ("found", "vals"))
    return got


@pytest.mark.parametrize("stop", [0, 2])
@pytest.mark.parametrize("width", [1, 8, 128])
@pytest.mark.parametrize("foresight", [True, False])
def test_search_equals_its_plain_version(cuda, foresight, width, stop):
    keys, st = _states(width, foresight)
    q = _queries(keys, width + stop)
    got = _check_search(st, q, stop)
    assert not got.preds[:, :stop].any()
    if stop == 0:
        assert torch.equal(got.found.cpu(), torch.from_numpy(
            np.isin(q, keys) | (q == KEY_MAX)))
        assert torch.equal(tsl.contains(st["cuda"], torch.from_numpy(q)
                                        .cuda()).cpu(), got.found.cpu())


@pytest.mark.parametrize("width", [1, 8, 128])
@pytest.mark.parametrize("foresight", [True, False])
def test_search_after_the_update_kernels_inserts_and_deletes(cuda, foresight,
                                                             width):
    keys, st = _states(width, foresight, churn=400)
    for f in st["cpu"]._fields:                 # the same state on both
        a, b = getattr(st["cuda"], f), getattr(st["cpu"], f)
        assert (a is None) == (b is None) and (a is None or
                                               torch.equal(a.cpu(), b)), f
    q = np.concatenate([_queries(keys, 30 + width), keys[:64]])
    for stop in (0, 2):
        _check_search(st, q, stop)


def test_a_large_list_after_4096_mixed_ops(cuda):
    span = 1 << 22
    keys, st = _states(1, True, n=1 << 16, churn=4096, span=span, levels=18)
    q = _queries(keys, 5, batch=1 << 16, span=span)
    got = _check_search(st, q)
    assert int(got.steps) > 18 and int(got.gathers) > q.size * 18
    keys, st = _states(1, False, n=1 << 16, churn=4096, span=span, levels=18)
    _check_search(st, q)


def test_an_empty_batch_launches_nothing(cuda):
    _, st = _states(8, True)
    q = torch.zeros(0, dtype=torch.int32, device="cuda")
    before = sw.search_walk.launches
    got = tsl.search(st["cuda"], q)
    assert got.preds.shape == (0, 9) and got.found.dtype == torch.bool
    assert int(got.steps) == 0 and int(got.gathers) == 0
    assert tsl.search_fast(st["cuda"], q)[0].shape == (0,)
    assert tval.search_validated(st["cuda"].fused, st["cuda"].keys,
                                 st["cuda"].vals, q).node.shape == (0,)
    assert sw.search_walk.launches == before


@pytest.mark.parametrize("width", [1, 8, 128])
def test_key_max_is_found_with_null_val(cuda, width):
    _, st = _states(width, True)
    q = torch.full((40,), KEY_MAX, dtype=torch.int32, device="cuda")
    res = tsl.search(st["cuda"], q)
    assert res.found.all() and (res.vals == tsl.NULL_VAL).all()
    found, vals = tsl.search_fast(st["cuda"], q)
    assert found.all() and (vals == tsl.NULL_VAL).all()


def _views(kind):
    """{device: (fused, auth_keys, vals)} of a 40%-corrupt table or a lag-1
    view after an update batch with deletes, and the live keys."""
    keys = _keys(4000, 3, span=1 << 22)
    out = {}
    for dev in DEVICES:
        st = tsl.build(keys, keys + 1, capacity=8192, levels=14, seed=3,
                       device=dev)
        if kind == "corrupt":
            rng = np.random.default_rng(4)
            f = st.fused.cpu().numpy().copy()
            mask = rng.random(f.shape[:2]) < 0.4
            f[..., 1] = np.where(mask, rng.integers(-2**31 + 1, 2**31 - 1,
                                                    f.shape[:2]), f[..., 1])
            out[dev] = (torch.from_numpy(f).to(dev), st.keys, st.vals)
            continue
        vi = VersionedIndex(st)
        ops = _mixed_ops(keys, 600, 5, 1 << 22)
        vi.update(*(torch.from_numpy(a).to(dev) for a in ops))
        view = vi.read_view(lag=1)
        out[dev] = (view.fused, view.auth_keys, view.vals)
    return keys, out


@pytest.mark.parametrize("kind", ["corrupt", "lag1"])
def test_search_validated_equals_its_plain_version(cuda, kind):
    keys, views = _views(kind)
    q = _queries(keys, 9, batch=2048, span=1 << 22)
    q = {dev: torch.from_numpy(q).to(dev) for dev in DEVICES}
    before = sw.search_walk.launches
    got = tval.search_validated(*views["cuda"], q["cuda"])
    assert sw.search_walk.launches == before + 1
    _same(got, tval.search_validated_plain(*views["cuda"], q["cuda"]),
          FIELDS)
    _same(got, tval.search_validated(*views["cpu"], q["cpu"]), FIELDS)


@pytest.mark.parametrize("foresight", [True, False])
def test_a_strided_query_view_reads_as_its_copy(cuda, foresight):
    """A non-contiguous int32 view of queries (every other lane, a column
    of a 2-D tensor) reads as its contiguous copy does, on the card as on
    the CPU."""
    keys, st = _states(8, foresight)
    scalar = _states(1, True)[1]["cuda"]        # a fused table to validate
    q2 = torch.from_numpy(_queries(keys, 11).reshape(-1, 2)).cuda()
    for q in (q2.reshape(-1)[::2], q2[:, 1]):
        assert not q.is_contiguous()
        flat = q.contiguous()
        _same(tsl.search(st["cuda"], q), tsl.search(st["cuda"], flat),
              FIELDS)
        _same(tsl.search_fast(st["cuda"], q),
              tsl.search_fast(st["cuda"], flat), ("found", "vals"))
        _same(tsl.search(st["cuda"], q), tsl.search(st["cpu"], q.cpu()),
              FIELDS)
        table = (scalar.fused, scalar.keys, scalar.vals)
        _same(tval.search_validated(*table, q),
              tval.search_validated(*table, flat), FIELDS)


_CORRUPT = """
import torch
from repro_torch.core import skiplist as tsl
keys = list(range(10, 6000, 10))
st = tsl.build(keys, list(range(len(keys))), capacity=1024, levels=8,
               foresight={foresight}, seed=1, device="cuda")
# level 0 only: node 302 (key 3010) points back at node 102 (key 1010)
# with a key below every query, so a level-0 walk through 302 loops: the
# walk for 3015 passes it
y, back = 302, 102
if st.foresight:
    st.fused[0, y] = torch.tensor([back, 0], dtype=torch.int32)
else:
    st.nxt[0, y] = back
    st.keys[back] = 0
tsl.search(st, torch.tensor([3015], dtype=torch.int32, device="cuda"))
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("foresight", [True, False])
def test_a_corrupt_table_ends_in_the_trap(cuda, foresight):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_CORRUPT.format(
            foresight=foresight))],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "NO TRAP" not in proc.stdout, \
        proc.stdout + proc.stderr
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr, proc.stderr
