"""The eager reads on the CPU, where they run their plain versions:
``search`` and ``search_validated`` through the recording search walk's
wrappers (``repro_torch.kernels.search_walk``, K14; every ``SearchResult``
field: found, vals, node, preds, steps, gathers) and ``search_fast``
(K1/K2 on the card) against the reference's
``lax.while_loop`` reads, bit for bit, on seeded inputs: foresight and
base lists at node widths 1, 8 and 128, ``stop_level`` 0 and 2, lists
after inserts and deletes (node ids out of key order, freed slots
reused), an empty batch, ``KEY_MAX`` queries, and 40% of the foreseen keys
corrupted for the validated read.

Also a model of the kernel's own walk in numpy (one lane at a time, each
with its own loop; ``steps`` as the longest path and ``gathers`` as g
times the paths' sum) against the same reference answers, and the
wrappers' refusals.  The card's cases are in
``tests/test_torch_search_walk_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as sl
from repro.core import validated as val
from repro_torch.convert import state_from_numpy
from repro_torch.core import skiplist as tsl
from repro_torch.core import validated as tval
from repro_torch.kernels import search_walk as sw

KEY_MAX = 2**31 - 1
KEY_MIN = -2**31
SPAN = 1 << 16
N, LEVELS = 300, 9
WIDTHS = (1, 8, 128)
FIELDS = sl.SearchResult._fields

_search = jax.jit(sl.search, static_argnames=("stop_level",))
_search_fast = jax.jit(sl.search_fast)
_validated = jax.jit(val.search_validated)
_apply = jax.jit(sl.apply_ops)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32)


def _arrays(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()
            if v is not None}


def _queries(keys, seed, batch=160):
    """Half keys, half draws from the span, and the edges: KEY_MAX, the
    least key, one below it and KEY_MIN + 1."""
    rng = np.random.default_rng(seed)
    edge = [KEY_MAX, int(keys[0]), int(keys[0]) - 1, KEY_MIN + 1]
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, SPAN, batch // 2), edge]
                          ).astype(np.int32)


def _churn(ref, keys, width):
    """The reference state after 240 mixed ops: deletes of live keys, then
    inserts of new ones that reuse the freed slots, then more deletes.
    Returns (state, live keys)."""
    rng = np.random.default_rng(7)
    gone = rng.choice(keys, 80, replace=False)
    new = np.setdiff1d(rng.choice(SPAN, 200, replace=False), keys)[:80]
    later = rng.choice(np.setdiff1d(keys, gone), 80, replace=False)
    ks = np.concatenate([gone, new, later]).astype(np.int32)
    ts = np.repeat([sl.OP_DELETE, sl.OP_INSERT, sl.OP_DELETE], 80
                   ).astype(np.int32)
    ref, _ = _apply(ref, jnp.asarray(ts), jnp.asarray(ks),
                    jnp.asarray(ks * 5 + 2))
    live = np.setdiff1d(np.union1d(keys, new), np.union1d(gone, later))
    return ref, live.astype(np.int32)


class Reference:
    """Each reference state and result, computed once in the module."""

    def __init__(self):
        self._memo = {}

    def _once(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def state(self, width, foresight, churn=False):
        """(live keys, reference state, the port's copy on the CPU)."""
        def make():
            keys = _keys(N)
            cap = (2 * N + 16 if width == 1
                   else 2 * N // tsl.pack_fill(width) + 16)
            ref = sl.build(jnp.asarray(keys), jnp.asarray(keys * 3 + 1),
                           capacity=cap, levels=LEVELS, foresight=foresight,
                           seed=2, node_width=width)
            if churn:
                ref, keys = _churn(ref, keys, width)
            return keys, ref, state_from_numpy(_arrays(ref), device="cpu")
        return self._once(("state", width, foresight, churn), make)

    def search(self, width, foresight, churn, stop, q):
        _, ref, _ = self.state(width, foresight, churn)
        return self._once(
            ("search", width, foresight, churn, stop, q.tobytes()),
            lambda: _search(ref, jnp.asarray(q), stop_level=stop))

    def search_fast(self, width, foresight, churn, q):
        _, ref, _ = self.state(width, foresight, churn)
        return self._once(
            ("fast", width, foresight, churn, q.tobytes()),
            lambda: _search_fast(ref, jnp.asarray(q)))


@pytest.fixture(scope="module")
def ref():
    return Reference()


def _eq(got, want, fields):
    for name, g, w in zip(fields, got, want):
        w = np.asarray(w)
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32), \
            name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.fixture
def no_launch():
    """The wrappers run their plain versions here: no launch is counted."""
    before = sw.search_walk.launches
    yield
    assert sw.search_walk.launches == before


# ---------------------------------------------------------------------------
# search, search_fast and search_validated against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stop", [0, 2])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("foresight", [True, False])
def test_search_equals_repro(ref, no_launch, foresight, width, stop):
    keys, _, st = ref.state(width, foresight)
    q = _queries(keys, width + stop)
    want = ref.search(width, foresight, False, stop, q)
    got = tsl.search(st, torch.from_numpy(q), stop_level=stop)
    _eq(got, want, FIELDS)
    assert got.preds.shape == (q.size, LEVELS)
    assert not got.preds[:, :stop].any()        # below stop_level: 0
    if stop == 0:
        np.testing.assert_array_equal(got.found.numpy(), np.isin(q, keys)
                                      | (q == KEY_MAX))
        _eq([tsl.contains(st, torch.from_numpy(q))], [want.found],
            ["contains"])


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("foresight", [True, False])
def test_search_fast_equals_repro(ref, no_launch, foresight, width):
    keys, _, st = ref.state(width, foresight)
    q = _queries(keys, 10 + width)
    _eq(tsl.search_fast(st, torch.from_numpy(q)),
        ref.search_fast(width, foresight, False, q), ("found", "vals"))


@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_reads_after_inserts_and_deletes_equal_repro(ref, no_launch,
                                                     foresight, width):
    keys, rstate, st = ref.state(width, foresight, churn=True)
    q = np.concatenate([_queries(keys, 20 + width),
                        _keys(N)[:40]]).astype(np.int32)  # deleted keys too
    for stop in (0, 2):
        _eq(tsl.search(st, torch.from_numpy(q), stop_level=stop),
            ref.search(width, foresight, True, stop, q), FIELDS)
    fast = tsl.search_fast(st, torch.from_numpy(q))
    _eq(fast, ref.search_fast(width, foresight, True, q), ("found", "vals"))
    np.testing.assert_array_equal(fast[0].numpy(),
                                  np.isin(q, keys) | (q == KEY_MAX))
    # node ids no longer follow key order: a freed slot was reused
    ids = np.asarray(sl.search(rstate, jnp.asarray(keys)).node)
    assert (np.diff(ids) < 0).any()


def _corrupt(fused, share, seed):
    """``fused`` with ``share`` of its foreseen keys replaced by random
    int32 values; the pointer lanes stay valid."""
    rng = np.random.default_rng(seed)
    fused = np.array(fused)
    mask = rng.random(fused[..., 1].shape) < share
    fused[..., 1] = np.where(
        mask, rng.integers(-2**31 + 1, 2**31 - 1, fused[..., 1].shape),
        fused[..., 1])
    return fused


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("share", [0.0, 0.4])
def test_search_validated_equals_repro(ref, no_launch, share, churn):
    keys, rstate, st = ref.state(1, True, churn)
    fused = _corrupt(rstate.fused, share, 3)
    q = _queries(keys, 30)
    want = _validated(jnp.asarray(fused), rstate.keys, rstate.vals,
                      jnp.asarray(q))
    got = tval.search_validated(torch.from_numpy(fused), st.keys, st.vals,
                                torch.from_numpy(q))
    _eq(got, want, FIELDS)
    np.testing.assert_array_equal(got.found.numpy(),
                                  np.isin(q, keys) | (q == KEY_MAX))


def test_an_empty_batch_reads_nothing(ref, no_launch):
    _, rstate, st = ref.state(1, True)
    q = np.zeros(0, np.int32)
    got = tsl.search(st, torch.from_numpy(q))
    _eq(got, sl.search(rstate, jnp.asarray(q)), FIELDS)
    assert got.preds.shape == (0, LEVELS) and int(got.steps) == 0
    _eq(tsl.search_fast(st, torch.from_numpy(q)),
        sl.search_fast(rstate, jnp.asarray(q)), ("found", "vals"))
    _eq(tval.search_validated(st.fused, st.keys, st.vals,
                              torch.from_numpy(q)),
        val.search_validated(rstate.fused, rstate.keys, rstate.vals,
                             jnp.asarray(q)), FIELDS)


@pytest.mark.parametrize("width", WIDTHS)
def test_key_max_is_found_with_null_val(ref, no_launch, width):
    """The tail sentinel's key answers found, -1, on every read."""
    _, _, st = ref.state(width, True)
    q = torch.full((3,), KEY_MAX, dtype=torch.int32)
    res = tsl.search(st, q)
    assert res.found.all() and (res.vals == tsl.NULL_VAL).all()
    found, vals = tsl.search_fast(st, q)
    assert found.all() and (vals == tsl.NULL_VAL).all()


# ---------------------------------------------------------------------------
# the kernel's walk, modelled one lane at a time
# ---------------------------------------------------------------------------

def _lane_walks(arrays, q, mode, stop, start=None):
    """What K14 computes, lane by lane as its threads do: each lane's own
    loop from ``start`` (default L - 1) down to ``stop_level``, its preds
    row, its path length, then the result; ``steps`` is the longest path
    and ``gathers`` g times the paths' sum (int32, wrapping)."""
    fused, nxt = arrays.get("fused"), arrays.get("nxt")
    keys, vals = arrays["keys"], arrays["vals"]
    fat_k, fat_v = arrays.get("fat_keys"), arrays.get("fat_vals")
    L = (fused if fused is not None else nxt).shape[0]
    out = {f: [] for f in ("found", "vals", "node", "preds", "path")}
    for qb in q.tolist():
        x, lvl, path, row = 0, L - 1 if start is None else start, 0, [0] * L
        while lvl >= stop:
            path += 1
            if mode == "base":
                ptr = int(nxt[lvl, x])
                go = keys[ptr] < qb
            else:
                ptr, fk = (int(v) for v in fused[lvl, x])
                go = (keys[ptr] < qb and (lvl == 0 or fk < qb)
                      if mode == "validated" else fk < qb)
            if go:
                x = ptr
            else:
                row[lvl] = x
                lvl -= 1
        cand = int(nxt[stop, x] if mode == "base" else fused[stop, x, 0])
        ck = int(keys[cand] if mode != "foresight" else fused[stop, x, 1])
        slot, hit, src = cand, ck == qb, vals
        if fat_k is not None:
            width = fat_k.shape[1]
            owner = cand if (ck == qb or x == 0) else x
            pos = int((fat_k[owner] < qb).sum())
            slot = owner * width + min(pos, width - 1)
            hit, src = pos < width and fat_k.reshape(-1)[slot] == qb, \
                fat_v.reshape(-1)
        out["found"].append(bool(hit))
        out["vals"].append(int(src[slot]) if hit else -1)
        out["node"].append(slot if hit else 1)
        out["preds"].append(row)
        out["path"].append(path)
    path = np.asarray(out["path"], np.int64)
    g = 1 if mode == "foresight" else 2
    steps = int(path.max()) if path.size else 0
    gathers = np.int64(g * path.sum()).astype(np.int32)
    return out, steps, gathers


@pytest.mark.parametrize("mode,width", [("foresight", 1), ("base", 1),
                                        ("foresight", 8), ("base", 128),
                                        ("validated", 1)])
def test_the_kernels_lane_walk_gives_the_references_answers(ref, mode,
                                                            width):
    keys, rstate, _ = ref.state(width, mode != "base", churn=width == 1)
    arrays = _arrays(rstate)
    if mode == "validated":
        arrays["fused"] = _corrupt(arrays["fused"], 0.4, 5)
    q = _queries(keys, 40 + width)
    for stop in ((0,) if mode == "validated" else (0, 2)):
        lanes, steps, gathers = _lane_walks(arrays, q, mode, stop)
        want = (_validated(jnp.asarray(arrays["fused"]), rstate.keys,
                           rstate.vals, jnp.asarray(q))
                if mode == "validated" else
                ref.search(width, True if mode == "foresight" else False,
                           width == 1, stop, q))
        for f in ("found", "vals", "node", "preds"):
            np.testing.assert_array_equal(np.asarray(lanes[f]),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert steps == int(want.steps) and gathers == int(want.gathers)
    if mode != "validated":                     # search_fast: from the top
        top = int(sl.effective_top_level(rstate))
        lanes, _, _ = _lane_walks(arrays, q, mode, 0, start=top)
        fast = ref.search_fast(width, mode == "foresight", width == 1, q)
        np.testing.assert_array_equal(lanes["found"], np.asarray(fast[0]))
        np.testing.assert_array_equal(lanes["vals"], np.asarray(fast[1]))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_a_device_other_than_cpu_or_cuda_is_refused(ref):
    _, _, st = ref.state(8, True)
    meta = tsl.SkipListState(*(None if t is None else t.to("meta")
                               for t in st))
    q = torch.zeros(4, dtype=torch.int32, device="meta")
    before = sw.search_walk.launches
    for read in (lambda: tsl.search(meta, q),
                 lambda: tsl.search_fast(meta, q),
                 lambda: tval.search_validated(meta.fused, meta.keys,
                                               meta.vals, q)):
        with pytest.raises(ValueError, match="meta"):
            read()
    assert sw.search_walk.launches == before


def _wide_state(cap, width, levels=LEVELS):
    """A state whose tensors are expanded views: the shapes of a huge list
    at no memory (nothing is read before the range check)."""
    z = torch.zeros((), dtype=torch.int32)
    fat = None if width == 1 else z.expand(cap, width)
    return tsl.SkipListState(
        keys=z.expand(cap), vals=z.expand(cap), height=z.expand(cap),
        nxt=None, fused=z.expand(levels, cap, 2), n=z, free_top=z,
        free_list=z.expand(cap), bump=z, rng=torch.zeros(2, dtype=torch.int32),
        fat_keys=fat, fat_vals=fat, nlen=None if width == 1 else z.expand(cap))


def test_element_ids_past_int32_are_refused():
    q = torch.zeros(4, dtype=torch.int32)
    wide = _wide_state(2**24 + 1, 128)          # cap * B = 2^31 + 128
    for read in (lambda: tsl.search(wide, q),
                 lambda: tsl.search_fast(wide, q)):
        with pytest.raises(ValueError, match="element id"):
            read()
    tall = _wide_state(2**24 + 1, 1, levels=128)  # L * cap past int32
    with pytest.raises(ValueError, match="record index"):
        tval.search_validated(tall.fused, tall.keys, tall.vals, q)


def test_stop_level_outside_the_levels_is_refused(ref):
    _, _, st = ref.state(1, True)
    q = torch.zeros(2, dtype=torch.int32)
    for stop in (-1, LEVELS):
        with pytest.raises(ValueError, match="stop_level"):
            tsl.search(st, q, stop_level=stop)
