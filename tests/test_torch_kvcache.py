"""The port's serving index plane (``serving.kvcache``, ``serving.watchdog``,
``runtime.chaos``, ``runtime.ft``) against repro's, bit for bit, on the CPU.

Page table: twins of the seven page-table cases of ``tests/test_serving.py``
and the five ``try_alloc`` / watermark cases of ``tests/test_chaos.py``,
plus a seeded alloc / lookup / release stream (``_stream``) on the scalar
and the fat (``node_width=8``) layout.  Each case is one function run
through either package (``_Ref`` / ``_Port``), which makes the twin's
assertions and records every result, page, ``ok`` mask, raised message,
free list and index array (``rng`` included) after each call.  The
reference runs every case once, in a module fixture; its tables share one
jitted apply a configuration (``_Ref.table``), so that a shape compiles
once, not once a table.  The port runs in each test.  The stream also runs
on the port's kernel lookup path (K5/K6 and K9's plain versions on the CPU;
the partition is the reference's), and on a mesh of D = 2 gloo ranks
(``torch.multiprocessing.spawn``, a ``FileStore``; a forced and an auto
mesh), whose every rank must see the results and keep the free list of
the reference's single-device table.

Watchdog: one stub engine (``_StubEngine``) for both packages; green on a
healthy stub, a page leak and a session disagreement found, the non-strict
report.  Chaos / ft: ``FaultSchedule.random``, an injector's ``fired`` /
``replay_key``, ``RecoveryLog``, ``StragglerMonitor``,
``run_with_restarts`` and ``ElasticPlan`` on the inputs of
``tests/test_substrates.py`` and ``tests/test_chaos.py``.  Tolerance: none.

This module imports no JAX at its top level: every spawned rank imports
it.
"""
import datetime
import functools
import logging
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.convert import page_table_to_numpy
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import ops as tops
from repro_torch.runtime import chaos as trc
from repro_torch.runtime import ft as tft
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import watchdog as twd

STREAM_PAGES, STREAM_STEPS, STREAM_BLOCKS, STREAM_LOOKUP = 96, 60, 4, 32
FAT_STEPS = 30               # the fat layout's stream: its splits, not all
                             # 8 shards live (the scalar stream has that)


# ---------------------------------------------------------------------------
# The two packages behind one surface
# ---------------------------------------------------------------------------

def _raises(fn) -> str:
    """``"<type>: <message>"`` of what ``fn()`` raised, ``""`` if nothing."""
    try:
        fn()
    except (RuntimeError, ValueError, AssertionError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _session_cap(rids) -> int:
    """Session-table slots for ``rids``: a power of two, two sentinels."""
    return max(16, 1 << (len(rids) + 2).bit_length())


class _Port:
    kv, rc, wd = tkv, trc, twd

    def __init__(self, device="cpu", **table_kw):
        self.device = device
        self.table_kw = table_kw          # e.g. mesh_devices on a gloo rank

    def table(self, chaos=None, **cfg):
        cfg = {**cfg, **self.table_kw}
        return tkv.PageTable(tkv.PagedCacheConfig(**cfg), chaos=chaos,
                             device=self.device)

    @staticmethod
    def state(pt):
        return {k: np.array(v) for k, v in page_table_to_numpy(pt).items()}

    def sessions(self, rids):
        k = np.sort(np.asarray(rids, np.int32))
        return tsl.build(k, k, capacity=_session_cap(k), levels=4,
                         device=self.device)

    @staticmethod
    def fits_vmem(index):
        return tops.fits_vmem(index)


class _Ref:
    def __init__(self):
        import jax
        import jax.numpy as jnp

        from repro.core import sharded as shd
        from repro.core import skiplist as sl
        from repro.kernels import ops as kops
        from repro.runtime import chaos as rc
        from repro.serving import kvcache as kv
        from repro.serving import watchdog as wd
        self.jax, self.jnp, self.shd, self.sl, self.kops = (jax, jnp, shd,
                                                            sl, kops)
        self.kv, self.rc, self.wd = kv, rc, wd

    @functools.lru_cache(maxsize=None)
    def _apply(self, rebalance, seed):
        """The reference's jitted apply (``kvcache.py:156-162``), one a
        configuration: equal shapes share its compiled trace."""
        return self.jax.jit(functools.partial(
            self.shd.apply_ops_sharded, rebalance=rebalance, seed=seed),
            donate_argnums=(0,))

    def table(self, chaos=None, **cfg):
        pt = self.kv.PageTable(self.kv.PagedCacheConfig(**cfg), chaos=chaos)
        pt._jit_apply = self._apply(pt.cfg.rebalance, pt.cfg.seed)
        return pt

    @staticmethod
    def state(pt):
        out = {f"index.shards.{k}": np.array(v)
               for k, v in pt.index.shards._asdict().items()
               if v is not None}
        out["index.boundaries"] = np.array(pt.index.boundaries)
        out["free"] = np.array(pt.free, np.int64)
        return out

    def sessions(self, rids):
        k = np.sort(np.asarray(rids, np.int32))
        return self.sl.build(self.jnp.asarray(k), self.jnp.asarray(k),
                             capacity=_session_cap(k), levels=4)

    def fits_vmem(self, index):
        return self.kops.fits_vmem(index)


class _Req(NamedTuple):
    rid: int
    blocks: int


class _StubEngine:
    """What ``InvariantWatchdog.check`` reads of a serving engine."""

    def __init__(self, pages, sessions, slots, queue, steps=0):
        self.pages, self.sessions = pages, sessions
        self.slots, self.queue, self.steps = slots, queue, steps

    @staticmethod
    def blocks_of(req):
        return req.blocks


# ---------------------------------------------------------------------------
# Cases: each makes its twin's assertions and records into ``out``
# ---------------------------------------------------------------------------

def _arr(x):
    """A host copy of a jax array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.array(np.asarray(x))


def alloc_lookup_release(P, out):
    pt = P.table(n_pages=64)
    pages = pt.alloc(np.array([7, 7, 7, 9]), np.array([0, 1, 2, 0]))
    assert len(set(pages.tolist())) == 4
    found, got = pt.lookup(np.array([7, 7, 9, 7]), np.array([1, 0, 0, 5]))
    assert _arr(found).tolist() == [True, True, True, False]
    assert int(got[0]) == int(pages[1])
    out.update(pages=pages, found=_arr(found), got=_arr(got))
    out["freed"] = pt.release(7, 3)
    assert out["freed"] == 3
    found, _ = pt.lookup(np.array([7]), np.array([0]))
    assert not bool(found[0])
    assert pt.n_live == 1
    out.update(found2=_arr(found), **P.state(pt))


def pool_exhaustion(P, out):
    pt = P.table(n_pages=4)
    out["pages"] = pt.alloc(np.array([1, 1]), np.array([0, 1]))
    out["raised"] = _raises(lambda: pt.alloc(np.array([2, 2, 2]),
                                             np.array([0, 1, 2])))
    assert out["raised"].startswith("RuntimeError")
    out.update(P.state(pt))


def pages_recycled(P, out):
    pt = P.table(n_pages=8)
    p1 = pt.alloc(np.array([1, 1]), np.array([0, 1]))
    pt.release(1, 2)
    p2 = pt.alloc(np.array([2, 2]), np.array([0, 1]))
    assert set(p2.tolist()) == set(p1.tolist())
    out.update(p1=p1, p2=p2, **P.state(pt))


def capacity_failure(P, out):
    pt = P.table(n_pages=64, n_shards=4, rebalance=False)
    usable = pt.index.shard_capacity - 2
    free0 = len(pt.free)
    out["raised"] = _raises(lambda: pt.alloc(np.full(usable + 2, 5),
                                             np.arange(usable + 2)))
    assert out["raised"].startswith("RuntimeError") and \
        "capacity" in out["raised"]
    assert pt.n_live == usable
    assert len(pt.free) == free0 - usable
    out.update({f"off.{k}": v for k, v in P.state(pt).items()})
    pt2 = P.table(n_pages=64, n_shards=4)
    out["pages2"] = pt2.alloc(np.full(usable + 2, 5), np.arange(usable + 2))
    assert pt2.n_live == usable + 2
    found, got = pt2.lookup(np.full(usable + 2, 5), np.arange(usable + 2))
    assert bool(np.all(_arr(found)))
    out.update(found=_arr(found), got=_arr(got),
               **{f"on.{k}": v for k, v in P.state(pt2).items()})


def validates_id_ranges(P, out):
    kv = P.kv
    pt = P.table(n_pages=64)
    # the last sequence's last blocks: legal, and no sentinel collision
    top = np.arange((1 << kv.BLOCK_BITS) - 4, 1 << kv.BLOCK_BITS)
    out["pages"] = pt.alloc(np.full(4, kv.MAX_SEQS - 1), top)
    found, _ = pt.lookup(np.full(4, kv.MAX_SEQS - 1), top)
    assert bool(np.all(_arr(found)))
    n0 = pt.n_live
    calls = {
        "seq_big": lambda: pt.alloc(np.array([kv.MAX_SEQS]), np.array([0])),
        "seq_neg": lambda: pt.alloc(np.array([-1]), np.array([0])),
        "blk_big": lambda: pt.alloc(np.array([1]),
                                    np.array([1 << kv.BLOCK_BITS])),
        "blk_neg": lambda: pt.lookup(np.array([1]), np.array([-2])),
        "rel_seq": lambda: pt.release(kv.MAX_SEQS, 1),
        "rel_n": lambda: pt.release(1, (1 << kv.BLOCK_BITS) + 1),
    }
    for name, fn in calls.items():
        out[f"raised.{name}"] = _raises(fn)
        assert out[f"raised.{name}"].startswith("ValueError")
    assert "seq_id out of range" in out["raised.seq_big"]
    assert "n_blocks" in out["raised.rel_n"]
    assert pt.n_live == n0
    assert len(pt.free) == 64 - n0
    out.update(P.state(pt))


def apply_at_ceiling(P, out):
    """Twin of ``test_page_table_apply_traces_once_at_ceiling``: the shard
    axis stays at the ceiling (the port has no trace cache to count)."""
    pt = P.table(n_pages=64)
    rng = np.random.default_rng(0)
    S0 = pt.index.n_shards
    for s in range(6):
        blocks = np.arange(3 + (s % 2), dtype=np.int64)
        out[f"pages{s}"] = pt.alloc(np.full(blocks.size, s), blocks)
        assert pt.index.n_shards == S0
    found, got = pt.lookup(rng.integers(0, 6, 8), rng.integers(0, 3, 8))
    assert bool(np.all(_arr(found)))
    out.update(S0=S0, found=_arr(found), got=_arr(got), **P.state(pt))


def kernel_path_partition(P, out):
    """Twin of ``test_page_table_kernel_path_sizes_shards_for_vmem``: the
    reference's partition (its VMEM rule; the card has no VMEM)."""
    pt = P.table(n_pages=2**17, use_kernel=True)
    assert pt.index.n_shards > 1
    assert P.fits_vmem(pt.index)
    out.update(n_shards=pt.index.n_shards,
               capacity=pt.index.shard_capacity, **P.state(pt))


def try_alloc_prefix(P, out):
    pt = P.table(n_pages=4)
    ok, pages = pt.try_alloc(np.full(6, 1), np.arange(6))
    assert ok.tolist() == [True] * 4 + [False] * 2
    assert (pages[:4] >= 0).all() and (pages[4:] == -1).all()
    assert pt.n_live == 4 and len(pt.free) == 0
    assert pt.n_live + len(pt.free) == 4
    out.update(ok=ok, pages=pages, **P.state(pt))


def try_alloc_release_blocks(P, out):
    pt = P.table(n_pages=16)
    ok, pages = pt.try_alloc(np.full(3, 2), np.arange(3))
    assert ok.all() and pt.n_live == 3
    out["freed"] = pt.release_blocks(2, np.array([0, 2]))
    assert out["freed"] == 2 and pt.n_live == 1
    assert len(pt.free) == 15
    out.update(ok=ok, pages=pages, **P.state(pt))


def forced_pool_exhaustion(P, out):
    inj = P.rc.FaultInjector([P.rc.Fault(step=0, site="kvcache.alloc",
                                         kind=P.rc.POOL_EXHAUSTED)])
    pt = P.table(chaos=inj, n_pages=16)
    inj.advance(0)
    ok, pages = pt.try_alloc(np.full(2, 1), np.arange(2))
    assert not ok.any() and (pages == -1).all()
    assert len(pt.free) == 16 and pt.n_live == 0
    ok2, pages2 = pt.try_alloc(np.full(2, 1), np.arange(2))
    assert ok2.all()
    out.update(ok=ok, pages=pages, ok2=ok2, pages2=pages2,
               fired=np.array(inj.replay_key(), object).astype(str),
               **P.state(pt))


def forced_capacity_failure(P, out):
    inj = P.rc.FaultInjector([P.rc.Fault(step=0, site="kvcache.alloc",
                                         kind=P.rc.CAPACITY_FAIL)])
    pt = P.table(chaos=inj, n_pages=16)
    inj.advance(0)
    ok, pages = pt.try_alloc(np.full(2, 1), np.arange(2))
    assert not ok.any()
    assert len(pt.free) == 16 and pt.n_live == 0
    out.update(ok=ok, pages=pages,
               fired=np.array(inj.replay_key(), object).astype(str),
               **P.state(pt))


def watermarks(P, out):
    pt = P.table(n_pages=10, high_water=0.8, low_water=0.5)
    assert pt.fill_fraction == 0.0 and pt.below_low_water
    out["pages"] = pt.alloc(np.full(9, 1), np.arange(9))
    assert pt.above_high_water and not pt.below_low_water
    out["fill"] = pt.fill_fraction
    out["freed"] = pt.release(1, 9)
    assert pt.below_low_water
    out["raised"] = _raises(lambda: P.table(n_pages=8, high_water=0.3))
    assert "high_water" in out["raised"]
    out.update(n_free=pt.n_free, **P.state(pt))


def watchdog(P, out):
    pt = P.table(n_pages=64)
    pt.alloc(np.full(4, 1), np.arange(4))
    pt.alloc(np.full(3, 2), np.arange(3))
    eng = _StubEngine(pt, P.sessions([1, 2, 3]),
                      [_Req(1, 4), _Req(2, 3), None], [_Req(3, 0)], steps=5)
    wd = P.wd.InvariantWatchdog()
    rep = wd.check(eng)
    assert rep.ok and rep.failures == [] and rep.step == 5
    leaked = pt.free.pop()                    # a page neither free nor mapped
    out["leak"] = _raises(lambda: wd.check(eng))
    assert "page conservation" in out["leak"]
    pt.free.append(leaked)
    eng.sessions = P.sessions([1, 2])         # an active rid lost
    out["session"] = _raises(lambda: wd.check(eng))
    assert "session agreement" in out["session"]
    eng.sessions = P.sessions([1, 2, 4])      # the count agrees, rid 3 not
    soft = P.wd.InvariantWatchdog(strict=False)
    rep = soft.check(eng)
    assert not rep.ok and soft.violations == 1 and soft.checks == 1
    assert "missing from session table" in rep.failures[0]
    out.update(soft="|".join(rep.failures), checks=wd.checks,
               violations=wd.violations, **P.state(pt))


# ---------------------------------------------------------------------------
# A seeded alloc / lookup / release stream
# ---------------------------------------------------------------------------

def _stream(seed=0, steps=STREAM_STEPS):
    """Events decided from numpy alone: allocs of a 4-block sequence (a
    random seq id, so the keys span the whole key space) while the pool
    has room, releases of a random live sequence, and after every third a
    lookup of 32 lanes, half of them blocks of live sequences.  Every
    apply is one 4-lane batch, so the reference compiles one trace for it.
    At 96 pages the splits make all 8 shards live, so the applies after
    that rebalance in place only because the table asks for it."""
    rng = np.random.default_rng(seed)
    live, free, events = {}, STREAM_PAGES, []
    for _ in range(steps):
        if live and (free < STREAM_BLOCKS or rng.random() < 0.3):
            seq = sorted(live)[int(rng.integers(len(live)))]
            free += STREAM_BLOCKS
            events.append(("release", seq, live.pop(seq)))
        else:
            seq = int(rng.integers(0, tkv.MAX_SEQS))
            while seq in live:
                seq = int(rng.integers(0, tkv.MAX_SEQS))
            live[seq] = STREAM_BLOCKS
            free -= STREAM_BLOCKS
            events.append(("alloc", seq, STREAM_BLOCKS))
        if len(events) % 4 == 3:
            pool = sorted(live) or [0]
            seqs = np.concatenate([rng.choice(pool, STREAM_LOOKUP // 2),
                                   rng.integers(0, tkv.MAX_SEQS,
                                                STREAM_LOOKUP // 2)])
            events.append(("lookup", seqs, rng.integers(
                0, STREAM_BLOCKS, STREAM_LOOKUP)))
    return events, live


def drive_stream(P, out, states=True, steps=STREAM_STEPS, **cfg):
    """The stream on one table; then the watchdog over a stub engine
    whose slots are the live sequences."""
    pt = P.table(n_pages=STREAM_PAGES, **cfg)
    events, live = _stream(steps=steps)
    for i, (kind, a, b) in enumerate(events):
        if kind == "alloc":
            out[f"{i}.pages"] = pt.alloc(np.full(b, a), np.arange(b))
        elif kind == "release":
            out[f"{i}.freed"] = pt.release(a, b)
        else:
            found, pages = pt.lookup(a, b)
            out[f"{i}.found"], out[f"{i}.got"] = _arr(found), _arr(pages)
        assert len(pt.free) + pt.n_live == STREAM_PAGES
        out[f"{i}.free"] = np.array(pt.free, np.int64)
        if states:
            out.update({f"{i}.{k}": v for k, v in P.state(pt).items()
                        if k != "free"})
    eng = _StubEngine(pt, P.sessions(sorted(live)),
                      [_Req(s, n) for s, n in sorted(live.items())], [])
    out["watchdog_ok"] = P.wd.InvariantWatchdog().check(eng).ok
    return pt


def stream(P, out):
    drive_stream(P, out)


def stream_fat8(P, out):
    drive_stream(P, out, steps=FAT_STEPS, node_width=8)


CASES = {f.__name__: f for f in (
    alloc_lookup_release, pool_exhaustion, pages_recycled, capacity_failure,
    validates_id_ranges, apply_at_ceiling, kernel_path_partition,
    try_alloc_prefix, try_alloc_release_blocks, forced_pool_exhaustion,
    forced_capacity_failure, watermarks, watchdog, stream, stream_fat8)}


@pytest.fixture(scope="module")
def ref_runs():
    P, runs = _Ref(), {}
    for name, case in CASES.items():
        runs[name] = {}
        case(P, runs[name])
    return runs


def _same(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    assert set(keys) <= set(got), set(keys) - set(got)
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype.kind == w.dtype.kind, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_page_table_case_equals_repro(name, ref_runs):
    out = {}
    CASES[name](_Port(), out)
    assert sorted(out) == sorted(ref_runs[name])
    _same(out, ref_runs[name])


@pytest.mark.parametrize("name", ["stream", "stream_fat8"])
def test_kernel_lookups_equal_repro(name, ref_runs):
    """The same stream with ``use_kernel``: K5/K6 (and K9 on the fat
    layout) answer the lookups; the partition, so every array, is the
    reference's."""
    out = {}
    fat = name == "stream_fat8"
    drive_stream(_Port(), out, use_kernel=True, node_width=8 if fat else 1,
                 steps=FAT_STEPS if fat else STREAM_STEPS)
    _same(out, ref_runs[name])


def test_page_table_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.PageTable(tkv.PagedCacheConfig(n_pages=16))


def test_auto_mesh_without_a_process_group_is_one_device():
    pt = tkv.PageTable(tkv.PagedCacheConfig(n_pages=64, mesh_devices=0,
                                            mesh_min_pages=16),
                       device="cpu")
    assert pt.mesh is None and pt.index.n_shards == 8
    with pytest.raises(RuntimeError, match="init_process_group"):
        tkv.PageTable(tkv.PagedCacheConfig(n_pages=64, mesh_devices=2),
                      device="cpu")


# ---------------------------------------------------------------------------
# The mesh table at D = 2 over gloo
# ---------------------------------------------------------------------------

MESH_CONFIGS = {"forced": dict(mesh_devices=2),
                "auto_kernel": dict(mesh_devices=0, mesh_min_pages=64,
                                    use_kernel=True)}


def _mesh_rank(rank, D, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, D),
                            rank=rank, world_size=D,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for name, cfg in MESH_CONFIGS.items():
            out = {}
            pt = drive_stream(_Port(**cfg), out, states=False)
            assert pt.mesh is not None and pt.index.n_devices == D
            out["load_live"] = pt.load_stats.live.numpy()
            np.savez(Path(out_dir) / f"{name}_r{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import torch.multiprocessing as mp
    run_dir = tmp_path_factory.mktemp("kv_mesh")
    mp.spawn(_mesh_rank, args=(2, str(run_dir / "store"), str(run_dir)),
             nprocs=2)
    return {(name, r): dict(np.load(run_dir / f"{name}_r{r}.npz"))
            for name in MESH_CONFIGS for r in range(2)}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", list(MESH_CONFIGS))
def test_mesh_page_table_equals_single_device_repro(name, rank, mesh_runs,
                                                    ref_runs):
    got, want = mesh_runs[(name, rank)], ref_runs["stream"]
    keys = [k for k in want if k.split(".", 1)[-1] in
            ("pages", "freed", "found", "got", "free")]
    _same(got, want, keys + ["watchdog_ok"])
    # the stream allocates on both devices' slices (device 1 owns seq ids
    # from MAX_SEQS / 2), and the last apply's load counts its live blocks
    events, live = _stream()
    half = tkv.MAX_SEQS // 2
    allocs = np.array([a for kind, a, _ in events if kind == "alloc"])
    assert (allocs < half).any() and (allocs >= half).any()
    per_dev = [sum(n for s, n in live.items() if (s >= half) == d)
               for d in (0, 1)]
    np.testing.assert_array_equal(got["load_live"], per_dev)


# ---------------------------------------------------------------------------
# Chaos and fault tolerance (numpy only: no compile, run directly)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_rt():
    from repro.runtime import chaos as rc
    from repro.runtime import ft
    return rc, ft


def _faults(fs):
    return [(f.step, f.site, f.kind) for f in fs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_schedule_and_injector_equal_repro(seed, ref_rt):
    rc, _ = ref_rt
    kw = dict(n_steps=32, n_faults=8)
    assert _faults(trc.FaultSchedule.random(seed, **kw)) == \
        _faults(rc.FaultSchedule.random(seed, **kw))
    keys = []
    for mod in (trc, rc):
        inj = mod.FaultInjector.from_seed(seed, **kw)
        transients = 0
        for step in range(0, 40, 3):
            inj.advance(step)
            inj.poll("kvcache.alloc")
            try:
                inj.fire_transient("engine.prefill")
            except mod.TransientDeviceError:
                transients += 1
            inj.poll("engine.decode")
        keys.append((inj.replay_key(), _faults(inj.fired), inj.exhausted,
                     transients))
    assert keys[0] == keys[1]
    assert issubclass(trc.TransientDeviceError, tft.InjectedFailure)


def test_fault_vocabulary_and_validation_equal_repro(ref_rt):
    rc, _ = ref_rt
    assert trc.SITE_KINDS == rc.SITE_KINDS
    assert trc.FAULT_KINDS == rc.FAULT_KINDS
    with pytest.raises(ValueError, match="unknown injection site"):
        trc.Fault(step=0, site="nope", kind=trc.SLOW_STEP)
    with pytest.raises(ValueError, match="not injectable"):
        trc.Fault(step=0, site="kvcache.alloc", kind=trc.SLOW_STEP)


def test_recovery_log_equals_repro(ref_rt, caplog):
    rc, _ = ref_rt
    logs = []
    with caplog.at_level(logging.WARNING):
        for mod in (trc, rc):
            log = mod.RecoveryLog()
            log.warn(3, "shed", rid=1, reason="queue-full")
            log.warn(4, "preempt", rid=2)
            log.warn(4, "shed", rid=5, reason="deadline")
            logs.append((log.counts(), log.replay_key(),
                         log.of_kind("shed")[1].detail))
    assert logs[0] == logs[1]
    assert any(r.name == "repro_torch.chaos" and "shed" in r.message
               for r in caplog.records)


def _straggler_run(ft):
    mon = ft.StragglerMonitor(n_hosts=8, threshold_mads=5.0, evict_after=2)
    reps = []
    for step in range(4):
        times = {h: 1.0 + 0.01 * h for h in range(8)}
        times[3] = 9.0
        reps.append(mon.record(step, times))
    quiet = ft.StragglerMonitor(n_hosts=4).record(
        0, {h: 1.0 + 0.001 * h for h in range(4)})
    return [(r.step, r.host_times, r.flagged, r.evict)
            for r in reps + [quiet]]


def test_straggler_monitor_equals_repro(ref_rt):
    _, ft = ref_rt
    got = _straggler_run(tft)
    assert got == _straggler_run(ft)
    assert 3 in got[0][2] and 3 in got[3][3]


def _restart_runs(ft):
    out = []
    calls = {"n": 0}

    def train(start):
        calls["n"] += 1
        if calls["n"] < 3:
            raise ft.InjectedFailure()
        return start + 10

    out.append(ft.run_with_restarts(train, lambda: 5, max_restarts=5))
    calls["n"], sleeps = 0, []

    def flaky(start):
        calls["n"] += 1
        if calls["n"] < 4:
            raise ConnectionError("transient")
        return start + 1

    out.append(ft.run_with_restarts(
        flaky, lambda: 0, max_restarts=5, exceptions=(ConnectionError,),
        backoff_base=0.5, backoff_factor=2.0, backoff_cap=1.5,
        sleep_fn=sleeps.append))
    out.append(tuple(sleeps))
    calls["n"] = -10                      # more failures than restarts
    out.append(_raises(lambda: ft.run_with_restarts(train, lambda: 0,
                                                    max_restarts=2)))

    def boom(start):
        raise KeyError("not retryable")
    try:
        ft.run_with_restarts(boom, lambda: 0,
                             exceptions=(ft.InjectedFailure,))
    except KeyError as e:
        out.append(str(e))
    out.append(_raises(lambda: ft.run_with_restarts(
        lambda s: s, lambda: 0, backoff_factor=0.5)))
    return out


def test_run_with_restarts_equals_repro(ref_rt):
    _, ft = ref_rt
    got = _restart_runs(tft)
    assert got == _restart_runs(ft)
    assert got[0] == (15, 2) and got[1] == (1, 3)
    assert got[2] == (0.5, 1.0, 1.5)
    assert got[3].startswith("InjectedFailure")
    assert got[5].startswith("ValueError") and "backoff" in got[5]


@pytest.mark.parametrize("n_devices,batch,tp", [(256, 256, 16),
                                                (512, 256, 16),
                                                (64, 1000, 8)])
def test_elastic_plan_equals_repro(n_devices, batch, tp, ref_rt):
    _, ft = ref_rt
    got = tft.ElasticPlan.plan(n_devices, batch, tp=tp)
    want = ft.ElasticPlan.plan(n_devices, batch, tp=tp)
    assert (got.n_devices, got.mesh_shape, got.axis_names,
            got.per_host_batch) == (want.n_devices, want.mesh_shape,
                                    want.axis_names, want.per_host_batch)
    with tft.StepTimer() as t:
        pass
    assert t.t >= 0.0
