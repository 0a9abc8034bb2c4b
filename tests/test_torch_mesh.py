"""The port's mesh-distributed index and K10 against repro's, bit for bit,
over gloo on the CPU.

Two module fixtures run every scenario once:

* the reference: one fresh ``python`` process with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the flag must
  precede JAX's start, so the tier-1 process, whose JAX has one device,
  cannot run it), which runs ``repro``'s mesh at D = 1, 2 and 8 and saves
  its outputs, per-device state arrays stacked ``[D, ...]``;
* the port: ``torch.multiprocessing.spawn`` of D gloo ranks (a
  ``FileStore`` under ``tmp_path``) for each D, every rank running the
  same scenarios on its own chunk of each batch and saving its arrays.

Both make every input from the same numpy seeds (``_inputs``); neither
imports the other's package, and this module imports no JAX at its top
level, since every spawned rank imports it.  Each comparison is a test
case, parametrised over D, layout (scalar and fat ``node_width=8``) and
variant: every per-device state array (``rng`` included) after the build
and after each apply, ``found`` / ``vals`` of ``search_mesh``, ``found`` /
``vals`` / device-global ``node`` of ``search_kernel_mesh`` and of
``search_kernel(..., mesh=)``, apply results with rebalancing off and on,
``DeviceLoadStats`` (the float32 ratios included), the invariant counts.
The scenarios mirror ``tests/test_mesh_index.py`` (boundary-key routing, a
batch routed wholly to one device, the exchange round trip, the
``DictOracle`` fuzz) and ``tests/test_fat_node.py::test_mesh_matches_scalar``;
the empty mesh index grows under the in-place passes.  Tolerance: none.
"""
import datetime
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.sharded import shard_capacity_for

ROOT = Path(__file__).resolve().parent.parent
SPAN = 1 << 16
KEY_MIN, KEY_MAX = -(2**31), 2**31 - 1
OP_READ, OP_INSERT, OP_DELETE = 0, 1, 2
DS = (1, 2, 8)
LAYOUTS = {"scalar": 1, "fat8": 8}
VARIANTS = {"foresight": True, "base": False}
CONFIGS = [(d, lay, var) for d in DS for lay in LAYOUTS for var in VARIANTS]
PRIMARY = ("scalar", "foresight")    # also runs the exchange and the fuzz
N_KEYS, SHARDS, LEVELS = 192, 4, 8
PROBES = 256                 # every read batch but the edge keys
FUZZ_ROUNDS, FUZZ_BATCH = 3, 48
EMPTY_BATCHES, EMPTY_BATCH = 4, 48
DMA_QUERIES = (1, 100, 256, 1000, 2**20)


# ---------------------------------------------------------------------------
# Inputs: numpy only, identical in both runs
# ---------------------------------------------------------------------------

def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32), rng


def _device_boundaries(keys, D):
    """``partition_boundaries`` of the keys padded to ``D * m``."""
    m = max(1, -(-keys.size // D))
    padded = np.concatenate([keys, np.full(D * m - keys.size, KEY_MAX,
                                           np.int32)])
    db = padded[::m].astype(np.int32)
    db[0] = KEY_MIN
    return db


def _oracle_round(d, ops, kk, vv):
    """A ``DictOracle`` pass: the expected results, ``d`` updated."""
    out = []
    for o, k, v in zip(ops.tolist(), kk.tolist(), vv.tolist()):
        if o == OP_INSERT:
            out.append(int(k not in d))
            d[k] = v
        elif o == OP_DELETE:
            out.append(int(d.pop(k, None) is not None))
        else:
            out.append(int(k in d))
    return np.array(out, np.int32)


def _inputs(D, nw):
    """Every scenario's inputs for a D-device mesh at node width ``nw``.

    Batches share a few lengths (256 and 40 reads, 40 and 48 updates) and
    every index one shape, so the reference compiles each collective once
    a configuration.
    """
    keys, rng = _keys(N_KEYS, 0)
    inp = dict(keys=keys, vals=keys * 3,
               capacity=shard_capacity_for(N_KEYS, SHARDS, nw))
    inp["uniform"] = np.concatenate(
        [keys, rng.integers(0, SPAN, PROBES - N_KEYS)]).astype(np.int32)
    hot = int(rng.integers(0, SPAN - 4096))
    inp["zipf"] = (hot + (rng.zipf(1.2, PROBES) - 1) % 4096).astype(np.int32)
    db = _device_boundaries(keys, D)
    edge = [v for b in db.tolist() if b != KEY_MIN for v in (b, b - 1, b + 1)]
    inp["edge"] = np.array(edge or [keys[0], keys[-1]], np.int32)
    E = inp["edge"].size
    # the edge keys inserted, then reads of present keys up to 40 lanes
    inp["edge_ops"] = (
        np.where(np.arange(40) < E, OP_INSERT, OP_READ).astype(np.int32),
        np.concatenate([inp["edge"], keys[:40 - E]]).astype(np.int32),
        (np.arange(40) + 1000).astype(np.int32))
    inp["onedev"] = np.clip(np.arange(40) + max(int(db[-1]), 0), None,
                            KEY_MAX - 1).astype(np.int32)
    kk = rng.integers(0, SPAN, 48).astype(np.int32)
    kk[:24] = rng.choice(keys, 24, replace=False)
    inp["mixed"] = (rng.integers(0, 3, 48).astype(np.int32), kk,
                    (kk * 7 + 1).astype(np.int32))
    inp["after_mixed"] = np.concatenate(
        [np.unique(kk), rng.integers(0, SPAN, PROBES)])[:PROBES].astype(
            np.int32)
    # a hot span of 4096 keys: inserts into one or two devices' slices
    hrng = np.random.default_rng(7)
    inp["empty"] = [(5000 + hrng.choice(4096, EMPTY_BATCH, replace=False)
                     ).astype(np.int32) for _ in range(EMPTY_BATCHES)]
    # the exchange round trip: its own boundaries, every one on the wire
    xrng = np.random.default_rng(17)
    xdb = np.sort(xrng.choice(SPAN, D, replace=False)).astype(np.int32)
    xdb[0] = KEY_MIN
    xq = xrng.integers(0, SPAN, D * 24).astype(np.int32)
    xq[:D] = xdb
    inp["exchange"] = (xdb, xq)
    inp["fuzz"] = [_fuzz_stream(s, zipf=bool(s)) for s in (0, 1)]
    return inp


def _fuzz_stream(seed, zipf):
    """tests/test_mesh_index.py:286-334: 48 keys, rounds of 48 mixed ops
    with the DictOracle's answers, and a probe of the live keys and
    random ones after each."""
    keys, rng = _keys(48, seed)
    d = {int(k): int(k) * 3 for k in keys}
    rounds = []
    for r in range(FUZZ_ROUNDS):
        if zipf:
            hot = int(rng.integers(0, SPAN - 4096))
            kk = (hot + (rng.zipf(1.2, FUZZ_BATCH) - 1) % 4096
                  ).astype(np.int32)
        else:
            kk = rng.integers(0, SPAN, FUZZ_BATCH).astype(np.int32)
        ops = rng.integers(0, 3, FUZZ_BATCH).astype(np.int32)
        vv = (kk * 7 + r).astype(np.int32)
        want = _oracle_round(d, ops, kk, vv)
        live = np.array(sorted(d), np.int32)
        probe = np.concatenate([live, rng.integers(
            0, SPAN, PROBES - live.size)]).astype(np.int32)
        rounds.append(dict(ops=ops, keys=kk, vals=vv, want=want, probe=probe,
                           found=np.isin(probe, live),
                           probe_vals=np.array([d.get(k, -1) for k in
                                                probe.tolist()], np.int32),
                           n=len(d)))
    return keys, rounds


# ---------------------------------------------------------------------------
# The scenarios, driven through either package
# ---------------------------------------------------------------------------
# Output keys are "<scenario>.<kind>.<name>": kind "state" is per device
# (the reference's [D, ...] stack, one slice a rank in the port), "lanes"
# a global batch (the port's rank chunks joined), "rep" a value every
# device holds, "port" a value only the port computes.

def _drive(eng, D, nw, fs, primary):
    """Every scenario of one configuration through ``eng``; the fuzz only
    on the ``primary`` (scalar foresight) configuration."""
    inp, out = _inputs(D, nw), {}
    args = dict(n_devices=D, n_shards=SHARDS, levels=LEVELS, foresight=fs,
                node_width=nw)
    mx = eng.build(inp["keys"], inp["vals"], capacity=inp["capacity"],
                   seed=0, **args)
    eng.state(out, "build", mx)
    eng.checks(out, "build", mx, N_KEYS)
    eng.search(out, "search_edge", mx, inp["edge_ops"][1])
    for name in ("uniform", "zipf", "onedev"):
        eng.search(out, f"search_{name}", mx, inp[name])
    for name in ("uniform", "zipf"):
        eng.kernel(out, f"kernel_{name}", mx, inp[name])
    eng.kernel(out, "dispatch", mx, inp["uniform"], dispatch=True)
    out["dma.rep.bytes"] = np.array([eng.dma_bytes(mx, n)
                                     for n in DMA_QUERIES], np.int64)
    eng.route(out, "route_edge", mx, inp["edge"])
    m2 = eng.apply(out, "apply_edge", mx, *inp["edge_ops"])
    eng.checks(out, "apply_edge", m2, None)
    q = inp["onedev"]
    m2 = eng.apply(out, "apply_onedev", mx, np.full(q.size, OP_INSERT,
                                                    np.int32), q, q)
    eng.checks(out, "apply_onedev", m2, None)
    m2 = eng.apply(out, "apply_mixed", mx, *inp["mixed"], rebalance=True)
    eng.checks(out, "apply_mixed", m2, None)
    eng.search(out, "search_after_mixed", m2, inp["after_mixed"])
    em = eng.empty(capacity=inp["capacity"], key_span=SPAN, seed=0, **args)
    eng.state(out, "empty", em)
    for b, kk in enumerate(inp["empty"]):
        em = eng.apply(out, f"empty{b}", em, np.full(kk.size, OP_INSERT,
                                                     np.int32),
                       kk, kk * 2, rebalance=True, seed=b)
        eng.checks(out, f"empty{b}", em, None)
    if not primary:
        return out
    eng.exchange(out, *inp["exchange"])
    for s, (fkeys, rounds) in enumerate(inp["fuzz"]):
        fm = eng.build(fkeys, fkeys * 3, capacity=shard_capacity_for(
            48 + FUZZ_ROUNDS * FUZZ_BATCH, SHARDS, nw), seed=s, **args)
        for r, rd in enumerate(rounds):
            scen = f"fuzz{s}_{r}"
            fm = eng.apply(out, scen, fm, rd["ops"], rd["keys"], rd["vals"],
                           rebalance=True)
            eng.checks(out, scen, fm, rd["n"])
            eng.search(out, f"{scen}_search", fm, rd["probe"])
    return out


class _Reference:
    """``repro``'s mesh under ``shard_map``, on forced host devices."""

    def __init__(self, D):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from repro.core import mesh_index as mi
        from repro.launch import mesh as lmesh
        self.jax, self.jnp, self.mi, self.D = jax, jnp, mi, D
        self.mesh = lmesh.make_index_mesh(D)
        self.P = P
        self.spec = P(lmesh.INDEX_AXIS)
        self.sharded = NamedSharding(self.mesh, self.spec)
        self.replicated = NamedSharding(self.mesh, P())

    def j(self, a):
        return self.jnp.asarray(np.asarray(a, np.int32))

    def _placed(self, mx):
        """The index laid out as the collectives return it, so that a
        fresh build and an applied index share one compiled call."""
        return mx._replace(
            local=self.jax.device_put(mx.local, self.sharded),
            device_boundaries=self.jax.device_put(mx.device_boundaries,
                                                  self.replicated))

    def build(self, keys, vals, **kw):
        return self._placed(self.mi.build_mesh_index(self.j(keys),
                                                     self.j(vals), **kw))

    def empty(self, **kw):
        return self._placed(self.mi.empty_mesh_index(**kw))

    def state(self, out, scen, mx):
        for f, v in mx.local.shards._asdict().items():
            if v is not None:
                out[f"{scen}.state.local.shards.{f}"] = np.asarray(v)
        out[f"{scen}.state.local.boundaries"] = np.asarray(
            mx.local.boundaries)
        out[f"{scen}.rep.device_boundaries"] = np.asarray(
            mx.device_boundaries)

    def checks(self, out, scen, mx, n):
        pass

    def search(self, out, scen, mx, q):
        f, v = self.mi.search_mesh(mx, self.j(q), mesh=self.mesh)
        out[f"{scen}.lanes.found"] = np.asarray(f)
        out[f"{scen}.lanes.vals"] = np.asarray(v)

    def kernel(self, out, scen, mx, q, dispatch=False):
        from repro.kernels import mesh_launch as ml
        from repro.kernels import ops as kops
        r = (kops.search_kernel(mx, self.j(q), mesh=self.mesh) if dispatch
             else ml.search_kernel_mesh(mx, self.j(q), mesh=self.mesh,
                                        interpret=True))
        for f, v in r._asdict().items():
            out[f"{scen}.lanes.{f}"] = np.asarray(v)

    def route(self, out, scen, mx, q):
        out[f"{scen}.lanes.did"] = np.asarray(self.mi.route_devices(
            mx, self.j(q)))

    def dma_bytes(self, mx, n):
        from repro.kernels import mesh_launch as ml
        return ml.dma_model_bytes_mesh(mx, n)

    def apply(self, out, scen, mx, ops, kk, vv, **kw):
        mx, res, stats = self.mi.apply_ops_mesh(
            mx, self.j(ops), self.j(kk), self.j(vv), mesh=self.mesh, **kw)
        out[f"{scen}.lanes.res"] = np.asarray(res)
        for f, v in stats._asdict().items():
            out[f"{scen}.rep.stats.{f}"] = np.asarray(v)
        self.state(out, scen, mx)
        return mx

    def exchange(self, out, xdb, xq):
        from jax.experimental.shard_map import shard_map
        mi, jnp, D = self.mi, self.jnp, self.D

        def body(dbv, q):
            did = mi.route(dbv, q)
            (rq,), live, perm, starts, did_s = mi._exchange_out(
                did, (q,), (jnp.int32(0),), D)
            back = mi._exchange_back(rq, perm, starts, did_s, D)
            return rq, live.astype(jnp.int32), back

        fn = self.jax.jit(shard_map(
            body, mesh=self.mesh, in_specs=(self.P(), self.spec),
            out_specs=(self.spec,) * 3, check_rep=False))
        rq, live, back = (np.asarray(a) for a in fn(self.j(xdb),
                                                    self.j(xq)))
        out["exchange.state.received"] = rq.reshape(D, -1)
        out["exchange.state.live"] = live.reshape(D, -1)
        out["exchange.lanes.back"] = back


def _reference_main(out_dir, D):
    """The reference at D devices, every configuration; one file each."""
    import jax
    assert len(jax.devices()) >= D, "needs forced host devices"
    eng = _Reference(D)
    for lay, nw in LAYOUTS.items():
        for var, fs in VARIANTS.items():
            out = _drive(eng, D, nw, fs, (lay, var) == PRIMARY)
            np.savez(Path(out_dir) / f"ref_{D}_{lay}_{var}.npz", **out)
            jax.clear_caches()           # bound the XLA CPU JIT's state


class _Port:
    """The port: this rank's slice and chunks, over the gloo mesh."""

    def __init__(self, D, rank, mesh):
        from repro_torch.core import mesh_index as mi
        self.mi, self.D, self.rank, self.mesh = mi, D, rank, mesh

    def ch(self, a, fill=0):
        return self.mi.chunk(np.asarray(a, np.int32), self.D, self.rank,
                             fill)

    def build(self, keys, vals, **kw):
        return self.mi.build_mesh_index(keys, vals, rank=self.rank,
                                        device="cpu", **kw)

    def empty(self, **kw):
        return self.mi.empty_mesh_index(rank=self.rank, device="cpu", **kw)

    def state(self, out, scen, mx):
        from repro_torch.convert import mesh_to_numpy
        for k, v in mesh_to_numpy(mx).items():
            kind = "rep" if k == "device_boundaries" else "state"
            out[f"{scen}.{kind}.{k}"] = v

    def checks(self, out, scen, mx, n):
        mi, mesh = self.mi, self.mesh
        out[f"{scen}.port.invariant"] = mi.check_mesh_invariant(
            mx, expect_n=n, mesh=mesh).numpy()
        out[f"{scen}.port.total_n"] = mi.total_n_mesh(mx, mesh=mesh).numpy()
        out[f"{scen}.port.device_live"] = mi.device_live(
            mx, mesh=mesh).numpy()

    def search(self, out, scen, mx, q):
        f, v = self.mi.search_mesh(mx, self.ch(q), mesh=self.mesh)
        out[f"{scen}.lanes.found"] = f.numpy()
        out[f"{scen}.lanes.vals"] = v.numpy()

    def kernel(self, out, scen, mx, q, dispatch=False):
        from repro_torch.kernels import mesh_launch as ml
        from repro_torch.kernels import ops as tops
        fn = tops.search_kernel if dispatch else ml.search_kernel_mesh
        r = fn(mx, self.ch(q), mesh=self.mesh)
        for f, v in r._asdict().items():
            out[f"{scen}.lanes.{f}"] = v.numpy()

    def route(self, out, scen, mx, q):
        out[f"{scen}.lanes.did"] = self.mi.route_devices(
            mx, self.ch(q)).numpy()

    def dma_bytes(self, mx, n):
        from repro_torch.kernels import mesh_launch as ml
        return ml.dma_model_bytes_mesh(mx, n)

    def apply(self, out, scen, mx, ops, kk, vv, **kw):
        mx, res, stats = self.mi.apply_ops_mesh(
            mx, self.ch(ops, OP_READ), self.ch(kk), self.ch(vv),
            mesh=self.mesh, **kw)
        out[f"{scen}.lanes.res"] = res.numpy()
        for f, v in stats._asdict().items():
            out[f"{scen}.rep.stats.{f}"] = v.numpy()
        self.state(out, scen, mx)
        return mx

    def exchange(self, out, xdb, xq):
        mi, D = self.mi, self.D
        q = self.ch(xq)
        group = self.mesh.get_group("index")
        did = mi.route(torch.from_numpy(xdb), q)
        (rq,), live, perm, starts, did_s = mi._exchange_out(did, (q,), (0,),
                                                            D, group)
        back, = mi._exchange_back((rq,), perm, starts, did_s, D, group)
        out["exchange.state.received"] = rq.numpy()
        out["exchange.state.live"] = live.to(torch.int32).numpy()
        out["exchange.lanes.back"] = back.numpy()


def _port_rank(rank, D, store, out_dir):
    """One spawned gloo rank: every configuration, then the refusals."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, D),
                            rank=rank, world_size=D,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_index_mesh
        mesh = make_index_mesh(D, device="cpu")
        eng = _Port(D, rank, mesh)
        for lay, nw in LAYOUTS.items():
            for var, fs in VARIANTS.items():
                out = _drive(eng, D, nw, fs, (lay, var) == PRIMARY)
                np.savez(Path(out_dir) / f"port_{D}_{lay}_{var}_r{rank}.npz",
                         **out)
        np.savez(Path(out_dir) / f"errors_{D}_r{rank}.npz",
                 **_port_errors(D, rank, mesh))
    finally:
        dist.destroy_process_group()


def _port_errors(D, rank, mesh):
    """The port's refusals, each as the message it raised ('' if none)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import mesh_index as mi
    from repro_torch.core.sharded import ShardedSkipList
    from repro_torch.core.skiplist import allocate
    from repro_torch.kernels import mesh_launch as ml
    from repro_torch.kernels import ops as tops
    from repro_torch.launch import mesh as lmesh

    keys, _ = _keys(N_KEYS, 0)
    mx = mi.build_mesh_index(keys, keys * 3, n_devices=D, n_shards=SHARDS,
                             levels=LEVELS, rank=rank, device="cpu")
    q = torch.zeros(4, dtype=torch.int32)
    wide = mi.build_mesh_index(keys, keys * 3, n_devices=D + 1,
                               n_shards=SHARDS, levels=LEVELS, rank=rank,
                               device="cpu")
    big = mx._replace(local=ShardedSkipList(
        allocate((SHARDS,), 2**29, 1, foresight=True, device="meta"),
        torch.empty(SHARDS, dtype=torch.int32, device="meta")))
    cases = {
        "no_index_dim": lambda: mi.search_mesh(
            mx, q, mesh=DeviceMesh("cpu", torch.arange(D),
                                   mesh_dim_names=("data",))),
        "d_mismatch": lambda: mi.search_mesh(wide, q, mesh=mesh),
        "oversubscribed": lambda: lmesh.make_index_mesh(D + 1, device="cpu"),
        "negative": lambda: lmesh.make_index_mesh(-3, device="cpu"),
        "id_wrap": lambda: ml.search_kernel_mesh(big, q, mesh=mesh),
        "no_mesh": lambda: tops.search_kernel(mx, q),
        "indivisible": lambda: lmesh.validate_index_partition(mesh,
                                                              4 * D + 1),
    }
    if D > 1:
        cases["other_slice"] = lambda: mi.search_mesh(
            mx._replace(rank=(rank + 1) % D), q, mesh=mesh)
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = np.array("")
        except ValueError as e:
            out[name] = np.array(str(e))
    out["per_device"] = np.array(lmesh.validate_index_partition(mesh, 4 * D))
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def reference_procs(run_dir):
    """The reference's processes, one a D, started first so that they
    overlap the port's ranks; each logs to a file of ``run_dir``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs = {}
    for D in DS:
        with open(run_dir / f"ref_{D}.log", "w") as log:
            procs[D] = subprocess.Popen(
                [sys.executable, "-c", "import sys, test_torch_mesh as t; "
                 "t._reference_main(sys.argv[1], int(sys.argv[2]))",
                 str(run_dir), str(D)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port(reference_procs, run_dir):
    """``{(D, layout, variant): [rank 0 arrays, rank 1 arrays, ...]}`` and
    ``{D: [each rank's refusals]}``."""
    import torch.multiprocessing as mp
    for D in DS:
        mp.spawn(_port_rank, args=(D, str(run_dir / f"store_{D}"),
                                   str(run_dir)), nprocs=D)
    runs = {(D, lay, var): [dict(np.load(run_dir / f"port_{D}_{lay}_{var}"
                                         f"_r{r}.npz")) for r in range(D)]
            for D, lay, var in CONFIGS}
    errors = {D: [dict(np.load(run_dir / f"errors_{D}_r{r}.npz"))
                  for r in range(D)] for D in DS}
    return runs, errors


@pytest.fixture(scope="module")
def reference(reference_procs, run_dir):
    for D, proc in reference_procs.items():
        rc = proc.wait(timeout=600)
        log = (run_dir / f"ref_{D}.log").read_text()
        assert rc == 0, log[-4000:]
    return {c: dict(np.load(run_dir / "ref_{}_{}_{}.npz".format(*c)))
            for c in CONFIGS}


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def _eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _compare(port, reference, config, scen, expect_n=None):
    """Every array of scenario ``scen``: per-device states against slice
    ``d``, lanes (rank chunks joined, cut to ``B``) and replicated values
    on every rank.  Where the port also checked the index
    (``check_mesh_invariant``, ``total_n_mesh``, ``device_live``), the
    invariant holds and the counts equal the reference state's."""
    ranks, ref = port[0][config], reference[config]
    keys = [k for k in ref if k.split(".", 1)[0] == scen]
    assert keys, f"no reference outputs for {scen}"
    for key in keys:
        _, kind, name = key.split(".", 2)
        assert all(key in r for r in ranks), f"port lacks {key}"
        if kind == "state":
            for d, r in enumerate(ranks):
                _eq(r[key], ref[key][d], f"{key} device {d}")
        elif kind == "lanes":
            joined = np.concatenate([r[key] for r in ranks])
            _eq(joined[:ref[key].shape[0]], ref[key], key)
        else:
            for d, r in enumerate(ranks):
                _eq(r[key], ref[key], f"{key} on rank {d}")
    if f"{scen}.port.invariant" in ranks[0]:
        live = ref[f"{scen}.state.local.shards.n"].sum(axis=1,
                                                       dtype=np.int32)
        for r in ranks:
            assert bool(r[f"{scen}.port.invariant"]), scen
            _eq(r[f"{scen}.port.device_live"], live, f"{scen} device_live")
            _eq(r[f"{scen}.port.total_n"], live.sum(dtype=np.int32),
                f"{scen} total_n_mesh")
        if expect_n is not None:
            assert int(live.sum()) == expect_n
    return ranks, ref


CONFIG_IDS = [f"D{d}-{lay}-{var}" for d, lay, var in CONFIGS]
config = pytest.mark.parametrize("config", CONFIGS, ids=CONFIG_IDS)
primary = pytest.mark.parametrize(
    "config", [(d, *PRIMARY) for d in DS],
    ids=[f"D{d}-{PRIMARY[0]}-{PRIMARY[1]}" for d in DS])


@config
def test_build_states_and_invariants_equal_repro(port, reference, config):
    _compare(port, reference, config, "build", expect_n=N_KEYS)


@config
@pytest.mark.parametrize("traffic", ["uniform", "zipf"])
def test_search_mesh_equals_repro(port, reference, config, traffic):
    _compare(port, reference, config, f"search_{traffic}")


@config
@pytest.mark.parametrize("traffic", ["uniform", "zipf"])
def test_search_kernel_mesh_equals_repro(port, reference, config, traffic):
    """K10: found, vals and device-global node ids; the eager search
    agrees."""
    _, ref = _compare(port, reference, config, f"kernel_{traffic}")
    _eq(ref[f"kernel_{traffic}.lanes.found"],
        ref[f"search_{traffic}.lanes.found"], "kernel vs eager found")
    _eq(ref[f"kernel_{traffic}.lanes.vals"],
        ref[f"search_{traffic}.lanes.vals"], "kernel vs eager vals")


@config
def test_search_kernel_dispatch_equals_repro(port, reference, config):
    _compare(port, reference, config, "dispatch")


@config
def test_dma_model_bytes_mesh_equals_repro(port, reference, config):
    """The reference's TPU cost model, host arithmetic copied as it is
    (the fat run tile left out, ROADMAP Queue 3)."""
    _compare(port, reference, config, "dma")


@config
def test_boundary_key_routing_equals_repro(port, reference, config):
    """Keys equal to, one below and one above every device boundary route
    to their owner, are searched and inserted there."""
    _, ref = _compare(port, reference, config, "route_edge")
    D = config[0]
    inp = _inputs(D, LAYOUTS[config[1]])
    did = ref["route_edge.lanes.did"]
    bounds = np.append(_device_boundaries(inp["keys"], D).astype(np.int64),
                       KEY_MAX)
    for k, dev in zip(inp["edge"].tolist(), did.tolist()):
        assert bounds[dev] <= k < bounds[dev + 1]
    _compare(port, reference, config, "search_edge")
    _compare(port, reference, config, "apply_edge")


@config
def test_batch_routed_to_one_device_equals_repro(port, reference, config):
    """Every other device receives only bucket fill."""
    _compare(port, reference, config, "search_onedev")
    _, ref = _compare(port, reference, config, "apply_onedev")
    routed = ref["apply_onedev.rep.stats.routed"]
    assert routed.sum() == 40 and (routed[:-1] == 0).all()


@config
@pytest.mark.parametrize("rebalance", [False, True], ids=["off", "on"])
def test_apply_equals_repro(port, reference, config, rebalance):
    """Results, every state array and DeviceLoadStats after an apply with
    rebalancing off (boundary inserts) and on (a mixed batch, then a
    search of the applied keys)."""
    _compare(port, reference, config,
             "apply_mixed" if rebalance else "apply_edge")
    if rebalance:
        _compare(port, reference, config, "search_after_mixed")


@config
def test_empty_mesh_grows_in_place_like_repro(port, reference, config):
    """An empty mesh index under hot-span inserts with rebalancing: the
    in-place passes split inside each device's ceiling."""
    _compare(port, reference, config, "empty")
    for b in range(EMPTY_BATCHES):
        _, ref = _compare(port, reference, config, f"empty{b}")
    live = ref[f"empty{EMPTY_BATCHES - 1}.state.local.boundaries"] < KEY_MAX
    assert live.sum() > config[0]             # some device split
    assert live.shape[1] == SHARDS            # inside the ceiling


@primary
def test_exchange_round_trip_equals_repro(port, reference, config):
    """The received batch is source-major, as the reference's; out and back
    is the identity on lane order."""
    _, ref = _compare(port, reference, config, "exchange")
    _eq(ref["exchange.lanes.back"], _inputs(config[0], 1)["exchange"][1],
        "round trip")


@primary
@pytest.mark.parametrize("stream", [0, 1], ids=["uniform", "zipf"])
def test_fuzz_against_dict_oracle(port, reference, config, stream):
    """tests/test_mesh_index.py's differential fuzz, rebalancing on: every
    round equals the reference and the DictOracle."""
    _, rounds = _inputs(config[0], 1)["fuzz"][stream]
    for r, rd in enumerate(rounds):
        scen = f"fuzz{stream}_{r}"
        ranks, _ = _compare(port, reference, config, scen, expect_n=rd["n"])
        _compare(port, reference, config, f"{scen}_search")
        B = rd["want"].size
        res = np.concatenate([x[f"{scen}.lanes.res"] for x in ranks])[:B]
        _eq(res, rd["want"], f"{scen} results against the oracle")
        joined = {f: np.concatenate([x[f"{scen}_search.lanes.{f}"]
                                     for x in ranks])[:PROBES]
                  for f in ("found", "vals")}
        _eq(joined["found"], rd["found"], f"{scen} found against the oracle")
        _eq(joined["vals"], rd["probe_vals"], f"{scen} vals against the "
                                              "oracle")


@pytest.mark.parametrize("D", DS)
def test_fat_mesh_matches_scalar(port, D):
    """tests/test_fat_node.py::test_mesh_matches_scalar: the fat mesh
    answers as the scalar one."""
    runs = port[0]
    for var in VARIANTS:
        for scen in ("search_uniform", "kernel_uniform"):
            for f in ("found", "vals"):
                key = f"{scen}.lanes.{f}"
                for a, b in zip(runs[(D, "fat8", var)], runs[(D, "scalar",
                                                              var)]):
                    _eq(a[key], b[key], f"{key} fat vs scalar")


@pytest.mark.parametrize("D", DS)
def test_mesh_refusals(port, D):
    """Missing index dimension, D mismatch, oversubscription, the int32
    node-id wrap, search_kernel without mesh=, another device's slice, a
    shard count that does not divide."""
    want = {"no_index_dim": "lack", "d_mismatch": "partitioned for",
            "oversubscribed": "world size", "negative": "n_devices",
            "id_wrap": "2\\*\\*31", "no_mesh": "mesh="}
    if D > 1:
        want.update(other_slice="holds", indivisible="divide")
    for errors in port[1][D]:
        for name, pattern in want.items():
            msg = str(errors[name])
            assert msg, f"{name} did not raise"
            assert re.search(pattern, msg), msg
        assert int(errors["per_device"]) == 4


def test_mesh_local_from_numpy_round_trip(reference):
    """The reference's stacked arrays convert into each device's slice and
    back."""
    from repro_torch.convert import mesh_local_from_numpy, mesh_to_numpy
    ref = reference[(8, "fat8", "foresight")]
    arrays = {k.split(".", 2)[2]: v for k, v in ref.items()
              if k.startswith("build.state.")}
    arrays["device_boundaries"] = ref["build.rep.device_boundaries"]
    for d in range(8):
        mx = mesh_local_from_numpy(arrays, d, device="cpu")
        assert mx.rank == d and mx.n_devices == 8 and mx.node_width == 8
        back = mesh_to_numpy(mx)
        for k, v in arrays.items():
            _eq(back[k], v if k == "device_boundaries" else v[d], k)
    with pytest.raises(ValueError, match="outside"):
        mesh_local_from_numpy(arrays, 8, device="cpu")
