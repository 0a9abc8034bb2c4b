"""The port's data plane (``data.store``, ``data.pipeline``) against repro's,
bit for bit, on the CPU.

Twins of ``tests/test_substrates.py``'s store and pipeline cases.  Each
store mode (monolithic, sharded with ``n_shards=4``, rebalancing with
``repack_every=2``, and the kernel paths: K1 on a monolithic store, K5
clustered and K4 dense on four shards; every walk of the store's paths
runs on the card in ``tests/test_torch_data_gpu.py``) runs one scenario
through either package on a 256-sample store: build, ``get_batch`` of 64
stored keys, ``ingest`` and ``evict`` of two new keys with a lookup after
each, a ``range_scan`` across every shard and two pipeline batches.  The
reference runs every mode once, in a module fixture, with its kernels in
interpret mode as its own tests run them; the port runs in each test.
Every index array (``rng`` included), the rows, every result, found mask,
row id and scanned pair must be equal.  Tolerance: none.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as rpipe
from repro.data import store as rstore
from repro.kernels import ops as kops
from repro_torch.convert import store_to_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.data import store as tstore
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parent.parent
N, SEQ = 256, 32
NEW_KEYS = (2**29 + 1, 2**29 + 2)
MODES = {
    "monolithic": dict(),
    "sharded": dict(n_shards=4),
    "repack": dict(n_shards=4, repack_every=2),
    "kernel_k1": dict(use_kernel=True),
    "kernel_clustered": dict(use_kernel=True, n_shards=4),
    "kernel_dense": dict(use_kernel=True, n_shards=4, clustered=False,
                         foresight=False),
}


def _ref_state(store):
    """The reference store's index and rows as ``store_to_numpy`` names
    them."""
    idx = store.index
    out = {}
    if isinstance(idx, rstore.shd.ShardedSkipList):
        out.update({f"index.shards.{k}": np.asarray(v)
                    for k, v in idx.shards._asdict().items()
                    if v is not None})
        out["index.boundaries"] = np.asarray(idx.boundaries)
    else:
        out.update({f"index.{k}": np.asarray(v)
                    for k, v in idx._asdict().items() if v is not None})
    out["rows"] = np.asarray(store.rows)
    return out


class _Ref:
    store_mod, pipe_mod = rstore, rpipe

    @staticmethod
    def store(cfg):
        return rstore.IndexedSampleStore(cfg)

    state = staticmethod(_ref_state)

    @staticmethod
    def lanes(a):
        return jnp.asarray(np.asarray(a, np.int32))


class _Port:
    store_mod, pipe_mod = tstore, tpipe

    @staticmethod
    def store(cfg):
        return tstore.IndexedSampleStore(cfg, device="cpu")

    @staticmethod
    def state(store):
        return {k: np.array(v) for k, v in store_to_numpy(store).items()}

    @staticmethod
    def lanes(a):
        return torch.from_numpy(np.asarray(a, np.int32))


def _drive(P, mode):
    """One mode's scenario through package ``P``: ``{name: array}``, with
    the twins' assertions made on the way."""
    out = {}

    def put(scen, arrays):
        for k, v in arrays.items():
            out[f"{scen}.{k}"] = np.asarray(v)

    store = P.store(P.store_mod.StoreConfig(n_samples=N, seq_len=SEQ,
                                            **MODES[mode]))
    put("build", P.state(store))
    out["n_shards"] = np.asarray(store.n_shards)
    # test_store_lookup_roundtrip
    rows, found = store.get_batch(P.lanes(store.keys_np[:64]))
    assert bool(np.asarray(found).all())
    assert tuple(rows.shape) == (64, SEQ + 1)
    put("roundtrip", dict(rows=rows, found=found))
    # test_store_ingest_evict
    newk = P.lanes(NEW_KEYS)
    put("ingest", dict(res=store.ingest(newk, P.lanes([0, 1]))))
    found, rid = store.lookup(newk)
    assert bool(np.asarray(found).all())
    put("ingest", dict(found=found, rid=rid, **P.state(store)))
    put("evict", dict(res=store.evict(newk)))
    found, rid = store.lookup(newk)
    assert not bool(np.asarray(found).any())
    put("evict", dict(found=found, rid=rid, **P.state(store)))
    # a scan of every key, across every shard boundary
    keys, vals, count = store.range_scan(0, 2**30, N + 8)
    assert int(count) == N
    np.testing.assert_array_equal(np.asarray(keys)[:N], store.keys_np)
    put("scan", dict(keys=keys, vals=vals, count=count))
    pipe = P.pipe_mod.DataPipeline(store, P.pipe_mod.PipelineConfig(
        global_batch=64, seed=5))
    for step in (0, 3):
        batch = pipe.get_batch(step)
        assert bool(np.asarray(batch["found"]).all())
        put(f"pipe{step}", dict(keys=pipe.batch_keys(step), **batch))
    return out


@pytest.fixture(scope="module")
def ref_runs():
    return {mode: _drive(_Ref, mode) for mode in MODES}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_store_scenario_equals_repro(mode, ref_runs):
    _assert_same(_drive(_Port, mode), ref_runs[mode])


@pytest.mark.parametrize("mode", ["monolithic", "kernel_clustered"])
def test_store_lookup_roundtrip(mode):
    store = tstore.IndexedSampleStore(
        tstore.StoreConfig(n_samples=256, seq_len=32, **MODES[mode]),
        device="cpu")
    keys = torch.from_numpy(store.keys_np[:64].astype(np.int32))
    rows, found = store.get_batch(keys)
    assert bool(found.all())
    assert rows.shape == (64, 33)
    assert rows.device.type == "cpu" and rows.dtype == torch.int32


@pytest.mark.parametrize("mode", ["monolithic", "repack"])
def test_store_ingest_evict(mode):
    store = tstore.IndexedSampleStore(
        tstore.StoreConfig(n_samples=128, seq_len=16, **MODES[mode]),
        device="cpu")
    newk = torch.tensor([2**29 + 1, 2**29 + 2], dtype=torch.int32)
    store.ingest(newk, torch.tensor([0, 1], dtype=torch.int32))
    found, _ = store.lookup(newk)
    assert bool(found.all())
    store.evict(newk)
    found, _ = store.lookup(newk)
    assert not bool(found.any())


def _port_store():
    return tstore.IndexedSampleStore(tstore.StoreConfig(n_samples=256,
                                                        seq_len=32),
                                     device="cpu")


def test_pipeline_deterministic_across_restarts():
    store = _port_store()
    p1 = tpipe.DataPipeline(store, tpipe.PipelineConfig(global_batch=8,
                                                        seed=5))
    p2 = tpipe.DataPipeline(store, tpipe.PipelineConfig(global_batch=8,
                                                        seed=5))
    # the reference's key derivation reads only the key population
    ref = rpipe.DataPipeline(SimpleNamespace(cfg=store.cfg,
                                             keys_np=store.keys_np),
                             rpipe.PipelineConfig(global_batch=8, seed=5))
    for step in (0, 3, 17):
        np.testing.assert_array_equal(p1.batch_keys(step),
                                      p2.batch_keys(step))
        np.testing.assert_array_equal(p1.batch_keys(step),
                                      ref.batch_keys(step))


def test_pipeline_host_sharding_partitions_batch():
    store = _port_store()
    full = tpipe.DataPipeline(store, tpipe.PipelineConfig(global_batch=8,
                                                          n_hosts=1))
    h0 = tpipe.DataPipeline(store, tpipe.PipelineConfig(global_batch=8,
                                                        n_hosts=2,
                                                        host_id=0))
    h1 = tpipe.DataPipeline(store, tpipe.PipelineConfig(global_batch=8,
                                                        n_hosts=2,
                                                        host_id=1))
    k = np.concatenate([h0.batch_keys(7), h1.batch_keys(7)])
    np.testing.assert_array_equal(k, full.batch_keys(7))
    with pytest.raises(ValueError, match="divide"):
        tpipe.DataPipeline(store, tpipe.PipelineConfig(global_batch=9,
                                                       n_hosts=2))


@pytest.mark.parametrize("n,width,vocab,seed", [(64, 33, 256, 0),
                                                (300, 17, 50, 3)])
def test_markov_corpus_equals_repro(n, width, vocab, seed):
    np.testing.assert_array_equal(
        tstore._markov_corpus(np.random.default_rng(seed), n, width, vocab),
        rstore._markov_corpus(np.random.default_rng(seed), n, width, vocab))


def test_store_auto_shards_keep_the_reference_rule():
    """``n_shards=0``: monolithic without the kernel path; with it, past
    the reference's VMEM budget, the reference's shard count."""
    n = 2**16
    keys = np.arange(n, dtype=np.int64) * 4
    rows = np.zeros((n, 2), np.int32)
    cfg = dict(n_samples=n, seq_len=1)
    plain = tstore.IndexedSampleStore(tstore.StoreConfig(**cfg), rows=rows,
                                      keys=keys, device="cpu")
    assert plain.n_shards == 1 and not plain.sharded
    kern = tstore.IndexedSampleStore(
        tstore.StoreConfig(use_kernel=True, **cfg), rows=rows, keys=keys,
        device="cpu")
    assert kern.n_shards == kops.auto_shards(n, 16, True) > 1
    assert kern.sharded and not tops.fits_vmem(plain.index)
    found, rid = kern.lookup(torch.from_numpy(keys[::97].astype(np.int32)))
    assert bool(found.all())
    np.testing.assert_array_equal(rid.numpy(), np.arange(n)[::97])


def test_store_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.IndexedSampleStore(tstore.StoreConfig(n_samples=16,
                                                     seq_len=4))


def test_data_and_serving_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.data.store, repro_torch.data.pipeline\n"
            "import repro_torch.serving.kvcache\n"
            "import repro_torch.serving.watchdog\n"
            "import repro_torch.runtime.chaos, repro_torch.runtime.ft\n"
            "import repro_torch.launch.index_service\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_index_service_runs_on_the_cpu():
    """The entry point, at a cut size, exits 0 and prints the example's
    lines."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.index_service",
         "--device", "cpu", "--samples", "512", "--pages", "256",
         "--seqs", "8", "--reps", "1"],
        check=True, env=env, timeout=300, capture_output=True, text=True)
    assert "device: cpu" in out.stdout
    assert "128 pages mapped" in out.stdout
    assert "all hits" in out.stdout
    assert "released 4 sequences -> 64 pages live" in out.stdout
