"""The port's data plane and serving index plane on the card, held against
the port's CPU run.

The sample store in every mode (the eager searches, K1 / K2, the clustered
K5 / K6 and the dense K3 / K4 walks) and the page table's seeded stream
(``tests/test_torch_kvcache.py``'s ``_stream``: allocs, lookups through the
eager search or K5 / K6 and K9, releases, in-place splits and merges, the
watchdog at its end) run on the card and on the CPU from the same inputs;
every result, row, free list and index array must be equal, and the card's
runs must launch the kernels of their path.  Needs a CUDA card, nvcc and
no JAX; every test here is marked ``gpu`` and skips without a card.  Run on
a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_data_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import store_to_numpy
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.data.store import IndexedSampleStore, StoreConfig
from repro_torch.kernels import foresight_traverse as tft
from test_torch_kvcache import _Port, drive_stream

pytestmark = pytest.mark.gpu
DEVICES = ("cuda", "cpu")
STORE_MODES = {
    "monolithic": (dict(), None),
    "sharded": (dict(n_shards=4, repack_every=2), None),
    "kernel_k1": (dict(use_kernel=True), tft.foresight_traverse),
    "kernel_k2": (dict(use_kernel=True, foresight=False), tft.base_traverse),
    "kernel_clustered": (dict(use_kernel=True, n_shards=4),
                         tft.foresight_traverse_clustered),
    "kernel_dense": (dict(use_kernel=True, n_shards=4, clustered=False,
                          foresight=False), tft.base_traverse_sharded),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _store_run(dev, cfg):
    """Build, a pipeline batch, ingest and evict of 64 new keys with a
    lookup after each, a scan: ``{name: host array}``."""
    store = IndexedSampleStore(cfg, device=dev)
    out = {f"build.{k}": np.array(v)
           for k, v in store_to_numpy(store).items()}
    batch = DataPipeline(store, PipelineConfig(global_batch=512,
                                               seed=3)).get_batch(1)
    out.update({f"batch.{k}": v.cpu().numpy() for k, v in batch.items()})
    rng = np.random.default_rng(9)
    newk = torch.from_numpy(np.setdiff1d(rng.integers(0, 2**30, 80),
                                         store.keys_np)[:64].astype(
                                             np.int32))
    for name, fn in (("ingest", lambda: store.ingest(
            newk, torch.arange(64, dtype=torch.int32))),
            ("evict", lambda: store.evict(newk))):
        out[f"{name}.res"] = fn().cpu().numpy()
        out.update({f"{name}.{i}": t.cpu().numpy()
                    for i, t in enumerate(store.lookup(newk))})
        out.update({f"{name}.{k}": np.array(v)
                    for k, v in store_to_numpy(store).items()})
    scan = store.range_scan(int(store.keys_np[100]), 2**30, 300)
    out.update({f"scan.{i}": t.cpu().numpy() for i, t in enumerate(scan)})
    return out


@pytest.mark.parametrize("mode", list(STORE_MODES))
def test_store_on_the_card_equals_the_cpu(cuda, mode):
    kw, wrapper = STORE_MODES[mode]
    cfg = StoreConfig(n_samples=3000, seq_len=24, **kw)
    before = wrapper.launches if wrapper else 0
    got = _store_run("cuda", cfg)
    if wrapper:
        assert wrapper.launches > before
    want = _store_run("cpu", cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["batch.found"].all() and got["ingest.0"].all()
    assert not got["evict.0"].any()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("node_width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_page_table_on_the_card_equals_the_cpu(cuda, foresight, node_width,
                                               use_kernel):
    kw = dict(foresight=foresight, node_width=node_width,
              use_kernel=use_kernel)
    walk = (tft.foresight_traverse_clustered if foresight
            else tft.base_traverse_clustered)
    before = walk.launches
    got = {}
    drive_stream(_Port("cuda"), got, **kw)
    assert (walk.launches > before) == use_kernel
    want = {}
    drive_stream(_Port("cpu"), want, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert got["watchdog_ok"]
