"""Index service: the sample store and the paged-KV page table end to end
(port of the entry point ``examples/index_service.py``).

Stands up the skiplist-indexed sample store and the page table (the two
framework deployments of Foresight), drives them with batched reads, page
allocations and releases, and prints the time a lookup takes per index
variant, measured on the device it ran on (host clock around work that
ends in a device synchronise).

    PYTHONPATH=src python -m repro_torch.launch.index_service [--device cpu]

The default sizes are the example's (8192 samples of 64 tokens; a pool of
2048 pages, 32 sequences of 16 blocks); ``--samples``, ``--pages`` and
``--seqs`` cut them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.skiplist import resolve_device
from repro_torch.data.store import IndexedSampleStore, StoreConfig
from repro_torch.serving.kvcache import PagedCacheConfig, PageTable

BLOCKS = 16          # blocks a sequence
STORE_BATCH, PAGE_BATCH = 256, 512


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_lookup_s(fn, dev: torch.device, reps: int, batch: int) -> float:
    fn()                                   # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps / batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--pages", type=int, default=2048)
    ap.add_argument("--seqs", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    rng = np.random.default_rng(0)

    print("== data plane: skiplist-indexed sample store ==")
    for fs in (False, True):
        store = IndexedSampleStore(StoreConfig(
            n_samples=args.samples, seq_len=64, foresight=fs), device=dev)
        keys = torch.from_numpy(store.keys_np[rng.integers(
            0, args.samples, STORE_BATCH)].astype(np.int32))
        dt = _per_lookup_s(lambda: store.get_batch(keys), dev, args.reps,
                           STORE_BATCH)
        print(f"  {'foresight' if fs else 'base     '}: "
              f"{dt * 1e6:7.2f} us/lookup  ({1e-6 / dt:.3f} Mops)")

    print("\n== serving plane: paged-KV page table ==")
    pt = PageTable(PagedCacheConfig(n_pages=args.pages, foresight=True),
                   device=dev)
    for seq in range(args.seqs):
        pt.alloc(np.full(BLOCKS, seq), np.arange(BLOCKS))
    print(f"  {pt.n_live} pages mapped")
    seqs = rng.integers(0, args.seqs, PAGE_BATCH)
    blocks = rng.integers(0, BLOCKS, PAGE_BATCH)
    dt = _per_lookup_s(lambda: pt.lookup(seqs, blocks), dev, args.reps,
                       PAGE_BATCH)
    found, _ = pt.lookup(seqs, blocks)
    if not bool(found.all()):
        raise RuntimeError("page lookup missed a mapped block")
    print(f"  page lookups: {dt * 1e6:7.2f} us/lookup "
          f"({1e-6 / dt:.3f} Mops), all hits")
    for seq in range(args.seqs // 2):
        pt.release(seq, BLOCKS)
    print(f"  released {args.seqs // 2} sequences -> {pt.n_live} pages live")


if __name__ == "__main__":
    main()
