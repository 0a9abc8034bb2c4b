"""Carry skiplist states between ``repro`` and the port as numpy arrays.

``state_to_numpy`` / ``state_from_numpy`` use the field names of both
packages' ``SkipListState``, so a test can build a state with one package,
move it across bit for bit (the ``rng`` key included) and search it with
the other.  ``sharded_to_numpy`` / ``sharded_from_numpy`` do the same for
a ``ShardedSkipList``, under the keys ``shards.<field>`` and
``boundaries``.  Fat-layout states carry ``fat_keys``, ``fat_vals`` and
``nlen`` as well.  ``mesh_local_from_numpy`` / ``mesh_to_numpy`` carry
one device's slice of a mesh index, under ``local.shards.<field>``,
``local.boundaries`` and ``device_boundaries``.  ``store_to_numpy`` and
``page_table_to_numpy`` take the whole state of a data-plane sample store
(index and rows) or of a page table (index and free list).

``params_from_numpy`` / ``params_to_numpy`` carry a model's param tree
(nested dicts and lists, as both packages build it) through flat keys such
as ``"blocks.0.mixer.wq"``, with shapes and dtypes kept;
``cache_from_numpy`` / ``cache_to_numpy`` do the same for ``init_cache``'s
tree.  ``opt_state_to_numpy`` / ``opt_state_from_numpy`` carry an AdamW
state (either package's: anything with ``mu``, ``nu`` and ``count``)
under ``mu.<param key>``, ``nu.<param key>`` and ``count``, and
``train_state_to_numpy`` / ``train_state_from_numpy`` a train state
``{"params", "opt"}`` under ``params.`` and ``opt.``.  numpy has no
bfloat16 of its own: a bf16 leaf crosses as its ``uint16`` bit pattern
(an ``ml_dtypes.bfloat16`` array is taken as its bits too), so that the
weights cross bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mesh_index import MeshShardedIndex
from repro_torch.core.sharded import ShardedSkipList
from repro_torch.core.skiplist import SkipListState, resolve_device
from repro_torch.optim.adamw import AdamWState


def _state(arrays: Dict[str, np.ndarray], dev: torch.device
           ) -> SkipListState:
    fields = {}
    for name in SkipListState._fields:
        a = arrays.get(name)
        fields[name] = (None if a is None else
                        torch.from_numpy(np.array(a, copy=True)).to(dev))
    return SkipListState(**fields)


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None
                     ) -> SkipListState:
    """A port state from ``{field: array}`` (``None`` or absent: unset).

    ``device`` follows the package rule: ``None`` means the GPU.  Stacked
    (sharded) arrays go through ``sharded_from_numpy``.
    """
    if np.ndim(arrays["keys"]) != 1:
        raise NotImplementedError("stacked (sharded) arrays convert "
                                  "through sharded_from_numpy")
    return _state(arrays, resolve_device(device))


def state_to_numpy(state: SkipListState) -> Dict[str, np.ndarray]:
    """``{field: array}`` for every set field of ``state``, copied to host."""
    return {name: t.cpu().numpy() for name, t in state._asdict().items()
            if t is not None}


def sharded_from_numpy(arrays: Dict[str, np.ndarray], device=None
                       ) -> ShardedSkipList:
    """A port ``ShardedSkipList`` from ``{"shards.<field>": [S, ...] array,
    "boundaries": [S] array}``."""
    dev = resolve_device(device)
    shards = {k[len("shards."):]: v for k, v in arrays.items()
              if k.startswith("shards.")}
    if np.ndim(shards["keys"]) != 2:
        raise ValueError("shards.keys must be stacked [S, cap]")
    boundaries = torch.from_numpy(
        np.array(arrays["boundaries"], dtype=np.int32, copy=True)).to(dev)
    return ShardedSkipList(_state(shards, dev), boundaries)


def sharded_to_numpy(shl: ShardedSkipList) -> Dict[str, np.ndarray]:
    """``{"shards.<field>": array, "boundaries": array}``, copied to host."""
    out = {f"shards.{k}": v for k, v in state_to_numpy(shl.shards).items()}
    out["boundaries"] = shl.boundaries.cpu().numpy()
    return out


def mesh_local_from_numpy(arrays: Dict[str, np.ndarray], rank: int,
                          device=None) -> MeshShardedIndex:
    """Device ``rank``'s slice of a mesh index from the reference's stacked
    arrays: ``{"local.shards.<field>": [D, S, ...], "local.boundaries":
    [D, S], "device_boundaries": [D]}``."""
    db = np.array(arrays["device_boundaries"], dtype=np.int32, copy=True)
    if not 0 <= rank < db.shape[0]:
        raise ValueError(f"rank {rank} outside the {db.shape[0]} device(s)")
    local = {k[len("local."):]: np.asarray(v)[rank]
             for k, v in arrays.items() if k.startswith("local.")}
    dev = resolve_device(device)
    db = torch.from_numpy(db).to(dev)
    return MeshShardedIndex(sharded_from_numpy(local, dev), db, int(rank))


def mesh_to_numpy(mx: MeshShardedIndex) -> Dict[str, np.ndarray]:
    """This device's slice: ``{"local.shards.<field>": [S, ...],
    "local.boundaries": [S], "device_boundaries": [D]}``, copied to host
    (slice ``rank`` of the reference's stacked arrays)."""
    out = {f"local.{k}": v for k, v in sharded_to_numpy(mx.local).items()}
    out["device_boundaries"] = mx.device_boundaries.cpu().numpy()
    return out


def index_to_numpy(index) -> Dict[str, np.ndarray]:
    """Any of the three index kinds, through its converter above."""
    if isinstance(index, MeshShardedIndex):
        return mesh_to_numpy(index)
    if isinstance(index, ShardedSkipList):
        return sharded_to_numpy(index)
    return state_to_numpy(index)


def store_to_numpy(store) -> Dict[str, np.ndarray]:
    """A ``data.store.IndexedSampleStore``'s index (keys prefixed
    ``index.``) and ``rows``, copied to host."""
    out = {f"index.{k}": v for k, v in index_to_numpy(store.index).items()}
    out["rows"] = store.rows.cpu().numpy()
    return out


def page_table_to_numpy(pt) -> Dict[str, np.ndarray]:
    """A ``serving.kvcache.PageTable``'s index (keys prefixed ``index.``)
    and its ``free`` list in order."""
    out = {f"index.{k}": v for k, v in index_to_numpy(pt.index).items()}
    out["free"] = np.array(pt.free, np.int64)
    return out


# ---------------------------------------------------------------------------
# Model params and decode caches
# ---------------------------------------------------------------------------

def flat_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``("a.0.b", leaf)`` pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_items(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.array(a, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _array(t: Any, bf16: Optional[np.dtype]) -> np.ndarray:
    """A leaf (a tensor, or an array of the reference's) as a host array;
    bf16 as its ``uint16`` bits, or viewed as ``bf16`` when given."""
    if not isinstance(t, torch.Tensor):
        a = np.array(t, copy=True)
        if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
            bits = a.view(np.uint16)
            return bits if bf16 is None else bits.view(bf16)
        return a
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16 is None else bits.view(bf16)
    return t.numpy().copy()


def params_from_numpy(flat: Dict[str, np.ndarray], device=None) -> Any:
    """A tree of tensors (a model's params) from ``{"a.0.b": array}``: dict
    keys, list indices (a node whose keys are all digits is a list),
    leaves as tensors on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    root: Dict[str, Any] = {}
    for key, a in flat.items():
        *path, leaf = key.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _tensor(a, dev)
    return _listify(root)


def params_to_numpy(params: Any, bf16: Optional[np.dtype] = None
                    ) -> Dict[str, np.ndarray]:
    """``{"a.0.b": array}`` of a tree of tensors (or of the reference's
    arrays), copied to host.  A bf16
    leaf comes out as its ``uint16`` bits, or viewed as ``bf16`` (e.g.
    ``ml_dtypes.bfloat16``) when given."""
    return {k: _array(t, bf16) for k, t in flat_items(params)}


# A decode cache (``{"blocks": [...], "pos": ..., "enc_out": ...}``) is the
# same kind of tree.
cache_from_numpy = params_from_numpy
cache_to_numpy = params_to_numpy


# ---------------------------------------------------------------------------
# Optimizer and train states
# ---------------------------------------------------------------------------

def _prefixed(flat: Dict[str, np.ndarray], prefix: str
              ) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def opt_state_to_numpy(state: Any, bf16: Optional[np.dtype] = None
                       ) -> Dict[str, np.ndarray]:
    """``{"mu.<key>", "nu.<key>", "count"}`` of an AdamW state (a bf16
    moment as ``params_to_numpy`` gives it), copied to host."""
    out = {f"mu.{k}": v for k, v in params_to_numpy(state.mu, bf16).items()}
    out.update({f"nu.{k}": v
                for k, v in params_to_numpy(state.nu, bf16).items()})
    out["count"] = _array(state.count, bf16)
    return out


def opt_state_from_numpy(flat: Dict[str, np.ndarray], device=None
                         ) -> AdamWState:
    """An ``optim.adamw.AdamWState`` from ``opt_state_to_numpy``'s keys."""
    dev = resolve_device(device)
    return AdamWState(mu=params_from_numpy(_prefixed(flat, "mu."), dev),
                      nu=params_from_numpy(_prefixed(flat, "nu."), dev),
                      count=_tensor(flat["count"], dev))


def train_state_to_numpy(state: Dict[str, Any],
                         bf16: Optional[np.dtype] = None
                         ) -> Dict[str, np.ndarray]:
    """``{"params.<key>", "opt.<key>"}`` of ``{"params", "opt"}``."""
    out = {f"params.{k}": v
           for k, v in params_to_numpy(state["params"], bf16).items()}
    out.update({f"opt.{k}": v
                for k, v in opt_state_to_numpy(state["opt"], bf16).items()})
    return out


def train_state_from_numpy(flat: Dict[str, np.ndarray], device=None
                           ) -> Dict[str, Any]:
    dev = resolve_device(device)
    return {"params": params_from_numpy(_prefixed(flat, "params."), dev),
            "opt": opt_state_from_numpy(_prefixed(flat, "opt."), dev)}
