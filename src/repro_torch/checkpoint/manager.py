"""Checkpointing: atomic, mesh-agnostic, retention-managed, async-capable
(port of ``repro.checkpoint.manager``, on the same on-disk layout).

Fault-tolerance contract:
* **Atomicity**: writes land in ``<dir>/tmp.<step>.<pid>`` and are renamed
  to ``<dir>/step_<k>`` only after every leaf and the manifest are
  written; a crash mid-save never corrupts the latest checkpoint.
* **Mesh-agnostic restore**: leaves are saved as whole numpy arrays;
  ``restore`` places them on any device, or by a spec tree on any mesh
  (``shardings=``, ``mesh=``), as the reference's ``restore(...,
  shardings)`` does.
* **On a mesh** (DTensor leaves) every rank calls ``save``: each leaf is
  gathered whole (``full_tensor``, a collective, one leaf at a time), and
  rank 0 of the default process group alone keeps it and writes, then
  all ranks meet at a barrier;
  so the files are byte for byte those of the same tree saved from one
  device.  ``save_async`` gathers at once and writes in rank 0's
  thread.
* **Retention**: the newest ``keep`` checkpoints stay; older ones are
  deleted only after a newer one is durable.
* **Async**: ``save_async`` copies to host memory at once and writes in a
  daemon thread, overlapping the disk with the next train steps.

Layout, the reference's: ``leaf_<i>.npy`` (a bf16 leaf as its ``uint16``
bits) and ``leaf_<i>.meta`` (the dtype tag, e.g. ``bfloat16``), then
``MANIFEST.json``.  Leaves go in JAX's flatten order: dict keys sorted,
lists in order, a named tuple (``AdamWState``) in field order, ``None``
no leaf.  So a checkpoint of either package restores in the other.  The
manifest's ``treedef`` is the port's own description of the tree;
``restore`` trusts only ``n_leaves`` and the abstract tree it is given,
as the reference does.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.skiplist import resolve_device
from repro_torch.parallel.sharding import is_dtensor, place_tree

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def tree_flatten(tree: PyTree) -> Tuple[List[Any], Callable]:
    """``(leaves, unflatten)`` in JAX's order: dict keys sorted, lists and
    tuples in order, named tuples in field order, ``None`` no leaf."""
    if tree is None:
        return [], lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]

        def unflatten(it):          # consumed sorted, built in tree's order
            vals = {k: p[1](it) for k, p in zip(keys, parts)}
            return {k: vals[k] for k in tree}
        return [x for p in parts for x in p[0]], unflatten
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        leaves = [x for p in parts for x in p[0]]
        if isinstance(tree, list):
            return leaves, lambda it: [p[1](it) for p in parts]
        if hasattr(tree, "_fields"):
            return leaves, lambda it: type(tree)(*[p[1](it) for p in parts])
        return leaves, lambda it: tuple(p[1](it) for p in parts)
    return [tree], lambda it: next(it)


def treedef_str(tree: PyTree) -> str:
    """The tree's structure with ``*`` for a leaf, in flatten order."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(treedef_str(v) for v in tree) + "]"
    if hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={treedef_str(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, tuple):
        return "(" + ", ".join(treedef_str(v) for v in tree) + ")"
    return "*"


def _host(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a fresh host array (a bf16 tensor as its uint16 bits):
    a copy, so that later in-place writes to ``x`` do not reach it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), t.numpy().dtype.name
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: List[threading.Thread] = []

    # -- discovery ------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------

    def _snapshot(self, tree: PyTree):
        leaves, _ = tree_flatten(tree)
        mesh = any(is_dtensor(x) for x in leaves)
        writer = self._writer(mesh)
        host = []
        for x in leaves:       # every rank gathers (a collective) in order
            whole = x.full_tensor() if is_dtensor(x) else x
            if writer:
                host.append(_host(whole))
        return host, treedef_str(tree), mesh

    @staticmethod
    def _writer(mesh: bool) -> bool:
        """Whether this process writes: every process without a mesh,
        rank 0 of the default group on one."""
        return not mesh or not dist.is_initialized() or dist.get_rank() == 0

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None
             ) -> str:
        leaves, treedef, mesh = self._snapshot(tree)
        final = os.path.join(self.dir, f"step_{step}")
        if self._writer(mesh):
            final = self._write(step, leaves, treedef, extra or {})
        if mesh and dist.is_initialized():
            dist.barrier()
        return final

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[Dict] = None) -> threading.Thread:
        """Snapshot synchronously, write in the background (on a mesh,
        in rank 0's thread; the others' threads do nothing)."""
        leaves, treedef, mesh = self._snapshot(tree)
        args = (step, leaves, treedef, extra or {})
        t = threading.Thread(target=self._write if self._writer(mesh)
                             else lambda *a: None, args=args, daemon=True)
        t.start()
        self._pending.append(t)
        return t

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _write(self, step: int, host_leaves, treedef: str,
               extra: Dict) -> str:
        with self._lock:
            tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (arr, tag) in enumerate(host_leaves):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                with open(os.path.join(tmp, f"leaf_{i}.meta"), "w") as f:
                    f.write(tag)
            manifest = {
                "step": step,
                "n_leaves": len(host_leaves),
                "treedef": treedef,
                "time": time.time(),
                "extra": extra,
            }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)            # atomic publish
            self._gc()
            return final

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, step: int, abstract_tree: PyTree,
                shardings: Optional[PyTree] = None, mesh=None, device=None
                ) -> PyTree:
        """Load the leaves into ``abstract_tree``'s structure (its leaves
        are only counted) as tensors on ``device`` (``None``: the GPU),
        or, given ``shardings`` (a spec tree like the abstract tree) and
        ``mesh`` (a ``launch.mesh.ModelMesh``), on the mesh's device
        placed by the specs: DTensors where the mesh has a
        ``device_mesh``.  Every rank reads the files."""
        if shardings is not None and mesh is None:
            raise ValueError("restore: shardings= needs the mesh= they "
                             "name")
        dev = mesh.device if mesh is not None else resolve_device(device)
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves_abs, unflatten = tree_flatten(abstract_tree)
        assert manifest["n_leaves"] == len(leaves_abs), \
            "checkpoint/model structure mismatch"
        out = []
        for i in range(len(leaves_abs)):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            with open(os.path.join(d, f"leaf_{i}.meta")) as f:
                tag = f.read().strip()
            if tag == "bfloat16":
                arr = arr.view(np.int16)
            t = torch.from_numpy(np.array(arr, copy=True))
            if tag == "bfloat16":
                t = t.view(torch.bfloat16)
            out.append(t.to(dev))
        tree = unflatten(iter(out))
        if shardings is not None:
            tree = place_tree(tree, shardings, mesh)
        return tree

    def restore_latest(self, abstract_tree: PyTree,
                       shardings: Optional[PyTree] = None, mesh=None,
                       device=None
                       ) -> Tuple[Optional[int], Optional[PyTree]]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, abstract_tree, shardings, mesh,
                                  device)
