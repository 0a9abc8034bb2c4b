"""Per-device costs of a traced step (port of ``repro.launch.costs``).

The reference reads XLA's ``compiled.cost_analysis()``; the port has no
compiler, so it counts what a step does while it runs on fake tensors
(``torch._subclasses.fake_tensor``: shapes and dtypes, no storage).
``CostMode`` is a ``FakeTensorMode`` that, besides faking, records every
operation on *local* tensors, the shards a rank holds: a DTensor op
reaches it as the DTensor op (skipped: its shapes are the global ones),
as the ops DTensor's sharding propagation runs on fake tensors of the
global shapes (skipped: the propagation enters this same mode again, and
ops inside that nested entry are not counted) and as each op DTensor
runs on the local shards (counted).  So the counts are one device's:

* ``flops``: the products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and
  their fp32-output ``.dtype`` forms), 2 * M * N * K each, on local
  shapes;
* ``bytes accessed``: every other local op's tensor inputs read once and
  outputs written once (views move nothing);
* ``collectives``: the functional collectives DTensor and the model
  issue (all-gather, all-reduce, reduce-scatter, all-to-all), by kind,
  with the bytes of each one's result, as the reference sums the result
  shapes of the collectives in its HLO;
* memory: the bytes of the live local storages (each storage once, freed
  when its last tensor goes), and their peak.

``cost_dict(trace)`` flattens a trace to the reference's ``cost_dict``
keys.  Importing this module has no side effects (the dry-run's fake
process group is opened by ``launch.dryrun`` when a cell runs).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _product_flops(func, args, out) -> int:
    """2 * M * N * K of a product on its (local) operands, 0 otherwise."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return 0
    return 2 * out.numel() * a.shape[-1]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts one device's work (see the module
    docstring).  ``reset()`` zeroes the work counters and keeps the live
    memory (the step's arguments stay counted in its peak)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._depth = 0
        self._entered = 0
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.ops: Dict[str, int] = {}
        self.peak_bytes = self.live_bytes

    def __enter__(self):
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        outer = self._depth == 0 and self._entered == 1
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if outer and out is not NotImplemented:
            ins = [t for t in tree_leaves((args, kwargs or {}))
                   if isinstance(t, torch.Tensor)]
            if not any(hasattr(t, "placements") for t in ins):
                self._record(func, args, ins, out)
        return out

    def _record(self, func, args, ins, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        key = f"{func.namespace}.{name}"
        self.ops[key] = self.ops.get(key, 0) + 1
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd"):
            if name in COLLECTIVES:
                kind = COLLECTIVES[name]
                c = self.collectives.setdefault(kind, {"bytes": 0, "ops": 0})
                c["bytes"] += sum(_nbytes(t) for t in outs)
                c["ops"] += 1
            if name != "wait_tensor":
                self._track(outs)
            return
        if func.is_view:
            return
        flops = _product_flops(func, args, outs[0]) if outs else 0
        if flops:
            self.flops += flops
        else:
            self.bytes_accessed += (sum(_nbytes(t) for t in ins)
                                    + sum(_nbytes(t) for t in outs))
        self._track(outs)

    def _track(self, outs) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)


def cost_dict(trace) -> Dict[str, Any]:
    """One flat dict of a trace's counts, under the reference's
    ``cost_analysis`` keys: ``flops`` (the products, one device) and
    ``bytes accessed`` (every other op's reads and writes, one device);
    ``{}`` for anything that is not a ``CostMode``."""
    if not isinstance(trace, CostMode):
        return {}
    return {"flops": float(trace.flops),
            "bytes accessed": float(trace.bytes_accessed)}
