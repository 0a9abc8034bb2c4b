"""Capture audit of the port's entry points (twin of
``repro.analysis.trace_audit``).

The reference traces its jitted entry points to a jaxpr; the port has no
capture yet, so the audit asks what a capture would meet.  For each of
the reference's 13 entry points, built at the reference's small sizes
and shape buckets:

``CAPTURE-BREAK`` (CPU)
    the entry point runs under ``torch.compile(backend=eager)`` through
    ``torch._dynamo``'s explain backend (``ExplainWithBackend``), on its
    CPU path; every distinct graph break (its reason and the innermost
    frame of the port) is a finding.  An entry point that dynamo cannot
    run at all (a collective, say) is a finding with dynamo's reason.
``CAPTURE-RECOMPILE`` (CPU)
    within a shape bucket, every call after the first must reuse the
    graphs the first compiled; a compile there is a finding (the twin of
    ``TRACE-RETRACE``: one trace per bucket).
``CAPTURE-SYNC`` (card only)
    one call of each entry point under
    ``torch.cuda.set_sync_debug_mode("warn")``; each synchronising CUDA
    call's warning is recorded with the innermost frame of the port, and
    each distinct site is a finding.  The count a call (and a op, for
    the update paths) is reported beside it.
``AUDIT-GAP``
    a function of ``core/`` or ``kernels/`` whose name the reference jits
    (``REFERENCE_JITTED``, copied from an AST scan of ``src/repro``) must
    be an entry point or sit in ``AUDIT_EXEMPT`` with a reason.

The mesh entry points run at D = 1 on a one-rank process group (gloo on
the CPU, NCCL on the card, an in-process store), made here when none is
initialised and destroyed afterwards.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import functools
import logging
import os
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Finding

_PKG = Path(__file__).resolve().parent.parent        # src/repro_torch
_ROOT = _PKG.parent.parent                            # the repository


@dataclasses.dataclass
class EntryPoint:
    """One audited entry point.

    ``build(device)`` returns ``(fn, buckets)``: ``buckets`` maps a shape
    bucket's name to the argument tuples that must share its graphs.
    ``ops`` is the op count of one call of an update path (0 elsewhere),
    for the syncs a op.
    """

    name: str
    path: str
    build: Callable[[torch.device], Tuple[Callable, Dict[str, List[Tuple]]]]
    ops: int = 0


# ---------------------------------------------------------------------------
# The entry points, at the reference's sizes
# ---------------------------------------------------------------------------

def _full(n: int, v: int, dev) -> torch.Tensor:
    return torch.full((n,), v, dtype=torch.int32, device=dev)


def _keys_vals(n: int, step: int, dev):
    keys = torch.arange(1, n + 1, dtype=torch.int32, device=dev) * step
    return keys, torch.arange(n, dtype=torch.int32, device=dev)


def _build_search_sharded(foresight: bool, cluster: bool, node_width: int,
                          dev):
    from repro_torch.core import sharded as shd
    from repro_torch.kernels import ops as kops

    keys, vals = _keys_vals(64, 5, dev)
    shl = shd.build_sharded(keys, vals, n_shards=4, levels=4,
                            foresight=foresight, seed=0,
                            node_width=node_width, device=dev)

    def fn(q):
        return kops.search_kernel_sharded(shl, q, cluster=cluster)

    return fn, {"qblk": [(_full(128, 30, dev),), (_full(128, 95, dev),)],
                "2qblk": [(_full(256, 30, dev),)]}


def _clone_sharded(shl):
    from repro_torch.core.sharded import ShardedSkipList
    from repro_torch.core.skiplist import SkipListState

    return ShardedSkipList(
        SkipListState(*(None if t is None else t.clone()
                        for t in shl.shards)), shl.boundaries.clone())


def _build_rebalance(which: str, dev):
    from repro_torch.core import rebalance_traced as rt
    from repro_torch.core import sharded as shd
    from repro_torch.core import skiplist as sl

    keys, vals = _keys_vals(64, 5, dev)
    shl = rt.pad_shards(shd.build_sharded(keys, vals, n_shards=4, levels=4,
                                          foresight=True, seed=0,
                                          device=dev), max_shards=8)
    shl2 = _clone_sharded(shl)        # same shapes, fresh buffers
    if which == "watermark":
        def fn(s):
            return rt.watermark_rebalance_traced(s, seed=0)

        return fn, {"padded8": [(shl,), (shl2,)]}

    def fn(s, op_types, ks):
        return rt.exhaustion_guard_traced(s, op_types, ks, seed=0)

    ins = _full(16, sl.OP_INSERT, dev)
    k1 = torch.arange(1000, 1016, dtype=torch.int32, device=dev)
    return fn, {"padded8-b16": [(shl, ins, k1), (shl2, ins, k1 + 1000)]}


def _build_kvcache_apply(dev):
    """``PageTable._apply`` on a fixed table: its pow2 padding, then the
    in-place ``apply_ops_sharded`` with rebalancing; the table's index is
    put back before each call so that every call sees the same state."""
    from repro_torch.core import skiplist as sl
    from repro_torch.serving.kvcache import PagedCacheConfig, PageTable

    pt = PageTable(PagedCacheConfig(n_pages=256, levels=4, n_shards=2,
                                    rebalance=True, max_shards=4),
                   device=dev)
    index = pt.index

    def fn(op_types, ks, vs):
        pt.index = index
        return pt._apply(op_types, ks, vs)

    k = torch.arange(1, 9, dtype=torch.int32, device=dev)
    v = torch.arange(8, dtype=torch.int32, device=dev)
    ins, rd = _full(8, sl.OP_INSERT, dev), _full(8, sl.OP_READ, dev)
    return fn, {"b8": [(ins, k, v), (ins, k + 100, v), (rd, k, v)]}


def _versioned_index(dev):
    from repro_torch.core import skiplist as sl
    from repro_torch.core.versioned import VersionedIndex

    keys, vals = _keys_vals(64, 3, dev)
    return VersionedIndex(sl.build(keys, vals, capacity=256, levels=8,
                                   foresight=True, seed=0, device=dev))


def _build_versioned(which: str, dev):
    from repro_torch.core import skiplist as sl

    vi = _versioned_index(dev)
    if which == "read":
        # a second version makes lag=1 a mixed view (stale fused pointers,
        # fresh keys): the validated read, K8 on the card
        st2, _ = sl.apply_ops(vi.current, _full(4, sl.OP_INSERT, dev),
                              torch.arange(500, 504, dtype=torch.int32,
                                           device=dev),
                              torch.arange(4, dtype=torch.int32, device=dev))
        vi.publish(st2)

        def fn(q):
            return vi.search(q, lag=1, use_kernel=True)

        return fn, {"q128": [(_full(128, 33, dev),), (_full(128, 99, dev),)]}

    def fn(op_types, ks, vs):
        return vi.update(op_types, ks, vs)

    k = torch.arange(200, 208, dtype=torch.int32, device=dev)
    v = torch.arange(8, dtype=torch.int32, device=dev)
    ops = _full(8, sl.OP_INSERT, dev)
    return fn, {"b8": [(ops, k, v), (ops, k + 50, v)]}


def _build_mesh(which: str, dev):
    """A one-device index mesh: the collective path runs the same at any
    D, and D = 1 needs one rank (see ``process_group``)."""
    from repro_torch.core import mesh_index as mi
    from repro_torch.core import skiplist as sl
    from repro_torch.launch.mesh import make_index_mesh

    mesh = make_index_mesh(1, device=None if dev.type == "cuda" else "cpu")
    keys, vals = _keys_vals(64, 5, dev)
    mx = mi.build_mesh_index(keys, vals, n_devices=1, n_shards=4, levels=4,
                             rank=0, device=dev)
    args = (mx.local, mx.device_boundaries)
    q128 = [args + (_full(128, 30, dev),), args + (_full(128, 95, dev),)]
    if which == "search":
        def fn(local, db, q):
            return mi.search_mesh(mi.MeshShardedIndex(local, db, 0), q,
                                  mesh=mesh)

        return fn, {"q128": q128, "q64": [args + (_full(64, 30, dev),)]}
    if which == "kernel":
        from repro_torch.kernels import mesh_launch as ml

        def fn(local, db, q):
            return ml.search_kernel_mesh(mi.MeshShardedIndex(local, db, 0),
                                         q, mesh=mesh)

        return fn, {"q128": q128}

    emp = mi.empty_mesh_index(n_devices=1, n_shards=4, capacity=64,
                              levels=4, key_span=1 << 20, rank=0,
                              device=dev)

    def fn(local, db, op_types, ks, vs):
        return mi.apply_ops_mesh(mi.MeshShardedIndex(local, db, 0),
                                 op_types, ks, vs, mesh=mesh,
                                 rebalance=True, seed=0)

    k = torch.arange(1, 9, dtype=torch.int32, device=dev)
    v = torch.arange(8, dtype=torch.int32, device=dev)
    ins, rd = _full(8, sl.OP_INSERT, dev), _full(8, sl.OP_READ, dev)
    a = (emp.local, emp.device_boundaries)
    return fn, {"b8": [a + (ins, k, v), a + (ins, k + 100, v),
                       a + (rd, k, v)]}


def default_entry_points() -> List[EntryPoint]:
    p = functools.partial
    ops_py = "src/repro_torch/kernels/ops.py"
    rt_py = "src/repro_torch/core/rebalance_traced.py"
    vi_py = "src/repro_torch/core/versioned.py"
    mi_py = "src/repro_torch/core/mesh_index.py"
    return [
        EntryPoint("search_kernel_sharded[fg,clustered]", ops_py,
                   p(_build_search_sharded, True, True, 1)),
        EntryPoint("search_kernel_sharded[fg,plain]", ops_py,
                   p(_build_search_sharded, True, False, 1)),
        EntryPoint("search_kernel_sharded[base,clustered]", ops_py,
                   p(_build_search_sharded, False, True, 1)),
        EntryPoint("search_kernel_sharded[fg,clustered,fat]", ops_py,
                   p(_build_search_sharded, True, True, 8)),
        EntryPoint("search_kernel_sharded[fg,plain,fat]", ops_py,
                   p(_build_search_sharded, True, False, 8)),
        EntryPoint("watermark_rebalance_traced", rt_py,
                   p(_build_rebalance, "watermark")),
        EntryPoint("exhaustion_guard_traced", rt_py,
                   p(_build_rebalance, "exhaustion"), ops=16),
        EntryPoint("PageTable._apply", "src/repro_torch/serving/kvcache.py",
                   _build_kvcache_apply, ops=8),
        EntryPoint("VersionedIndex.read_view().search", vi_py,
                   p(_build_versioned, "read")),
        EntryPoint("VersionedIndex.update", vi_py,
                   p(_build_versioned, "update"), ops=8),
        EntryPoint("search_mesh[eager]", mi_py, p(_build_mesh, "search")),
        EntryPoint("apply_ops_mesh[rebalance]", mi_py,
                   p(_build_mesh, "apply"), ops=8),
        EntryPoint("search_kernel_mesh[fg,clustered]",
                   "src/repro_torch/kernels/mesh_launch.py",
                   p(_build_mesh, "kernel")),
    ]


@contextlib.contextmanager
def process_group(dev: torch.device):
    """A one-rank default process group for the mesh entry points: the
    caller's, if one is initialised, else one made here (gloo, plus NCCL
    for the card; an in-process store) and destroyed on exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# CAPTURE-BREAK / CAPTURE-RECOMPILE (CPU)
# ---------------------------------------------------------------------------

def _port_frame(frames) -> Optional[traceback.FrameSummary]:
    """The innermost frame in the port's package outside this tool; else
    the innermost outside torch and the warnings module (the caller's)."""
    frames = list(frames)
    for fr in reversed(frames):
        path = Path(fr.filename).resolve()
        if _PKG in path.parents and (_PKG / "analysis") not in path.parents:
            return fr
    skip = (Path(torch.__file__).resolve().parent, Path(warnings.__file__))
    for fr in reversed(frames):
        path = Path(fr.filename).resolve()
        if path != skip[1] and skip[0] not in path.parents:
            return fr
    return None


def _site(fr: Optional[traceback.FrameSummary]) -> Tuple[str, str, int]:
    if fr is None:
        return "<outside the port>", "?", 0
    path = Path(fr.filename).resolve()
    try:
        rel = str(path.relative_to(_ROOT))
    except ValueError:
        rel = str(path)
    return rel, fr.name, fr.lineno or 0


@contextlib.contextmanager
def _quiet_dynamo():
    """Dynamo logs every graph break as a warning: the audit reports them."""
    logger = logging.getLogger("torch._dynamo")
    level = logger.level
    logger.setLevel(logging.ERROR)
    try:
        yield
    finally:
        logger.setLevel(level)


@dataclasses.dataclass
class CaptureStats:
    name: str
    graphs: int = 0           # graphs compiled on the first call
    breaks: int = 0           # graph breaks on the first call
    recompiles: int = 0       # graphs compiled in a bucket after its first
    seconds: float = 0.0


def capture_entry(ep: EntryPoint) -> Tuple[List[Finding], CaptureStats]:
    """Run ``ep`` on the CPU under dynamo's explain backend: its breaks on
    the first call, then every bucket's later calls for recompiles."""
    from torch._dynamo.backends.debugging import ExplainWithBackend

    stats = CaptureStats(ep.name)
    t0 = time.perf_counter()
    findings: List[Finding] = []
    torch._dynamo.reset()
    fn, buckets = ep.build(torch.device("cpu"))
    eb = ExplainWithBackend("eager")
    compiled = torch.compile(fn, backend=eb)
    seen_graphs = 0
    first = True
    for bucket, cases in buckets.items():
        for i, args in enumerate(cases):
            try:
                with _quiet_dynamo():
                    compiled(*args)
            except Exception as e:   # dynamo could not run it: a finding
                findings.append(Finding(
                    rule="CAPTURE-BREAK", path=ep.path, line=0,
                    symbol=ep.name,
                    message=f"dynamo cannot run the entry point "
                            f"(bucket `{bucket}`): "
                            f"{type(e).__name__}: "
                            f"{str(e).splitlines()[0] if str(e) else ''}"))
                stats.seconds = time.perf_counter() - t0
                torch._dynamo.reset()
                return findings, stats
            n = len(eb.graphs)
            if first:
                stats.graphs, stats.breaks = n, len(eb.break_reasons)
                findings.extend(_break_findings(ep, eb.break_reasons))
                first = False
            elif i > 0 and n > seen_graphs:
                stats.recompiles += n - seen_graphs
                findings.append(Finding(
                    rule="CAPTURE-RECOMPILE", path=ep.path, line=0,
                    symbol=ep.name,
                    message=f"shape bucket `{bucket}` compiled "
                            f"{n - seen_graphs} more graph(s) on call "
                            f"{i + 1} of {len(cases)} (expected none after "
                            "the bucket's first call)"))
            seen_graphs = n
    torch._dynamo.reset()
    stats.seconds = time.perf_counter() - t0
    return findings, stats


def _break_findings(ep: EntryPoint, reasons) -> List[Finding]:
    """One finding per distinct (port frame, reason) of the breaks."""
    out, seen = [], set()
    for br in reasons:
        path, func, line = _site(_port_frame(br.user_stack))
        head = (br.reason or "").strip().splitlines()[0] if br.reason \
            else "graph break"
        if (path, line, head) in seen:
            continue
        seen.add((path, line, head))
        out.append(Finding(
            rule="CAPTURE-BREAK", path=ep.path, line=0, symbol=ep.name,
            message=f"graph break at {path}:{line} ({func}): {head}"))
    return out


def run_capture_audit(entry_points: Optional[Sequence[EntryPoint]] = None
                      ) -> Tuple[List[Finding], List[str],
                                 List[CaptureStats]]:
    """CAPTURE-BREAK and CAPTURE-RECOMPILE of every entry point, on the
    CPU: (findings, audited names, per-entry statistics)."""
    eps = list(entry_points if entry_points is not None
               else default_entry_points())
    findings: List[Finding] = []
    stats: List[CaptureStats] = []
    with process_group(torch.device("cpu")):
        for ep in eps:
            fs, st = capture_entry(ep)
            findings.extend(fs)
            stats.append(st)
    return findings, [ep.name for ep in eps], stats


# ---------------------------------------------------------------------------
# CAPTURE-SYNC (the card)
# ---------------------------------------------------------------------------

#: what ``set_sync_debug_mode("warn")`` warns at each synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def count_syncs():
    """Record every synchronising CUDA call made inside the block: a list
    of (path, function, line) of the innermost frame of the port at each
    ``set_sync_debug_mode("warn")`` warning.  The mode and the warning
    filters are restored on exit."""
    sites: List[Tuple[str, str, int]] = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):      # the stack without this hook
            sites.append(_site(_port_frame(traceback.extract_stack()[:-1])))

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def sync_entry(ep: EntryPoint, dev: torch.device
               ) -> Tuple[List[Finding], dict]:
    """One call of ``ep``'s first case on the card, after a warm-up call,
    under sync-debug mode: (one finding per distinct site, the counts)."""
    fn, buckets = ep.build(dev)
    args = next(iter(buckets.values()))[0]
    fn(*args)
    torch.cuda.synchronize()
    with count_syncs() as sites:
        fn(*args)
    torch.cuda.synchronize()
    per_site: Dict[Tuple[str, str], int] = {}
    lines: Dict[Tuple[str, str], int] = {}
    for path, func, line in sites:
        per_site[(path, func)] = per_site.get((path, func), 0) + 1
        lines.setdefault((path, func), line)
    findings = [Finding(
        rule="CAPTURE-SYNC", path=path, line=lines[(path, func)],
        symbol=f"{ep.name} <- {func}",
        message=f"{n} synchronising CUDA call(s) a call of {ep.name} here")
        for (path, func), n in sorted(per_site.items())]
    row = {"syncs": len(sites),
           "sites": {f"{p}:{f}": n for (p, f), n in sorted(per_site.items())}}
    if ep.ops:
        row["ops"] = ep.ops
        row["per_op"] = len(sites) / ep.ops
    return findings, row


def run_sync_audit(entry_points: Optional[Sequence[EntryPoint]] = None
                   ) -> Tuple[List[Finding], Dict[str, dict]]:
    """CAPTURE-SYNC of every entry point on the card: (findings, the
    counts a call by entry point).  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the sync pass counts synchronising CUDA calls "
                           "and needs a CUDA card")
    dev = torch.device("cuda")
    findings: List[Finding] = []
    rows: Dict[str, dict] = {}
    with process_group(dev):
        for ep in (entry_points if entry_points is not None
                   else default_entry_points()):
            fs, rows[ep.name] = sync_entry(ep, dev)
            findings.extend(fs)
    return findings, rows


# ---------------------------------------------------------------------------
# Audit coverage (AUDIT-GAP)
# ---------------------------------------------------------------------------

#: the public functions ``src/repro/core`` and ``src/repro/kernels`` jit
#: (``@jax.jit`` or ``functools.partial(jax.jit, ...)``), by file; a CPU
#: test holds this copy against an AST scan of the reference
REFERENCE_JITTED = {
    "core/sharded.py": ("build_sharded",),
    "core/skiplist.py": ("build",),
    "kernels/foresight_traverse.py": (
        "foresight_traverse", "foresight_traverse_sharded",
        "base_traverse_sharded", "foresight_traverse_clustered",
        "base_traverse_clustered", "base_traverse"),
    "kernels/ops.py": ("shard_state",),
    "kernels/validated_traverse.py": ("validated_traverse",),
}

#: names the reference jits that are deliberately not entry points here,
#: each with the reason (the reference's ``AUDIT_EXEMPT``, copied)
AUDIT_EXEMPT = {
    "build": "bulk constructor — one call per index lifetime, not a "
             "serving-path entry point",
    "build_sharded": "bulk constructor — one call per index lifetime",
    "shard_state": "one-shot monolithic->sharded converter, build-time only",
    "foresight_traverse": "kernel wrapper launched (and audited) via "
                          "search_kernel",
    "base_traverse": "kernel wrapper launched via search_kernel",
    "foresight_traverse_sharded": "kernel wrapper launched via the audited "
                                  "search_kernel_sharded entry points",
    "base_traverse_sharded": "kernel wrapper launched via the audited "
                             "search_kernel_sharded entry points",
    "foresight_traverse_clustered": "kernel wrapper launched via the "
                                    "audited search_kernel_sharded entry "
                                    "points",
    "base_traverse_clustered": "kernel wrapper launched via the audited "
                               "search_kernel_sharded entry points",
    "validated_traverse": "kernel wrapper launched via the audited "
                          "VersionedIndex.read_view().search entry point",
}

#: directories of the port whose functions of those names are checked
AUDIT_SCOPE = ("src/repro_torch/core", "src/repro_torch/kernels")


def audited_symbols() -> set:
    """Entry-point names with their ``[variant]`` suffixes stripped."""
    return {ep.name.split("[")[0].split("(")[0].rstrip(".")
            for ep in default_entry_points()}


def audit_coverage(root: str) -> List[Finding]:
    """AUDIT-GAP: a port function named as one the reference jits that is
    neither an entry point (by its name or a method's last name) nor in
    ``AUDIT_EXEMPT``."""
    jitted = {n for names in REFERENCE_JITTED.values() for n in names}
    covered = audited_symbols()
    covered_tails = {c.split(".")[-1] for c in covered}
    out: List[Finding] = []
    for scope in AUDIT_SCOPE:
        base = os.path.join(root, scope)
        if not os.path.isdir(base):
            continue
        for fname in sorted(os.listdir(base)):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(base, fname)
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if node.name not in jitted or node.name in covered or \
                        node.name in covered_tails or \
                        node.name in AUDIT_EXEMPT:
                    continue
                out.append(Finding(
                    rule="AUDIT-GAP", path=os.path.join(scope, fname),
                    line=node.lineno, symbol=node.name,
                    message=f"`{node.name}` is jitted in the reference but "
                            "is not in capture_audit.default_entry_points()"
                            " — add an EntryPoint or an AUDIT_EXEMPT entry "
                            "with a reason"))
    return out
