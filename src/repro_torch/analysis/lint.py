"""AST lint pass: host syncs, silent degradation, kernel routing.

Port of ``repro.analysis.lint``: pure-source analysis over
``src/repro_torch`` (no import, no execution).  The pass indexes every
module (imports, function qualnames, call graph), seeds a
*capture-reachable* set, propagates it through the intra-repo call graph
and applies three rules:

``HOST-SYNC``
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()`` /
    ``float()`` / ``bool()`` on a non-literal, ``np.asarray`` /
    ``np.array``, ``torch.cuda.synchronize`` and ``.nonzero()`` /
    ``torch.nonzero`` (no static size) in a capture-reachable function:
    each is a device->host round trip that stops the stream and breaks a
    ``torch.compile`` graph or a CUDA graph capture.  Eager-only helpers
    are free to touch host values.

``SILENT-DEGRADE``
    an ``except`` handler that neither re-raises nor warns (nor exits),
    where the ``try`` body or the handler touches device code:
    ``torch.cuda``, the ``_build`` library, ``ctypes`` or a ``*_launch``
    symbol.  Applies everywhere, ``chip_smoke.py`` included: a phase
    whose failure is caught while the run still exits 0 is this bug.

``KERNEL-ROUTE``
    a public wrapper in ``kernels/`` that reaches a ``_build`` launch and
    picks its ``*_plain`` twin by anything but the tensors' device: a
    flag, an environment variable, a caught error, or no test at all.

Seeds: ``CAPTURE_SEEDS`` (the functions the port means to capture, the
twins of the reference's traced entry points), every function decorated
with ``torch.compile`` and every ``torch.compile(f)`` reference.

Suppression: a ``# trace-ok: <reason>`` comment on the flagged line, on
the enclosing ``def`` line or on the line above it marks the finding
suppressed (listed in the report, not a failure); on the ``def`` it
covers every finding in that function.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

TRACE_OK_RE = re.compile(r"#\s*trace-ok:\s*(.+?)\s*$")

#: call names that force a host round trip
_HOST_CASTS = {"int", "float", "bool"}
#: attribute calls that force one
_HOST_ATTRS = {"item", "tolist", "cpu", "numpy", "nonzero"}
#: numpy conversions (module alias resolved per file)
_NP_CONVERTERS = {"asarray", "array"}
#: dotted calls that force one
_HOST_CALLS = {"torch.cuda.synchronize", "torch.nonzero"}

#: functions the port means to capture (item 7b): the twins of the
#: reference's traced entry points (``repro.analysis.lint.EXTRA_SEEDS``
#: and ``trace_audit.default_entry_points``)
CAPTURE_SEEDS = (
    "repro_torch.kernels.ops:search_kernel_sharded",
    "repro_torch.kernels.ops:search_kernel",
    "repro_torch.core.rebalance_traced:watermark_rebalance_traced",
    "repro_torch.core.rebalance_traced:exhaustion_guard_traced",
    "repro_torch.core.sharded:apply_ops_sharded",
    "repro_torch.core.versioned:VersionedIndex.search",
    "repro_torch.core.versioned:VersionedIndex.update",
    "repro_torch.serving.kvcache:PageTable._apply",
    "repro_torch.core.mesh_index:search_mesh",
    "repro_torch.core.mesh_index:apply_ops_mesh",
    "repro_torch.kernels.mesh_launch:search_kernel_mesh",
    "repro_torch.core.skiplist:range_scan",
    "repro_torch.core.skiplist:to_sorted_keys",
    "repro_torch.core.sharded:range_scan_sharded",
)

#: the module that builds and launches the CUDA kernels
_BUILD = "repro_torch.kernels._build"

#: files outside the package that the SILENT-DEGRADE rule also reads
EXTRA_FILES = ("chip_smoke.py",)


# ---------------------------------------------------------------------------
# Per-module scan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionInfo:
    qualname: str            # "module.sub:Outer.fn"
    module: str              # dotted module ("repro_torch.kernels.ops")
    name: str                # bare name
    node: ast.AST            # FunctionDef / AsyncFunctionDef
    calls: Set[str] = dataclasses.field(default_factory=set)  # resolved
    is_seed: bool = False
    seed_why: str = ""


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """("torch", "cuda", "synchronize") for an attribute chain on a name;
    None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class ModuleScan:
    """AST index of one source file."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.rel = str(path.relative_to(root))
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        self.module = self._module_name(root)
        # import alias -> dotted target ("np" -> "numpy",
        # "shd" -> "repro_torch.core.sharded")
        self.aliases: Dict[str, str] = {}
        self.functions: Dict[str, FunctionInfo] = {}   # qualname -> info
        self._collect_imports()
        self._collect_functions()

    def _module_name(self, root: Path) -> str:
        parts = list(self.path.relative_to(root).with_suffix("").parts)
        if parts and parts[0] == "src":
            parts = parts[1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        self.aliases[head] = head
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def _collect_functions(self) -> None:
        mod = self

        class V(ast.NodeVisitor):
            def __init__(self):
                self.stack: List[str] = []

            def _add(self, node):
                qual = ".".join(self.stack + [node.name])
                info = FunctionInfo(
                    qualname=f"{mod.module}:{qual}", module=mod.module,
                    name=node.name, node=node)
                mod.functions[info.qualname] = info
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

            visit_FunctionDef = _add
            visit_AsyncFunctionDef = _add

            def visit_ClassDef(self, node):
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

        V().visit(self.tree)

    # -- annotation lookup --------------------------------------------------
    def trace_ok_reason(self, lineno: int) -> Optional[str]:
        if 1 <= lineno <= len(self.lines):
            m = TRACE_OK_RE.search(self.lines[lineno - 1])
            if m:
                return m.group(1)
        return None

    def def_trace_ok(self, fn: FunctionInfo) -> Optional[str]:
        node = fn.node
        for ln in (node.lineno, node.lineno - 1):
            r = self.trace_ok_reason(ln)
            if r:
                return r
        for deco in getattr(node, "decorator_list", ()):
            r = self.trace_ok_reason(deco.lineno) or \
                self.trace_ok_reason(deco.lineno - 1)
            if r:
                return r
        return None

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted source name of an expression, aliases expanded."""
        parts = _dotted(node)
        if parts is None:
            return None
        head = self.aliases.get(parts[0], parts[0])
        return ".".join((head,) + parts[1:])

    def enclosing(self, node: ast.AST) -> Optional[FunctionInfo]:
        best = None
        for info in self.functions.values():
            f = info.node
            if f.lineno <= node.lineno <= (f.end_lineno or f.lineno):
                if best is None or f.lineno > best.node.lineno:
                    best = info
        return best


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """The nodes of ``fn``'s body that belong to no nested function (a
    nested one has its own ``FunctionInfo``)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _is_compile(dotted: str) -> bool:
    return dotted in ("torch.compile", "torch._dynamo.optimize")


# ---------------------------------------------------------------------------
# Repo-wide index + capture-reachability propagation
# ---------------------------------------------------------------------------

class RepoLint:
    def __init__(self, root: Path,
                 src_dirs: Tuple[str, ...] = ("src/repro_torch",),
                 seeds: Tuple[str, ...] = CAPTURE_SEEDS,
                 extra_files: Tuple[str, ...] = EXTRA_FILES):
        self.root = root
        self.scans: List[ModuleScan] = []
        for d in src_dirs:
            for p in sorted((root / d).rglob("*.py")):
                self.scans.append(ModuleScan(p, root))
        # read by SILENT-DEGRADE only: never call-graph targets
        self.extra_scans = [ModuleScan(root / f, root) for f in extra_files
                            if (root / f).is_file()]
        self.by_qual: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        for scan in self.scans:
            for info in scan.functions.values():
                self.by_qual[info.qualname] = info
                self.by_name.setdefault(info.name, []).append(info)
        self._build_call_graph()
        self._seed(seeds)
        self._propagate()

    # -- call graph ---------------------------------------------------------
    def _resolve_target(self, scan: ModuleScan, dotted: str
                        ) -> Optional[str]:
        """Map a resolved dotted name onto a known FunctionInfo."""
        head, _, tail = dotted.rpartition(".")
        if head:
            cand = f"{head}:{tail}"
            if cand in self.by_qual:
                return cand
        # bare name (or a method's) inside the same module
        for info in self.by_name.get(dotted.split(".")[-1], ()):
            if info.module == scan.module:
                return info.qualname
        # unique bare name anywhere in the scanned tree
        hits = self.by_name.get(dotted, ())
        if len(hits) == 1:
            return hits[0].qualname
        return None

    def _build_call_graph(self) -> None:
        for scan in self.scans:
            for info in scan.functions.values():
                for node in _own_nodes(info.node):
                    if isinstance(node, ast.Call):
                        dotted = scan.resolve(node.func)
                        target = dotted and self._resolve_target(scan,
                                                                 dotted)
                        if target:
                            info.calls.add(target)
                        elif dotted and dotted.startswith(_BUILD + "."):
                            # the kernel library, scanned or not
                            info.calls.add(
                                f"{_BUILD}:{dotted[len(_BUILD) + 1:]}")
                    elif isinstance(node, ast.Attribute) and \
                            isinstance(node.ctx, ast.Load):
                        # a module-qualified function reference
                        # (``kernel = ft.a if x else ft.b``) is an edge
                        dotted = scan.resolve(node) or ""
                        head, _, tail = dotted.rpartition(".")
                        if f"{head}:{tail}" in self.by_qual:
                            info.calls.add(f"{head}:{tail}")
                # nested functions run when their parent calls them
                for sub in scan.functions.values():
                    if sub.qualname.startswith(info.qualname + ".") and \
                            sub.qualname.count(".") == \
                            info.qualname.count(".") + 1:
                        info.calls.add(sub.qualname)

    # -- seeds --------------------------------------------------------------
    def _mark_seed(self, qual: str, why: str) -> None:
        info = self.by_qual.get(qual)
        if info and not info.is_seed:
            info.is_seed = True
            info.seed_why = why

    def _seed(self, seeds: Tuple[str, ...]) -> None:
        for qual in seeds:
            self._mark_seed(qual, "listed capture seed")
        for scan in self.scans:
            for info in scan.functions.values():
                for deco in getattr(info.node, "decorator_list", ()):
                    target = deco.func if isinstance(deco, ast.Call) \
                        else deco
                    if _is_compile(scan.resolve(target) or ""):
                        self._mark_seed(info.qualname,
                                        "@torch.compile decorator")
            for node in ast.walk(scan.tree):
                if isinstance(node, ast.Call) and \
                        _is_compile(scan.resolve(node.func) or "") and \
                        node.args:
                    # a module-level function or an imported one (a local
                    # variable of the same name is not that function)
                    dotted = scan.resolve(node.args[0]) or ""
                    target = (self._resolve_target(scan, dotted)
                              if "." in dotted else
                              f"{scan.module}:{dotted}")
                    if target in self.by_qual:
                        self._mark_seed(target, "torch.compile(...) "
                                                "reference")

    def _propagate(self) -> None:
        frontier = [i for i in self.by_qual.values() if i.is_seed]
        while frontier:
            info = frontier.pop()
            for callee_qual in info.calls:
                callee = self.by_qual.get(callee_qual)
                if callee and not callee.is_seed:
                    callee.is_seed = True
                    callee.seed_why = f"called from {info.qualname}"
                    frontier.append(callee)

    def reachable(self) -> List[str]:
        return sorted(q for q, i in self.by_qual.items() if i.is_seed)

    def reaches(self, qual: str, pred) -> bool:
        """Whether ``qual`` or anything it calls (by qualname) satisfies
        ``pred``."""
        seen, todo = set(), [qual]
        while todo:
            q = todo.pop()
            if q in seen:
                continue
            seen.add(q)
            if pred(q):
                return True
            if q in self.by_qual:
                todo.extend(self.by_qual[q].calls)
        return False

    # -- rules --------------------------------------------------------------
    def run(self) -> List[Finding]:
        findings: List[Finding] = []
        for scan in self.scans + self.extra_scans:
            findings.extend(self._rule_silent_degrade(scan))
        for scan in self.scans:
            if ".kernels." in f".{scan.module}.":
                findings.extend(self._rule_kernel_route(scan))
            for info in scan.functions.values():
                if info.is_seed:
                    findings.extend(self._rule_host_sync(scan, info))
        return findings

    def _mk(self, scan: ModuleScan, info: Optional[FunctionInfo],
            node: ast.AST, rule: str, msg: str) -> Finding:
        reason = scan.trace_ok_reason(node.lineno)
        if reason is None and info is not None:
            reason = scan.def_trace_ok(info)
        symbol = info.qualname.split(":", 1)[1] if info else "<module>"
        return Finding(rule=rule, path=scan.rel, line=node.lineno,
                       symbol=symbol, message=msg,
                       suppressed=reason is not None, reason=reason)

    # HOST-SYNC ------------------------------------------------------------
    def _host_sync_msg(self, scan: ModuleScan, node: ast.Call
                       ) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name) and func.id in _HOST_CASTS and \
                node.args and not isinstance(node.args[0], ast.Constant):
            return (f"{func.id}() of a non-literal: on a tensor it copies "
                    "to the host and waits for the stream")
        dotted = scan.resolve(func) or ""
        if dotted in _HOST_CALLS:
            what = ("synchronize stops the host until the card is idle"
                    if dotted.endswith("synchronize") else
                    "nonzero has a data-dependent size: the host waits for "
                    "it")
            return f"{dotted}: {what}"
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr in _NP_CONVERTERS:
            base = _dotted(func.value)
            if base and scan.aliases.get(base[0], base[0]) == "numpy":
                return (f"np.{func.attr}() copies a tensor to the host "
                        "(a sync a call)")
            return None
        if func.attr in _HOST_ATTRS:
            if func.attr == "nonzero":
                return (".nonzero() has a data-dependent size: the host "
                        "waits for it")
            return f".{func.attr}() copies to the host and waits"
        return None

    def _rule_host_sync(self, scan: ModuleScan, info: FunctionInfo
                        ) -> List[Finding]:
        out: List[Finding] = []
        for node in _own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            msg = self._host_sync_msg(scan, node)
            if msg:
                out.append(self._mk(
                    scan, info, node, "HOST-SYNC",
                    f"{msg}; the function is capture-reachable "
                    f"({info.seed_why})"))
        return sorted(out, key=lambda f: f.line)

    # SILENT-DEGRADE -------------------------------------------------------
    def _touches_device(self, scan: ModuleScan, nodes) -> bool:
        for top in nodes:
            if top is None:
                continue
            for node in ast.walk(top):
                if isinstance(node, ast.Name) and (
                        node.id in ("_build", "ctypes")
                        or node.id.endswith("_launch")):
                    return True
                if isinstance(node, ast.Attribute):
                    if node.attr.endswith("_launch"):
                        return True
                    dotted = scan.resolve(node) or ""
                    if dotted.startswith(("torch.cuda", "ctypes", _BUILD)):
                        return True
        return False

    def _is_loud(self, scan: ModuleScan, handler: ast.ExceptHandler
                 ) -> bool:
        for stmt in ast.walk(ast.Module(body=handler.body,
                                        type_ignores=[])):
            if isinstance(stmt, ast.Raise):
                return True
            if isinstance(stmt, ast.Call):
                dotted = scan.resolve(stmt.func) or ""
                if dotted in ("warnings.warn", "sys.exit") or \
                        dotted.endswith((".warn", ".warning", ".error",
                                         ".exception")):
                    return True
        return False

    def _rule_silent_degrade(self, scan: ModuleScan) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(scan.tree):
            if not isinstance(node, ast.Try):
                continue
            device_try = self._touches_device(scan, node.body)
            for handler in node.handlers:
                if not (device_try or self._touches_device(
                        scan, [handler.type, *handler.body])):
                    continue
                if self._is_loud(scan, handler):
                    continue
                out.append(self._mk(
                    scan, scan.enclosing(handler), handler, "SILENT-DEGRADE",
                    "except block around device code neither raises nor "
                    "warns: a failure of the card's path passes unseen"))
        return out

    # KERNEL-ROUTE ---------------------------------------------------------
    @staticmethod
    def _launches(qual: str) -> bool:
        return qual in (f"{_BUILD}:launch", f"{_BUILD}:library")

    def _device_test(self, scan: ModuleScan, test: ast.AST) -> bool:
        """Whether ``test`` reads nothing but tensors' devices (and
        constants)."""
        if isinstance(test, ast.BoolOp):
            return all(self._device_test(scan, v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._device_test(scan, test.operand)
        if isinstance(test, ast.Attribute):
            return test.attr in ("is_cuda", "is_cpu")
        if not isinstance(test, ast.Compare):
            return False
        saw_device = False
        for side in (test.left, *test.comparators):
            if isinstance(side, ast.Constant):
                continue
            parts = _dotted(side)
            if parts and "device" in parts[1:]:
                saw_device = True
                continue
            return False
        return saw_device

    def _route_of(self, scan: ModuleScan, fn: ast.AST, call: ast.Call
                  ) -> Optional[str]:
        """Why the plain call is routed other than by device, or None."""
        parents: Dict[ast.AST, ast.AST] = {}
        for node in _own_nodes(fn):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for child in ast.iter_child_nodes(fn):
            parents.setdefault(child, fn)
        guarded = False
        node = call
        while node in parents and node is not fn:
            parent = parents[node]
            if isinstance(parent, ast.ExceptHandler):
                return "it runs in an except handler (a caught error)"
            if isinstance(parent, (ast.If, ast.IfExp)) and \
                    node is not parent.test:
                text = ast.unparse(parent.test)
                if "environ" in text or "getenv" in text:
                    return f"the test `{text}` reads an environment variable"
                if not self._device_test(scan, parent.test):
                    return f"the test `{text}` is not the tensors' device"
                guarded = True
            node = parent
        if not guarded:
            # an early return on a device test earlier in the body
            body = getattr(fn, "body", [])
            for stmt in body:
                if stmt.lineno >= call.lineno:
                    break
                if isinstance(stmt, ast.If) and \
                        self._device_test(scan, stmt.test) and any(
                            isinstance(s, (ast.Return, ast.Raise))
                            for s in stmt.body):
                    guarded = True
            if not guarded:
                return "no test of the tensors' device guards it"
        return None

    def _rule_kernel_route(self, scan: ModuleScan) -> List[Finding]:
        out: List[Finding] = []
        for info in scan.functions.values():
            if info.name.startswith("_") or "." in \
                    info.qualname.split(":", 1)[1]:
                continue
            if info.name.endswith("_plain") or \
                    not self.reaches(info.qualname, self._launches):
                continue
            for node in _own_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                dotted = scan.resolve(node.func) or ""
                if not dotted.split(".")[-1].endswith("_plain"):
                    continue
                why = self._route_of(scan, info.node, node)
                if why:
                    out.append(self._mk(
                        scan, info, node, "KERNEL-ROUTE",
                        f"`{ast.unparse(node.func)}` is chosen where the "
                        f"kernel could launch: {why}; choose the plain "
                        "version by the tensors' device only"))
        return out


def run_lint(root: Path, src_dirs: Tuple[str, ...] = ("src/repro_torch",),
             seeds: Tuple[str, ...] = CAPTURE_SEEDS,
             extra_files: Tuple[str, ...] = EXTRA_FILES) -> List[Finding]:
    return RepoLint(root, src_dirs, seeds, extra_files).run()
