"""Invariant watchdog for the serving plane (port of
``repro.serving.watchdog``).

Runs after every engine step and cross-checks the three state planes that
chaos faults could desynchronize:

* **page conservation** — ``len(free) + n_live == n_pages`` (no page is
  both free and mapped, none vanished), and the live count equals the sum
  of the running slots' block footprints;
* **session ↔ slot agreement** — the session table holds exactly one
  entry per active request (queued or in a batch slot): count equality
  plus batched membership of every active rid;
* **sharded-index invariants** — ``core.sharded.check_sharded_invariant``
  (``core.mesh_index.check_mesh_invariant`` on a mesh table) on the
  page-table index itself.

``check`` is duck-typed over an engine with ``pages`` (a ``PageTable``),
``slots``, ``queue``, ``sessions`` (a ``SkipListState`` keyed by request
id), ``steps`` and ``blocks_of``.  A violation is a bug, never load: the
watchdog raises ``WatchdogViolation`` (strict, the default).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.core import mesh_index as mshi
from repro_torch.core import sharded as shd
from repro_torch.core import skiplist as sl


class WatchdogViolation(AssertionError):
    """A serving-plane invariant broke — state corruption, not load."""


@dataclasses.dataclass
class WatchdogReport:
    step: int
    ok: bool
    failures: List[str]


class InvariantWatchdog:
    """Per-step invariant checker over a serving engine."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.checks = 0
        self.violations = 0
        self.last: WatchdogReport | None = None

    def check(self, engine) -> WatchdogReport:
        failures: List[str] = []
        pt = engine.pages
        n_pages = pt.cfg.n_pages
        n_live = pt.n_live
        n_free = len(pt.free)

        # page conservation: free + mapped == pool, mapped == engine view
        if n_free + n_live != n_pages:
            failures.append(
                f"page conservation: free({n_free}) + live({n_live}) "
                f"!= n_pages({n_pages})")
        expected = sum(engine.blocks_of(r) for r in engine.slots
                       if r is not None)
        if n_live != expected:
            failures.append(
                f"page accounting: table holds {n_live} mappings but "
                f"running slots account for {expected}")

        # session-table <-> request-plane agreement
        active = [r.rid for r in engine.slots if r is not None] \
            + [r.rid for r in engine.queue]
        n_sess = int(engine.sessions.n)
        if n_sess != len(active):
            failures.append(
                f"session agreement: table has {n_sess} entries, "
                f"{len(active)} active requests")
        if active:
            found, _ = sl.search_fast(
                engine.sessions, torch.tensor(active, dtype=torch.int32))
            found = found.cpu().tolist()
            if not all(found):
                missing = [rid for rid, f in zip(active, found) if not f]
                failures.append(f"session agreement: active rid(s) "
                                f"{missing} missing from session table")

        # the page-table index's own structural invariants (mesh tables
        # also check the device partition + key containment)
        if isinstance(pt.index, mshi.MeshShardedIndex):
            index_ok = mshi.check_mesh_invariant(pt.index, expect_n=n_live,
                                                 mesh=pt.mesh)
        else:
            index_ok = shd.check_sharded_invariant(pt.index,
                                                   expect_n=n_live)
        if not bool(index_ok):
            failures.append("sharded-index invariant violated on the "
                            "page-table index")

        self.checks += 1
        report = WatchdogReport(step=engine.steps, ok=not failures,
                                failures=failures)
        self.last = report
        if failures:
            self.violations += 1
            if self.strict:
                raise WatchdogViolation(
                    f"step {engine.steps}: " + "; ".join(failures))
        return report


__all__ = ["InvariantWatchdog", "WatchdogReport", "WatchdogViolation"]
