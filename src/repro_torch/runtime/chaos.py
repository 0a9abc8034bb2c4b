"""Chaos runtime: seeded fault injection + structured recovery logging (a
copy of ``repro.runtime.chaos``: the same numpy draws, so the same schedule
for a seed).

The serving plane's robustness claim ("degrade, never die") is only
testable if faults are *injectable*, *scheduled*, and *replayable* — the
same batch-structured determinism that gives the Concurrent Deterministic
Skiplist its safety story (PAPERS.md) is what makes a fault schedule here
a pure function of its seed: the engine is deterministic given a schedule,
the schedule is deterministic given a seed, so `same seed => same outcome`
is an assertable property, not a hope.

Pieces:

* ``Fault`` / ``FaultSchedule`` — a fault is ``(step, site, kind)``; a
  schedule is a seeded random draw of faults over the engine-step axis,
  each kind drawn only for sites that understand it (``SITE_KINDS``).
* ``FaultInjector`` — consulted at *named injection points* ("sites") in
  ``serving/engine.py`` and ``serving/kvcache.py``.  The engine advances
  the injector's clock once per step; a site ``poll`` fires every pending
  fault whose step has arrived (latched: a fault scheduled for a step
  where its site was never polled fires at the site's next poll).  Every
  fired fault is recorded for replay comparison.
* ``RecoveryLog`` — the structured event stream every degradation path
  must write to (shed / preempt / retry / stall / fault).  ``warn`` both
  records the event and emits a ``logging`` warning, so recovery is
  never except-and-continue silent (the SILENT-DEGRADE bug class the
  static-analysis gate checks for).
* ``TransientDeviceError`` — the injected "device hiccup" exception,
  an ``InjectedFailure`` subclass so ``run_with_restarts``-style
  supervisors treat it uniformly.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.ft import InjectedFailure

_log = logging.getLogger("repro_torch.chaos")

# -- fault vocabulary ---------------------------------------------------------

#: fault kinds the injector knows how to deliver
POOL_EXHAUSTED = "pool_exhausted"      # page pool reports zero free pages
CAPACITY_FAIL = "capacity_fail"        # page-table insert fails (shard full)
SLOW_STEP = "slow_step"                # a decode step stalls (no progress)
TRANSIENT_DEVICE = "transient_device"  # device op raises, succeeds on retry

FAULT_KINDS = (POOL_EXHAUSTED, CAPACITY_FAIL, SLOW_STEP, TRANSIENT_DEVICE)

#: named injection points -> the kinds each one understands
SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "kvcache.alloc": (POOL_EXHAUSTED, CAPACITY_FAIL),
    "engine.prefill": (TRANSIENT_DEVICE,),
    "engine.decode": (TRANSIENT_DEVICE, SLOW_STEP),
}


class TransientDeviceError(InjectedFailure):
    """Injected transient device failure — retryable by contract."""


@dataclasses.dataclass(frozen=True)
class Fault:
    step: int      # engine step at (or after) which the fault fires
    site: str      # injection point name (a SITE_KINDS key)
    kind: str      # one of FAULT_KINDS, legal for the site

    def __post_init__(self):
        if self.site not in SITE_KINDS:
            raise ValueError(f"unknown injection site {self.site!r}; "
                             f"known: {sorted(SITE_KINDS)}")
        if self.kind not in SITE_KINDS[self.site]:
            raise ValueError(f"fault kind {self.kind!r} not injectable at "
                             f"{self.site!r} (legal: {SITE_KINDS[self.site]})")


class FaultSchedule:
    """Deterministic seeded draw of faults over an engine-step horizon."""

    @staticmethod
    def random(seed: int, *, n_steps: int = 48, n_faults: int = 6,
               sites: Sequence[str] = tuple(SITE_KINDS)) -> List[Fault]:
        """``seed`` fully determines the returned schedule (replayable)."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            site = sites[int(rng.integers(len(sites)))]
            kind = SITE_KINDS[site][int(rng.integers(
                len(SITE_KINDS[site])))]
            faults.append(Fault(step=int(rng.integers(n_steps)),
                                site=site, kind=kind))
        return sorted(faults, key=lambda f: (f.step, f.site, f.kind))


class FaultInjector:
    """Delivers a schedule of faults at named injection points.

    The owner (the serve engine) calls ``advance(step)`` once per step;
    instrumented sites call ``poll(site)`` / ``fire_transient(site)``.
    Faults latch: one scheduled for step ``s`` fires at the first poll of
    its site at any step ``>= s``, then is consumed.  ``fired`` is the
    replay record — two runs of the same seed must produce identical
    ``fired`` lists (asserted by the soak harness).
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self.pending: List[Fault] = sorted(
            faults, key=lambda f: (f.step, f.site, f.kind))
        self.fired: List[Fault] = []
        self.now = 0

    @classmethod
    def from_seed(cls, seed: int, **kw) -> "FaultInjector":
        return cls(FaultSchedule.random(seed, **kw))

    def advance(self, step: int) -> None:
        self.now = step

    def poll(self, site: str) -> Tuple[str, ...]:
        """Fire + consume every due fault at ``site``; returns their kinds."""
        if site not in SITE_KINDS:
            raise ValueError(f"unknown injection site {site!r}")
        due = [f for f in self.pending
               if f.site == site and f.step <= self.now]
        if due:
            self.pending = [f for f in self.pending if f not in due]
            self.fired.extend(due)
        return tuple(f.kind for f in due)

    def fire_transient(self, site: str) -> None:
        """Raise ``TransientDeviceError`` if a transient fault is due."""
        kinds = self.poll(site)
        if TRANSIENT_DEVICE in kinds:
            raise TransientDeviceError(f"injected transient fault at {site} "
                                       f"(step {self.now})")

    @property
    def exhausted(self) -> bool:
        return not self.pending

    def replay_key(self) -> Tuple[Tuple[int, str, str], ...]:
        """Canonical fired-fault signature for same-seed comparison."""
        return tuple((f.step, f.site, f.kind) for f in self.fired)


# -- recovery log -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    step: int
    kind: str                 # "shed" | "preempt" | "retry" | "stall" | ...
    detail: Dict[str, object]


class RecoveryLog:
    """Structured event stream for every degradation / recovery path.

    Degrading silently is the failure mode the analysis gate's
    SILENT-DEGRADE rule exists for; every handler in the serving plane
    records here via ``warn`` (which also emits a ``logging`` warning so
    operators see it) — recovery is observable by construction.
    """

    def __init__(self):
        self.events: List[RecoveryEvent] = []

    def warn(self, step: int, kind: str, **detail) -> RecoveryEvent:
        ev = RecoveryEvent(step=step, kind=kind, detail=dict(detail))
        self.events.append(ev)
        _log.warning("chaos[%d] %s %s", step, kind, detail)
        return ev

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def of_kind(self, kind: str) -> List[RecoveryEvent]:
        return [ev for ev in self.events if ev.kind == kind]

    def replay_key(self) -> Tuple[Tuple[int, str], ...]:
        """Order-sensitive (step, kind) signature for replay comparison."""
        return tuple((ev.step, ev.kind) for ev in self.events)


__all__ = [
    "Fault", "FaultSchedule", "FaultInjector", "RecoveryLog",
    "RecoveryEvent", "TransientDeviceError", "SITE_KINDS", "FAULT_KINDS",
    "POOL_EXHAUSTED", "CAPACITY_FAIL", "SLOW_STEP", "TRANSIENT_DEVICE",
]
