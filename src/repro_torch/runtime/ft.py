"""Fault-tolerance runtime: straggler detection, failure handling, elasticity
(a copy of ``repro.runtime.ft``, numpy only, so the port imports nothing of
``repro``).

On a real multi-pod deployment these hooks wire into the cluster scheduler;
here every mechanism is implemented and unit-tested at the host level:

* ``StragglerMonitor`` — per-host step-time tracking with robust z-scores
  (median/MAD).  Hosts whose step time exceeds ``threshold`` MADs are
  flagged; the policy escalates observe -> warn -> evict-recommendation.
  At 1000+ nodes this feeds the scheduler's hot-swap of slow hosts.
* ``run_with_restarts`` — supervisor loop: run a training function; on
  (injected or real) failure, restore the latest checkpoint and continue.
  Used by the failure-injection integration test and ``launch/train.py``.
* ``ElasticPlan`` — given a changed device count, recompute mesh shape and
  per-host batch slices; checkpoint restore is mesh-agnostic (see
  checkpoint.manager), so rescaling = replan + restore.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    step: int
    host_times: Dict[int, float]
    flagged: List[int]
    evict: List[int]


class StragglerMonitor:
    def __init__(self, n_hosts: int, threshold_mads: float = 5.0,
                 evict_after: int = 3, window: int = 50):
        self.n_hosts = n_hosts
        self.threshold = threshold_mads
        self.evict_after = evict_after
        self.window = window
        self._hist: Dict[int, List[float]] = {h: [] for h in range(n_hosts)}
        self._strikes: Dict[int, int] = {h: 0 for h in range(n_hosts)}

    def record(self, step: int, host_times: Dict[int, float]
               ) -> StragglerReport:
        for h, t in host_times.items():
            hist = self._hist[h]
            hist.append(t)
            if len(hist) > self.window:
                hist.pop(0)
        cur = np.array([host_times[h] for h in sorted(host_times)])
        med = float(np.median(cur))
        mad = float(np.median(np.abs(cur - med))) + 1e-9
        flagged = [h for h in sorted(host_times)
                   if (host_times[h] - med) / mad > self.threshold]
        evict = []
        for h in range(self.n_hosts):
            if h in flagged:
                self._strikes[h] += 1
                if self._strikes[h] >= self.evict_after:
                    evict.append(h)
            else:
                self._strikes[h] = 0
        return StragglerReport(step, dict(host_times), flagged, evict)


class InjectedFailure(RuntimeError):
    """Raised by tests / chaos hooks to simulate a node loss."""


def run_with_restarts(train_fn: Callable[[int], int],
                      restore_fn: Callable[[], int],
                      max_restarts: int = 3, *,
                      exceptions: Tuple[type, ...] = (InjectedFailure,),
                      backoff_base: float = 0.0,
                      backoff_factor: float = 2.0,
                      backoff_cap: float = 30.0,
                      sleep_fn: Callable[[float], None] = time.sleep
                      ) -> Tuple[int, int]:
    """Supervise ``train_fn(start_step) -> final_step``.

    On a failure matching ``exceptions`` (any exception tuple — real
    device/runtime errors, not just the injected test failure), call
    ``restore_fn() -> restored_step`` and restart from there, waiting
    ``min(backoff_base * backoff_factor**(n-1), backoff_cap)`` seconds
    before restart ``n`` — the old tight immediate-restart loop hammered
    a still-unhealthy cluster.  ``backoff_base=0`` (the default) keeps
    restarts immediate for tests; ``sleep_fn`` is injectable so backoff
    is unit-testable without wall-clock sleeps.  Returns
    (final_step, n_restarts).
    """
    if backoff_base < 0 or backoff_factor < 1.0 or backoff_cap < 0:
        raise ValueError("backoff_base/cap must be >= 0 and "
                         "backoff_factor >= 1")
    restarts = 0
    step = restore_fn()
    while True:
        try:
            final = train_fn(step)
            return final, restarts
        except exceptions:
            restarts += 1
            if restarts > max_restarts:
                raise
            if backoff_base > 0:
                sleep_fn(min(backoff_base * backoff_factor ** (restarts - 1),
                             backoff_cap))
            step = restore_fn()


@dataclasses.dataclass
class ElasticPlan:
    """Mesh/batch replan after a device-count change."""
    n_devices: int
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    per_host_batch: int

    @staticmethod
    def plan(n_devices: int, global_batch: int,
             tp: int = 16) -> "ElasticPlan":
        """Keep TP fixed (model-shard layout preserved), flex DP/pod."""
        assert n_devices % tp == 0, "device count must preserve TP degree"
        dp = n_devices // tp
        if dp > 16 and dp % 16 == 0:                    # multi-pod
            shape = (dp // 16, 16, tp)
            names = ("pod", "data", "model")
        else:
            shape = (dp, tp)
            names = ("data", "model")
        per_host = max(global_batch // max(dp, 1), 1)
        return ElasticPlan(n_devices, shape, names, per_host)


class StepTimer:
    """Context-manager step timer feeding the straggler monitor."""

    def __init__(self):
        self.t = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.t = time.perf_counter() - self._t0
        return False
