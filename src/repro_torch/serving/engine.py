"""Serving engine: continuous-batched decode with skiplist-backed tables
(port of ``repro.serving.engine``).

A deliberately complete (host-side) serving loop:
* a **session table** (Foresight skiplist: request-id -> batch slot, -1
  while queued) and a **paged KV page table** (kvcache.PageTable) form the
  data plane;
* the model plane is ``models.transformer``'s ``prefill`` /
  ``decode_step`` on the engine's device;
* requests are admitted into free batch slots (continuous batching), decode
  runs for the whole batch every step, finished sequences release pages.

Robustness: the engine *degrades instead of dying* — no exception escapes
``step()`` under load or injected faults.  Admission is bounded
(``max_queue``) with structured load-shedding (every rejected request
carries a ``shed_reason``); pages are reserved **before** prefill so an
allocation failure leaves the request cleanly queued (nothing spliced, no
stranded session entry); transient device faults retry with capped
exponential backoff; pool pressure past the high watermark preempts the
youngest running sequence in favour of older queued work (its pages
released via the ordered range-delete, the request re-queued) — an
age-priority policy, so preemption is livelock-free; per-request deadlines
shed requests that can no longer finish in time.  Every degradation path
records a structured ``RecoveryLog`` event, and an ``InvariantWatchdog``
cross-checks page conservation, session/slot agreement, and the sharded
page-index invariants after every step.  Fault injection points
(``engine.prefill``, ``engine.decode``, and ``kvcache.alloc`` inside the
page table) are driven by an optional seeded ``runtime.chaos.FaultInjector``
— same seed, same schedule, same outcome.

``ServeEngine`` takes ``device=None`` (the GPU; raises without one) and
builds its session table, page table and decode cache there.  Token ids,
shed reasons, recovery-log events and page-table arrays equal the
reference engine's on the same params and requests; the next token is
``torch.argmax``, the first maximum, as ``jnp.argmax``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import skiplist as sl
from repro_torch.models import transformer as T
from repro_torch.runtime import chaos as rchaos
from repro_torch.serving.kvcache import MAX_SEQS, PagedCacheConfig, PageTable
from repro_torch.serving.watchdog import InvariantWatchdog

# structured shed reasons — the full vocabulary of request rejection
SHED_QUEUE_FULL = "queue-full"          # admission queue at max_queue
SHED_DUPLICATE = "duplicate-rid"        # rid already active (queued/running)
SHED_INVALID_RID = "invalid-rid"        # rid outside [0, MAX_SEQS)
SHED_PROMPT_TOO_LONG = "prompt-too-long"   # can never fit max_len / pool
SHED_DEADLINE = "deadline"              # deadline_steps exceeded
SHED_PREEMPT_LIMIT = "preempt-limit"    # preempted more than max_preemptions
SHED_RETRY_LIMIT = "admit-retry-limit"  # alloc kept failing past max retries


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int = 16             # TOTAL new tokens, incl. the prefill one
    deadline_steps: Optional[int] = None   # engine-step budget from submit
    out: Optional[List[int]] = None
    done: bool = False
    status: str = "new"           # new -> queued -> running -> done | shed
    shed_reason: Optional[str] = None
    submitted_at: int = -1        # engine step at submit
    n_preempted: int = 0
    n_admit_retries: int = 0

    @property
    def terminal(self) -> bool:
        return self.status in ("done", "shed")


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4
    max_len: int = 128
    page_tokens: int = 16
    foresight: bool = True
    eos_id: int = -1              # -1: run to max_new
    # -- robustness knobs (ROBUSTNESS.md) -------------------------------------
    max_queue: int = 16           # admission bound; beyond it, shed
    pool_pages: int = 0           # page-pool override (0 = auto-size)
    max_preemptions: int = 2      # per request, then shed(preempt-limit)
    max_admit_retries: int = 4    # alloc retries, then shed(admit-retry-limit)
    retry_backoff: int = 1        # steps; doubles per consecutive failure
    retry_backoff_cap: int = 8    # ceiling on the doubled backoff
    high_water: float = 0.85      # pool fill fraction: preempt above this
    low_water: float = 0.60       # ... down to this (hysteresis band)
    watchdog: bool = True         # invariant checks after every step


class ServeEngine:
    def __init__(self, cfg: T.ModelConfig, params, ecfg: EngineConfig,
                 chaos: Optional[rchaos.FaultInjector] = None, device=None):
        self.device = sl.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.chaos = chaos
        self.log = rchaos.RecoveryLog()
        self.watchdog = InvariantWatchdog() if ecfg.watchdog else None
        self.sessions = sl.empty(1024, 12, foresight=ecfg.foresight,
                                 device=self.device)
        n_pages = ecfg.pool_pages or ecfg.batch_slots * (
            ecfg.max_len // ecfg.page_tokens + 1)
        self.pages = PageTable(PagedCacheConfig(
            n_pages=n_pages, page_tokens=ecfg.page_tokens,
            foresight=ecfg.foresight, high_water=ecfg.high_water,
            low_water=ecfg.low_water), chaos=chaos, device=self.device)
        self.slots: List[Optional[Request]] = [None] * ecfg.batch_slots
        self.cache = T.init_cache(cfg, params, ecfg.batch_slots, ecfg.max_len,
                                  device=self.device)
        self.queue: List[Request] = []
        self.shed_reqs: List[Request] = []
        self.steps = 0
        self._retry_at = 0            # admission paused until this step
        self._retry_backoff = 0       # current backoff width (0 = healthy)

    def blocks_of(self, req: Request) -> int:
        return len(req.prompt) // self.ecfg.page_tokens + 1

    # -- request plane ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit ``req`` to the queue; returns False if shed at the door.

        A rejected request is terminal immediately: ``status == "shed"``
        with a structured ``shed_reason`` — duplicates of an active rid,
        queue overflow, invalid ids, and prompts that can never fit are
        all load/caller conditions, not engine crashes.
        """
        req.out = []
        if not (0 <= req.rid < MAX_SEQS):
            self._shed(req, SHED_INVALID_RID, session=False)
            return False
        if len(req.prompt) + req.max_new > self.ecfg.max_len or \
                self.blocks_of(req) > self.pages.cfg.n_pages:
            self._shed(req, SHED_PROMPT_TOO_LONG, session=False)
            return False
        found, _ = sl.search_fast(self.sessions,
                                  torch.tensor([req.rid], dtype=torch.int32))
        if bool(found[0]):
            # the session entry belongs to the FIRST request with this rid;
            # upserting here would let its completion delete the entry out
            # from under this one — reject, don't touch the table
            self._shed(req, SHED_DUPLICATE, session=False)
            return False
        if len(self.queue) >= self.ecfg.max_queue:
            self._shed(req, SHED_QUEUE_FULL, session=False)
            return False
        req.status = "queued"
        req.submitted_at = self.steps
        self.queue.append(req)
        self.sessions, _ = sl.insert(self.sessions, req.rid, -1)
        return True

    def _shed(self, req: Request, reason: str, *, pages: bool = False,
              session: bool = True) -> None:
        """Terminal structured rejection: release held state, record why."""
        if pages:
            self.pages.release(req.rid, self.blocks_of(req))
        if session:
            self.sessions, _ = sl.delete(self.sessions, req.rid)
        req.status = "shed"
        req.shed_reason = reason
        self.shed_reqs.append(req)
        self.log.warn(self.steps, "shed", rid=req.rid, reason=reason)

    # -- admission -------------------------------------------------------------

    def _admit(self) -> None:
        if self.steps < self._retry_at:
            return                          # backing off after a failure
        for i in range(self.ecfg.batch_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            nb = self.blocks_of(req)
            blocks = np.arange(nb)
            # (1) reserve pages FIRST: if allocation fails the request is
            # still cleanly queued — nothing spliced, no session to unwind
            # (the pre-fix ordering stranded a half-admitted slot)
            ok, _ = self.pages.try_alloc(np.full(nb, req.rid), blocks)
            if not ok.all():
                self.pages.release_blocks(req.rid, blocks[ok])
                self._admit_failed(req)
                return                      # pool-wide: stop admitting now
            # (2) prefill (chaos site engine.prefill)
            try:
                if self.chaos is not None:
                    self.chaos.fire_transient("engine.prefill")
                toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                       device=self.device)[None]
                logits, cache1 = T.prefill(self.cfg, self.params, toks,
                                           self.ecfg.max_len)
            except rchaos.TransientDeviceError as e:
                self.log.warn(self.steps, "device-retry",
                              site="engine.prefill", rid=req.rid,
                              error=str(e))
                self.pages.release(req.rid, nb)
                self._admit_failed(req)
                return
            # (3) commit: the request becomes running atomically
            self.queue.pop(0)
            self.slots[i] = req
            self._splice_cache(i, cache1)
            req.out.append(int(torch.argmax(logits[0])))
            req.status = "running"
            self.sessions, _ = sl.insert(self.sessions, req.rid, i)
            self._retry_backoff = 0
            # the prefill token counts toward max_new (pinned contract):
            # a max_new=1 request completes here, with zero decode steps
            hit_eos = (self.ecfg.eos_id >= 0
                       and req.out[-1] == self.ecfg.eos_id)
            if len(req.out) >= req.max_new or hit_eos:
                self._finish(i)

    def _admit_failed(self, req: Request) -> None:
        """Alloc/prefill failure for the head request: retry with capped
        exponential backoff; shed past the retry budget; preempt if the
        pool (not a transient) is what's starving us."""
        req.n_admit_retries += 1
        self.log.warn(self.steps, "admit-retry", rid=req.rid,
                      attempt=req.n_admit_retries)
        if req.n_admit_retries > self.ecfg.max_admit_retries:
            self.queue.remove(req)
            self._shed(req, SHED_RETRY_LIMIT)
            return
        self._retry_backoff = min(
            max(self._retry_backoff * 2, self.ecfg.retry_backoff),
            self.ecfg.retry_backoff_cap)
        self._retry_at = self.steps + self._retry_backoff
        self._maybe_preempt()

    # -- preemption ------------------------------------------------------------

    def _maybe_preempt(self) -> None:
        """Pool pressure past the high watermark: evict young running
        sequences in favour of strictly older queued work, down to the low
        watermark.  Age-priority makes this livelock-free — the running
        set's oldest-first composition only ever improves, so two requests
        can never preempt each other back and forth."""
        if not (self.pages.above_high_water and self.queue):
            return
        while not self.pages.below_low_water:
            head = self.queue[0]
            cand = [i for i, r in enumerate(self.slots)
                    if r is not None and (r.submitted_at, r.rid)
                    > (head.submitted_at, head.rid)]
            if not cand:
                return
            victim = max(cand, key=lambda i: (self.slots[i].submitted_at,
                                              self.slots[i].rid))
            self._preempt_slot(victim)

    def _preempt_slot(self, i: int) -> None:
        req = self.slots[i]
        self.pages.release(req.rid, self.blocks_of(req))   # ordered range-delete
        self.slots[i] = None
        req.n_preempted += 1
        self.log.warn(self.steps, "preempt", rid=req.rid,
                      n_preempted=req.n_preempted)
        if req.n_preempted > self.ecfg.max_preemptions:
            self._shed(req, SHED_PREEMPT_LIMIT)
            return
        # deterministic greedy decode: re-running prefill+decode from the
        # prompt reproduces the same tokens, so restart from scratch
        req.out = []
        req.status = "queued"
        self.sessions, _ = sl.insert(self.sessions, req.rid, -1)
        # re-queue in age order (submitted_at, rid): older work first
        pos = len(self.queue)
        for j, q in enumerate(self.queue):
            if (q.submitted_at, q.rid) > (req.submitted_at, req.rid):
                pos = j
                break
        self.queue.insert(pos, req)

    # -- deadlines -------------------------------------------------------------

    def _expire_deadlines(self) -> None:
        for i, r in enumerate(self.slots):
            if r is not None and r.deadline_steps is not None and \
                    self.steps - r.submitted_at >= r.deadline_steps:
                self.slots[i] = None
                self._shed(r, SHED_DEADLINE, pages=True)
        for r in [q for q in self.queue
                  if q.deadline_steps is not None and
                  self.steps - q.submitted_at >= q.deadline_steps]:
            self.queue.remove(r)
            self._shed(r, SHED_DEADLINE)

    # -- decode plane ------------------------------------------------------------

    def _splice_cache(self, slot: int, cache1):
        """Write a 1-sequence prefill cache into batch slot ``slot``."""
        # the reference's rule: every leaf whose axis 1 is the batch
        for dst_c, src_c in zip(self.cache["blocks"], cache1["blocks"]):
            for k, dst in dst_c.items():
                if dst.dim() >= 2 and dst.shape[1] == self.ecfg.batch_slots:
                    dst[:, slot] = src_c[k][:, 0]
        self.cache["pos"][slot] = cache1["pos"][0]

    def step(self) -> int:
        """Admit + one decode step for all live slots. Returns #live.

        Never raises under load or injected faults: allocation failures
        back off / preempt / shed, transient device errors retry next
        step, slow steps stall (consuming deadline budget), and the
        watchdog validates state after every path.
        """
        if self.chaos is not None:
            self.chaos.advance(self.steps)
        self._expire_deadlines()
        self._maybe_preempt()
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        self.steps += 1
        if not live:
            self._run_watchdog()
            return 0
        # chaos site engine.decode: a slow/hung step is modeled as a stall
        # (no decode progress, deadlines keep ticking — deterministic, so
        # schedules stay replayable); a transient device error aborts the
        # step and retries on the next one (cache untouched on failure)
        kinds = self.chaos.poll("engine.decode") if self.chaos is not None \
            else ()
        if rchaos.SLOW_STEP in kinds:
            self.log.warn(self.steps - 1, "stall", site="engine.decode")
            self._run_watchdog()
            return len(live)
        try:
            if rchaos.TRANSIENT_DEVICE in kinds:
                raise rchaos.TransientDeviceError(
                    "injected transient fault at engine.decode")
            toks = np.zeros((self.ecfg.batch_slots, 1), np.int32)
            for i in live:
                toks[i, 0] = self.slots[i].out[-1]
            logits, self.cache = T.decode_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(toks).to(self.device))
            nxt = torch.argmax(logits, -1).cpu().numpy()
        except rchaos.TransientDeviceError as e:
            self.log.warn(self.steps - 1, "device-retry",
                          site="engine.decode", error=str(e))
            self._run_watchdog()
            return len(live)
        for i in live:
            req = self.slots[i]
            req.out.append(int(nxt[i]))
            hit_eos = (self.ecfg.eos_id >= 0
                       and int(nxt[i]) == self.ecfg.eos_id)
            if len(req.out) >= req.max_new or hit_eos:
                self._finish(i)
        self._run_watchdog()
        return len([r for r in self.slots if r is not None])

    def _finish(self, i: int) -> None:
        req = self.slots[i]
        req.done = True
        req.status = "done"
        self.pages.release(req.rid, self.blocks_of(req))
        self.sessions, _ = sl.delete(self.sessions, req.rid)
        self.slots[i] = None

    def _run_watchdog(self) -> None:
        if self.watchdog is not None:
            self.watchdog.check(self)

    def run(self, max_steps: int = 1000) -> None:
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
