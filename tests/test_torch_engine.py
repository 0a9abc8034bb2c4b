"""The port's serving engine (``repro_torch.serving.engine``) against
repro's, on the CPU.

Each case is one scenario function run through either package (``_Pkg``):
the twin of one engine case of ``tests/test_serving.py`` (:118-198) or
``tests/test_chaos.py`` (:191-441), with that case's own assertions on
both engines.  It returns a record of every engine it ran: each request's
rid, status, shed reason, tokens, preemptions and admit retries, the
recovery log's events (step, kind, detail), the step count, the watchdog's
counts and the page table's and session table's arrays.  The port's
record must equal the reference's, with one allowance for the tokens:

**Near-tie flips.**  The smoke model runs in bf16, and the port's logits
differ from the reference's by up to 1.4% of their max abs
(``tests/test_torch_models.py``).  A greedy token may then differ where
the reference's top two logits nearly tie.  ``_same_tokens`` accepts a
differing token only if the reference's top-two gap at that step is at
most ``FLIP_TOL`` (5%, the bf16 tolerance of ``test_torch_models.py``)
of its logits' max abs and the port chose the reference's second; the
rest of that request's tokens then differ by construction and are not
compared.  Every other field stays exact.  The flips seen are listed in
ROADMAP.md (Queue 3).

The reference runs each scenario once per module (``ref_records``), with
its model plane jitted (``jax.jit`` of ``prefill`` / ``decode_step``: the
eager calls compile each ``lax.scan`` anew, the jitted ones once a shape;
the same numbers) and its page tables sharing one jitted apply a
configuration (``test_torch_kvcache._Ref``).
"""
import contextlib
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.convert import page_table_to_numpy, state_to_numpy
from repro_torch.core import skiplist as tsl
from repro_torch.runtime import chaos as trc
from repro_torch.serving import engine as TE
from repro_torch.serving import watchdog as twd
from test_torch_kvcache import _Ref
from test_torch_layers import carry

FLIP_TOL = 0.05
ARCH = "llama3_8b"


# ---------------------------------------------------------------------------
# The two packages behind one surface
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params():
    import jax

    from repro.configs import get_smoke as rget
    from repro.models import transformer as T
    return T.init_params(rget(ARCH), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_model():
    """The reference's ``prefill`` / ``decode_step``, jitted."""
    import jax

    from repro.models import transformer as T
    pre = jax.jit(T.prefill, static_argnums=(0, 3))
    dec = jax.jit(T.decode_step, static_argnums=(0,))
    return types.SimpleNamespace(
        prefill=lambda cfg, p, toks, max_len: pre(cfg, p, toks, max_len),
        decode_step=lambda cfg, p, cache, toks: dec(cfg, p, cache, toks),
        init_cache=T.init_cache, ModelConfig=T.ModelConfig)


@contextlib.contextmanager
def reference_engine():
    """``repro.serving.engine`` with the jitted model plane and page tables
    that share their jitted apply, for the duration of the block."""
    import repro.serving.engine as RE
    ref = _Ref()

    def page_table(cfg, chaos=None):
        pt = ref.kv.PageTable(cfg, chaos=chaos)
        pt._jit_apply = ref._apply(cfg.rebalance, cfg.seed)
        return pt

    saved = RE.T, RE.PageTable
    RE.T, RE.PageTable = _ref_model(), page_table
    try:
        yield RE
    finally:
        RE.T, RE.PageTable = saved


class _Pkg:
    """One package's engine, chaos, watchdog and skiplist modules, and the
    smoke model's params (the reference's, carried across for the port)."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.E, self.rc, self.wd, self.sl = TE, trc, twd, tsl
            self.cfg, self.params = get_smoke(ARCH), carry(_ref_params())
        else:
            import repro.serving.engine as RE
            from repro.configs import get_smoke as rget
            from repro.core import skiplist as sl
            from repro.runtime import chaos as rc
            from repro.serving import watchdog as wd
            self.E, self.rc, self.wd, self.sl = RE, rc, wd, sl
            self.cfg, self.params = rget(ARCH), _ref_params()

    def engine(self, chaos=None, **ecfg):
        kw = {"device": "cpu"} if self.port else {}
        return self.E.ServeEngine(self.cfg, self.params,
                                  self.E.EngineConfig(**ecfg), chaos=chaos,
                                  **kw)

    def req(self, rid, rng, n=8, **kw):
        return self.E.Request(rid=rid, prompt=rng.integers(
            0, self.cfg.vocab, n, dtype=np.int32), **kw)

    def manual(self, prompt, n, max_len=64):
        """Greedy prefill + decode by hand: ``n`` tokens."""
        if self.port:
            from repro_torch.models import transformer as T
            asarray = torch.as_tensor
        else:
            import jax.numpy as jnp
            T, asarray = _ref_model(), jnp.asarray
        logits, cache = T.prefill(self.cfg, self.params,
                                  asarray(prompt)[None], max_len)
        out = [int(np.argmax(np.asarray(logits[0])))]
        for _ in range(n - 1):
            nxt = asarray(np.array([[out[-1]]], np.int32))
            logits, cache = T.decode_step(self.cfg, self.params, cache, nxt)
            out.append(int(np.argmax(np.asarray(logits[0]))))
        return out

    def delete_session(self, eng, rid):
        if self.port:
            eng.sessions, _ = tsl.delete(eng.sessions, rid)
        else:
            import jax.numpy as jnp
            eng.sessions, _ = self.sl.delete(eng.sessions, jnp.int32(rid))

    def tables(self, eng) -> dict:
        """The page table's and session table's arrays."""
        if self.port:
            pages = page_table_to_numpy(eng.pages)
            sess = state_to_numpy(eng.sessions)
        else:
            pages = _Ref.state(eng.pages)
            sess = {k: np.asarray(v) for k, v in
                    eng.sessions._asdict().items() if v is not None}
        out = {f"pages.{k}": v for k, v in pages.items()}
        out.update({f"sessions.{k}": v for k, v in sess.items()})
        return out


def _ref_logits(prompt, prefix, max_len=64):
    """The reference's logits before each token of ``prefix`` and after
    it (prefill, then one decode a token), as numpy."""
    import jax.numpy as jnp

    from repro.configs import get_smoke as rget
    m, cfg, params = _ref_model(), rget(ARCH), _ref_params()
    logits, cache = m.prefill(cfg, params, jnp.asarray(prompt)[None],
                              max_len)
    out = [np.asarray(logits[0])]
    for t in prefix:
        logits, cache = m.decode_step(cfg, params, cache,
                                      jnp.asarray([[t]], jnp.int32))
        out.append(np.asarray(logits[0]))
    return out


def record(P: _Pkg, eng, reqs) -> dict:
    return {
        "reqs": [(r.rid, r.status, r.shed_reason, list(r.out or []),
                  r.n_preempted, r.n_admit_retries, r.prompt.tolist(),
                  r.done) for r in reqs],
        "log": [(e.step, e.kind, sorted(e.detail.items()))
                for e in eng.log.events],
        "steps": eng.steps,
        "watchdog": (None if eng.watchdog is None else
                     (eng.watchdog.checks, eng.watchdog.violations)),
        "tables": P.tables(eng),
    }


# ---------------------------------------------------------------------------
# Scenarios: tests/test_serving.py:118-198
# ---------------------------------------------------------------------------

def engine_end_to_end_generates(P):
    eng = P.engine(batch_slots=2, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [P.req(rid + 1, rng, max_new=6) for rid in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=100)
    assert all(s is None for s in eng.slots)
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
    return [record(P, eng, reqs)]


def engine_continuous_batching_admits_from_queue(P):
    eng = P.engine(batch_slots=1, max_len=64)
    rng = np.random.default_rng(1)
    reqs = [P.req(1, rng, n=4, max_new=3), P.req(2, rng, n=4, max_new=3)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=50)
    assert eng.pages.n_live == 0
    return [record(P, eng, reqs)]


def engine_max_new_counts_prefill_token(P):
    rng = np.random.default_rng(7)
    out = []
    for max_new in (1, 5):
        eng = P.engine(batch_slots=1, max_len=64)
        req = P.req(1, rng, max_new=max_new)
        eng.submit(req)
        eng.run(max_steps=50)
        assert req.status == "done" and len(req.out) == max_new
        assert eng.steps == max(1, max_new - 1)
        out.append(record(P, eng, [req]))
    return out


def engine_decode_matches_manual_decode(P):
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, P.cfg.vocab, 8, dtype=np.int32)
    eng = P.engine(batch_slots=1, max_len=64)
    req = P.E.Request(rid=9, prompt=prompt, max_new=4)
    eng.submit(req)
    eng.run(max_steps=20)
    assert req.out == P.manual(prompt, 4)
    return [record(P, eng, [req])]


# ---------------------------------------------------------------------------
# Scenarios: tests/test_chaos.py:191-441 (engine cases)
# ---------------------------------------------------------------------------

def submit_rejects_duplicate_rid(P):
    eng = P.engine(batch_slots=1, max_len=64)
    rng = np.random.default_rng(0)
    first, dup = P.req(5, rng, max_new=3), P.req(5, rng, max_new=3)
    assert eng.submit(first)
    assert not eng.submit(dup)
    assert dup.status == "shed" and dup.shed_reason == P.E.SHED_DUPLICATE
    eng.run(max_steps=30)
    assert first.status == "done" and len(first.out) == 3
    assert int(eng.sessions.n) == 0 and eng.pages.n_live == 0
    again = P.req(5, rng, max_new=2)
    assert eng.submit(again)
    return [record(P, eng, [first, dup, again])]


def submit_sheds_on_queue_full_and_bad_requests(P):
    eng = P.engine(batch_slots=1, max_len=64, max_queue=2)
    rng = np.random.default_rng(1)
    reqs = [P.req(1, rng), P.req(2, rng)]
    assert all(eng.submit(r) for r in reqs)
    over, bad, too_long = (P.req(3, rng), P.req(-1, rng),
                           P.req(4, rng, n=60, max_new=16))
    assert not eng.submit(over) and over.shed_reason == P.E.SHED_QUEUE_FULL
    assert not eng.submit(bad) and bad.shed_reason == "invalid-rid"
    assert not eng.submit(too_long)
    assert too_long.shed_reason == "prompt-too-long"
    assert eng.log.counts()["shed"] == 3
    return [record(P, eng, reqs + [over, bad, too_long])]


def admission_reserves_pages_before_prefill(P):
    inj = P.rc.FaultInjector([P.rc.Fault(step=0, site="kvcache.alloc",
                                         kind=P.rc.POOL_EXHAUSTED)])
    eng = P.engine(chaos=inj, batch_slots=1, max_len=64)
    req = P.req(1, np.random.default_rng(2), max_new=3)
    eng.submit(req)
    eng.step()
    assert req.status == "queued" and eng.slots[0] is None
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 1
    assert eng.log.counts()["admit-retry"] == 1
    mid = record(P, eng, [req])
    eng.run(max_steps=30)
    assert req.status == "done" and len(req.out) == 3
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
    return [mid, record(P, eng, [req])]


def transient_faults_retry_and_output_is_unchanged(P):
    prompt = np.random.default_rng(3).integers(0, P.cfg.vocab, 8,
                                               dtype=np.int32)
    ref_eng = P.engine(batch_slots=1, max_len=64)
    ref = P.E.Request(rid=1, prompt=prompt, max_new=5)
    ref_eng.submit(ref)
    ref_eng.run(max_steps=30)
    inj = P.rc.FaultInjector([
        P.rc.Fault(step=0, site="engine.prefill", kind=P.rc.TRANSIENT_DEVICE),
        P.rc.Fault(step=2, site="engine.decode", kind=P.rc.TRANSIENT_DEVICE),
        P.rc.Fault(step=3, site="engine.decode", kind=P.rc.SLOW_STEP)])
    eng = P.engine(chaos=inj, batch_slots=1, max_len=64)
    req = P.E.Request(rid=1, prompt=prompt, max_new=5)
    eng.submit(req)
    eng.run(max_steps=40)
    assert req.status == "done" and req.out == ref.out
    counts = eng.log.counts()
    assert counts.get("device-retry", 0) >= 2 and counts.get("stall") == 1
    assert inj.exhausted and eng.watchdog.violations == 0
    return [record(P, ref_eng, [ref]), record(P, eng, [req])]


def persistent_alloc_failure_sheds_with_retry_limit(P):
    faults = [P.rc.Fault(step=s, site="kvcache.alloc",
                         kind=P.rc.POOL_EXHAUSTED) for s in range(12)]
    eng = P.engine(chaos=P.rc.FaultInjector(faults), batch_slots=1,
                   max_len=64, max_admit_retries=2)
    req = P.req(1, np.random.default_rng(4), max_new=3)
    eng.submit(req)
    eng.run(max_steps=40)
    assert req.status == "shed" and req.shed_reason == P.E.SHED_RETRY_LIMIT
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
    assert eng.watchdog.violations == 0
    return [record(P, eng, [req])]


def deadline_sheds_running_and_queued(P):
    eng = P.engine(batch_slots=1, max_len=64)
    rng = np.random.default_rng(5)
    runner = P.req(1, rng, max_new=12, deadline_steps=4)
    queued = P.req(2, rng, max_new=3, deadline_steps=2)
    eng.submit(runner)
    eng.submit(queued)
    eng.run(max_steps=40)
    assert runner.status == "shed" and \
        runner.shed_reason == P.E.SHED_DEADLINE and len(runner.out) < 12
    assert queued.status == "shed" and queued.shed_reason == P.E.SHED_DEADLINE
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
    assert eng.watchdog.violations == 0
    return [record(P, eng, [runner, queued])]


def pressure_preemption_evicts_young_for_old(P):
    eng = P.engine(batch_slots=2, max_len=64, pool_pages=1)
    rng = np.random.default_rng(6)
    young, old = P.req(7, rng, max_new=3), P.req(3, rng, max_new=3)
    eng.submit(young)
    eng.submit(old)
    eng.run(max_steps=60)
    assert young.status == "done" and old.status == "done"
    assert young.n_preempted >= 1 and eng.log.counts().get("preempt", 0) >= 1
    assert len(young.out) == 3 and len(old.out) == 3
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
    assert eng.watchdog.violations == 0
    return [record(P, eng, [young, old])]


def preemption_limit_sheds(P):
    eng = P.engine(batch_slots=2, max_len=64, pool_pages=1,
                   max_preemptions=0)
    rng = np.random.default_rng(7)
    young, old = P.req(9, rng, max_new=3), P.req(2, rng, max_new=3)
    eng.submit(young)
    eng.submit(old)
    eng.run(max_steps=60)
    assert young.status == "shed" and \
        young.shed_reason == P.E.SHED_PREEMPT_LIMIT
    assert old.status == "done" and len(old.out) == 3
    assert eng.pages.n_live == 0 and int(eng.sessions.n) == 0
    return [record(P, eng, [young, old])]


def watchdog_green_on_healthy_engine(P):
    eng = P.engine(batch_slots=1, max_len=64)
    req = P.req(1, np.random.default_rng(8), max_new=3)
    eng.submit(req)
    eng.run(max_steps=20)
    assert eng.watchdog.checks > 0 and eng.watchdog.violations == 0
    return [record(P, eng, [req])]


def watchdog_catches_page_leak(P):
    eng = P.engine(batch_slots=1, max_len=64)
    req = P.req(1, np.random.default_rng(9), max_new=6)
    eng.submit(req)
    eng.step()
    eng.pages.free.pop()                          # simulate a leaked page
    with pytest.raises(P.wd.WatchdogViolation, match="page conservation"):
        eng.step()
    soft = P.wd.InvariantWatchdog(strict=False)
    report = soft.check(eng)
    assert not report.ok and soft.violations == 1
    assert any("page conservation" in f for f in report.failures)
    rec = record(P, eng, [req])
    rec["report"] = (report.step, report.ok, report.failures)
    return [rec]


def watchdog_catches_session_disagreement(P):
    eng = P.engine(batch_slots=1, max_len=64)
    req = P.req(1, np.random.default_rng(10), max_new=6)
    eng.submit(req)
    eng.step()
    P.delete_session(eng, 1)                      # corrupt
    with pytest.raises(P.wd.WatchdogViolation, match="session agreement"):
        eng.step()
    return [record(P, eng, [req])]


# ---------------------------------------------------------------------------
# Seeded chaos soak (quick lane) and replay identity
# ---------------------------------------------------------------------------

def _soak_one(P, seed: int):
    inj = P.rc.FaultInjector.from_seed(seed, n_steps=24, n_faults=5)
    eng = P.engine(chaos=inj, batch_slots=2, max_len=64, max_queue=8)
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(5):
        r = P.E.Request(rid=rid + 1,
                        prompt=rng.integers(0, P.cfg.vocab, 4 + int(
                            rng.integers(8)), dtype=np.int32),
                        max_new=2 + int(rng.integers(4)),
                        deadline_steps=(40 if rid % 2 else None))
        reqs.append(r)
        eng.submit(r)
    eng.run(max_steps=80)
    return eng, reqs


def _soak(seed: int):
    def chaos_soak_quick(P):
        eng, reqs = _soak_one(P, seed)
        for r in reqs:
            assert r.terminal, f"rid {r.rid} stuck in {r.status}"
            assert r.status != "shed" or r.shed_reason
        assert eng.pages.n_live == 0
        assert len(eng.pages.free) == eng.pages.cfg.n_pages
        assert int(eng.sessions.n) == 0
        assert eng.watchdog.checks >= eng.steps
        assert eng.watchdog.violations == 0
        rec = record(P, eng, reqs)
        rec["fired"] = eng.chaos.replay_key()
        return [rec]
    chaos_soak_quick.__name__ = f"chaos_soak_quick_seed{seed}"
    return chaos_soak_quick


def chaos_soak_replays_identically(P):
    (a_eng, a_reqs), (b_eng, b_reqs) = _soak_one(P, 5), _soak_one(P, 5)
    assert a_eng.chaos.replay_key() == b_eng.chaos.replay_key()
    assert a_eng.log.replay_key() == b_eng.log.replay_key()
    for ra, rb in zip(a_reqs, b_reqs):
        assert (ra.status, ra.shed_reason, ra.out) == \
            (rb.status, rb.shed_reason, rb.out)
    return [record(P, a_eng, a_reqs), record(P, b_eng, b_reqs)]


SCENARIOS = [
    engine_end_to_end_generates, engine_continuous_batching_admits_from_queue,
    engine_max_new_counts_prefill_token, engine_decode_matches_manual_decode,
    submit_rejects_duplicate_rid, submit_sheds_on_queue_full_and_bad_requests,
    admission_reserves_pages_before_prefill,
    transient_faults_retry_and_output_is_unchanged,
    persistent_alloc_failure_sheds_with_retry_limit,
    deadline_sheds_running_and_queued,
    pressure_preemption_evicts_young_for_old, preemption_limit_sheds,
    watchdog_green_on_healthy_engine, watchdog_catches_page_leak,
    watchdog_catches_session_disagreement,
    _soak(0), _soak(1), _soak(2), chaos_soak_replays_identically,
]


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------

def _same_tokens(rid, prompt, got, want) -> None:
    """``got == want`` but for a near-tie flip (module docstring)."""
    assert len(got) == len(want), rid
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff:
        return
    i = diff[0]
    logits = _ref_logits(tuple(prompt), tuple(want[:i]))[i]
    top = np.argsort(-logits, kind="stable")[:2]
    gap = float(logits[top[0]] - logits[top[1]])
    assert top[0] == want[i] and got[i] == top[1], (rid, i, got, want)
    assert gap <= FLIP_TOL * float(np.abs(logits).max()), \
        f"rid {rid} token {i}: flip at a top-two gap of {gap}"


def assert_same_records(got_all, want_all) -> None:
    assert len(got_all) == len(want_all)
    for got, want in zip(got_all, want_all):
        assert got.keys() == want.keys()
        for g, w in zip(got["reqs"], want["reqs"]):
            assert g[:3] == w[:3] and g[4:] == w[4:], (g, w)
            _same_tokens(w[0], w[6], g[3], w[3])
        assert got["log"] == want["log"]
        assert got["steps"] == want["steps"]
        assert got["watchdog"] == want["watchdog"]
        assert got.get("report") == want.get("report")
        assert got.get("fired") == want.get("fired")
        assert got["tables"].keys() == want["tables"].keys()
        for k, v in want["tables"].items():
            assert got["tables"][k].dtype == v.dtype, k
            assert np.array_equal(got["tables"][k], v), k


def run_reference(scenarios) -> dict:
    with reference_engine():
        P = _Pkg(port=False)
        return {fn.__name__: fn(P) for fn in scenarios}


@pytest.fixture(scope="module")
def ref_records():
    return run_reference(SCENARIOS)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_engine_matches_reference(scenario, ref_records):
    got = scenario(_Pkg(port=True))
    assert_same_records(got, ref_records[scenario.__name__])


def test_engine_takes_the_device_and_raises_without_one():
    """``device=None`` is the card: without one the engine raises, and on
    the CPU its tables and cache live there."""
    P = _Pkg(port=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TE.ServeEngine(P.cfg, P.params, TE.EngineConfig())
    eng = P.engine(batch_slots=2, max_len=32)
    assert eng.sessions.keys.device.type == "cpu"
    assert eng.pages.device.type == "cpu"
    assert eng.cache["pos"].device.type == "cpu"
    assert eng.cache["blocks"][0]["k"].shape == (2, 2, 32, 2, 16)


ENTRY_POINTS = {
    "repro_torch.launch.serve": ["--arch", "llama3_8b", "--smoke",
                                 "--requests", "4", "--max-new", "4"],
    "repro_torch.launch.serve_lm": [],
    "repro_torch.launch.quickstart": [],
}


def _run_entry(module, args):
    src = Path(__file__).resolve().parent.parent / "src"
    env = {**os.environ, "PYTHONPATH": str(src), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_and_raises_without_a_card(module):
    got = _run_entry(module, ENTRY_POINTS[module] + ["--device", "cpu"])
    assert got.returncode == 0, got.stderr
    assert "served" in got.stdout or "validated search" in got.stdout
    if "serve" in module:
        assert "pages live 0" in got.stdout or \
            "pages live at end: 0" in got.stdout
    got = _run_entry(module, ENTRY_POINTS[module])
    assert got.returncode != 0 and "no CUDA device" in got.stderr
