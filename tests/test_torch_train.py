"""The port's training path (``repro_torch.train.step``, ``launch.train``,
``parallel.decode_attn``, the model plane's ``remat``) against repro's,
on the CPU.

* ``remat`` ``"none"`` / ``"dots"`` / ``"full"`` give bit-identical
  losses and gradients for every smoke config; ``"dots"`` saves the 2-D
  products and recomputes the batched ones (``bmm``), ``"full"``
  recomputes both; the autograd product of ``layers`` has a gradient on
  ``meta`` tensors (``aten::mm.dtype`` has none).
* Three ``make_train_step`` steps against the reference's
  ``make_train_step`` on an Auto-axis ``jax.sharding.Mesh`` of one device
  (its factories fail on ``jax.make_mesh``'s Explicit axes; ROADMAP
  Queue 3), fp32 params carried across: loss, parts, ``grad_norm`` and
  ``lr`` within ``FP32_TOL = 1e-3`` (fraction of the value) and the new
  params within ``FP32_TOL`` of each leaf's max abs.
* ``make_prefill_step`` / ``make_decode_step`` against the reference's
  there: logits within ``FP32_TOL`` of their max abs, the integer cache
  leaves exact.
* ``make_distributed_decode_attn`` at one shard against the reference's
  (fp32 within 1e-5 of max abs; bf16 within one bf16 step); at D = 2 over
  gloo (two spawned ranks, each half the cache) equal to the one-shard
  result within 1e-6 of max abs (the shards' sums add in another order).
* Twins of ``tests/test_system.py``'s four cases on the port: loss descent
  over 60 steps, restart bit-exact from a step-5 checkpoint, the training
  driver under an injected failure, the decode-step factory on the host
  mesh.
"""
import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as tcf
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import flat_items
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.data.store import IndexedSampleStore, StoreConfig
from repro_torch.launch.mesh import ModelMesh, make_host_mesh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.parallel.decode_attn import make_distributed_decode_attn
from repro_torch.parallel.sharding import Policy
from repro_torch.train import step as STEP
from test_torch_layers import carry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = 1e-3
ATTN_TOL = 1e-5
GLOO_TOL = 1e-6
CPU = make_host_mesh("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: its tensors are small, and
    beside the suite's other workers torch's threads would contend for
    the cores (a 60-step test took 83 s instead of 4 under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


def _leaves_with_grad(params):
    return [t.requires_grad_(True) for t in TT.leaves(params)]


# ---- remat -------------------------------------------------------------------

def _loss_and_grads(cfg, params, toks, extra):
    leaves = _leaves_with_grad(params)
    loss, _ = TT.loss_fn(cfg, params, toks, torch.roll(toks, -1, 1), extra)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_remat_settings_give_identical_gradients(arch, dtype):
    cfg = tcf.get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    params = TT._build_params(cfg, TL.ParamBuilder(
        "init", gen, dtype=getattr(torch, dtype)))
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                         dtype=torch.int32)
    extra = None
    if cfg.family in ("vlm", "audio"):
        extra = torch.randn((2, cfg.n_extra_embeds, cfg.d_model),
                            generator=gen).to(getattr(torch, dtype))
    runs = {r: _loss_and_grads(dataclasses.replace(cfg, remat=r), params,
                               toks, extra) for r in ("none", "dots", "full")}
    loss, grads = runs["none"]
    for r in ("dots", "full"):
        assert torch.equal(runs[r][0], loss), r
        assert all(torch.equal(a, b) for a, b in zip(runs[r][1], grads)), r


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_2d_products_and_recomputes_the_batched_ones():
    """In the backward pass, "none" runs each product's two transposes;
    "dots" adds the batched products' recompute only; "full" recomputes
    every forward product (the MoE's experts are ``bmm``s)."""
    counts = {}
    for arch in ("llama3_8b", "granite_moe_1b"):
        cfg = tcf.get_smoke(arch)
        params = TT._build_params(cfg, TL.ParamBuilder(
            "init", torch.Generator().manual_seed(0), dtype=torch.float32))
        toks = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        for r in ("none", "dots", "full"):
            leaves = _leaves_with_grad(params)
            loss, _ = TT.loss_fn(dataclasses.replace(cfg, remat=r), params,
                                 toks, toks)
            with _Count() as c:
                torch.autograd.grad(loss, leaves)
            counts[(arch, r)] = (c.ops.get("aten.mm", 0),
                                 c.ops.get("aten.bmm", 0))
            for t in leaves:
                t.requires_grad_(False)
        (mm0, bmm0), (mm1, bmm1), (mm2, bmm2) = (
            counts[(arch, r)] for r in ("none", "dots", "full"))
        assert mm1 == mm0 and bmm1 > bmm0, counts
        assert mm2 > mm0 and bmm2 == bmm1, counts


def test_remat_is_off_without_grad():
    cfg = tcf.get_smoke("llama3_8b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        want, _ = TT.forward(dataclasses.replace(cfg, remat="none"), params,
                             toks)
        got, _ = TT.forward(dataclasses.replace(cfg, remat="full"), params,
                            toks)
    assert torch.equal(got, want)


def test_the_bf16_product_with_an_fp32_output_has_a_gradient():
    """``torch.mm(..., out_dtype=float32)`` has no derivative; the product
    the card runs (``layers._F32Product``) does, with each operand's
    gradient in the operand's dtype (``meta`` tensors: shapes only)."""
    for sa, sb in (((6, 8), (8, 3)), ((2, 6, 8), (2, 8, 3))):
        a = torch.empty(sa, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        b = torch.empty(sb, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        raw = (torch.mm if len(sa) == 2 else torch.bmm)(
            a, b, out_dtype=torch.float32)
        with pytest.raises(RuntimeError, match="not implemented"):
            torch.autograd.grad(raw.sum(), (a, b))
        out = (TL.matmul(a, b, torch.float32) if len(sa) == 2
               else TL.bmatmul(a, b, torch.float32))
        assert out.dtype == torch.float32 and out.shape == raw.shape
        ga, gb = torch.autograd.grad(out.sum(), (a, b))
        assert (ga.shape, ga.dtype, gb.shape, gb.dtype) == (
            a.shape, torch.bfloat16, b.shape, torch.bfloat16)


# ---- the step factories against the reference's ------------------------------

def _close(got, want, tol, what):
    g = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                   else got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all(), what
    assert float(np.abs(g - w).max()) <= tol * max(float(np.abs(w).max()),
                                                   1e-12), what


@pytest.mark.parametrize("arch", ["llama3_8b", "granite_moe_1b"])
def test_train_steps_match_the_reference(arch):
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.optim import adamw as RA
    from repro.parallel.sharding import Policy as RPolicy
    from repro.train import step as RSTEP
    from test_torch_models import _ref_params
    gb, seq = 4, 16
    kw = dict(lr_peak=3e-3, warmup_steps=2, total_steps=20)
    rcfg, cfg = get_smoke(arch), tcf.get_smoke(arch)
    mesh = _ref_mesh()
    rfn, _, _ = RSTEP.make_train_step(rcfg, RPolicy(), mesh, gb,
                                      RA.AdamWConfig(**kw))
    fn, (p_shd, o_shd, b_shd), (p_abs, o_abs) = STEP.make_train_step(
        cfg, Policy(), CPU, gb, adamw.AdamWConfig(**kw))
    assert b_shd == {"tokens": ("data", None), "labels": ("data", None)}
    rparams = _ref_params(rcfg, "float32")
    params = carry(rparams)
    ropt, opt = RA.init(RA.AdamWConfig(**kw), rparams), adamw.init(
        adamw.AdamWConfig(**kw), params)
    for ab, t in zip(TT.leaves(p_abs), TT.leaves(params)):
        assert ab.shape == t.shape
    rng = np.random.default_rng(3)
    with mesh:
        for step in range(3):
            toks = rng.integers(0, cfg.vocab, (gb, seq + 1)).astype(np.int32)
            rparams, ropt, rm = rfn(rparams, ropt, {
                "tokens": jnp.asarray(toks[:, :-1]),
                "labels": jnp.asarray(toks[:, 1:])})
            params, opt, m = fn(params, opt, {
                "tokens": torch.from_numpy(toks[:, :-1]),
                "labels": torch.from_numpy(toks[:, 1:])})
            assert set(m) == set(rm) == {"loss", "ce", "z", "moe",
                                         "grad_norm", "lr"}
            for k in m:
                _close(m[k], rm[k], FP32_TOL, f"step {step} {k}")
            assert int(opt.count) == int(ropt.count) == step + 1
            want = dict(flat_items(rparams))
            for k, t in flat_items(params):
                _close(t, want[k], FP32_TOL, f"step {step} {k}")


def test_serve_step_factories_match_the_reference():
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.models import transformer as T
    from repro.parallel.sharding import Policy as RPolicy
    from repro.train import step as RSTEP
    from test_torch_models import _ref_params
    rcfg, cfg = get_smoke("llama3_8b"), tcf.get_smoke("llama3_8b")
    mesh = _ref_mesh()
    gb, seq, max_len = 2, 12, 32
    rparams = _ref_params(rcfg, "float32")
    params = carry(rparams)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (gb, seq)).astype(
        np.int32)
    rpre, _, _ = RSTEP.make_prefill_step(rcfg, RPolicy(), mesh, gb, seq,
                                         max_len)
    pre, _, (_, cache_abs) = STEP.make_prefill_step(cfg, Policy(), CPU, gb,
                                                    seq, max_len)
    rdec, _, _ = RSTEP.make_decode_step(rcfg, RPolicy(), mesh, gb, max_len)
    dec, _, _ = STEP.make_decode_step(cfg, Policy(), CPU, gb, max_len)
    with mesh:
        rlg, rcache = rpre(rparams, {"tokens": jnp.asarray(toks)})
        lg, cache = pre(params, {"tokens": torch.from_numpy(toks)})
        _close(lg, rlg, FP32_TOL, "prefill logits")
        for (k, a), (_, b) in zip(flat_items(cache), flat_items(cache_abs)):
            assert a.shape == b.shape, k          # dtype: the params'

        nxt = np.asarray(jnp.argmax(rlg, -1))[:, None].astype(np.int32)
        for _ in range(3):
            rlg, rcache = rdec(rparams, rcache, {"tokens": jnp.asarray(nxt)})
            lg, cache = dec(params, cache, {"tokens": torch.from_numpy(nxt)})
            _close(lg, rlg, FP32_TOL, "decode logits")
            nxt = np.asarray(jnp.argmax(rlg, -1))[:, None].astype(np.int32)
        want = {k: np.asarray(v) for k, v in flat_items(rcache)}
        for k, v in flat_items(cache):
            if not v.is_floating_point():
                assert np.array_equal(v.numpy(), want[k]), k


def test_input_specs_equal_the_reference():
    from repro.configs import get_smoke
    from repro.train import step as RSTEP
    for arch in ("llama3_8b", "llava_next_34b", "whisper_tiny"):
        rcfg, cfg = get_smoke(arch), tcf.get_smoke(arch)
        for got, want in (
                (STEP.train_input_specs(cfg, 4, 32),
                 RSTEP.train_input_specs(rcfg, 4, 32)),
                (STEP.prefill_input_specs(cfg, 4, 32),
                 RSTEP.prefill_input_specs(rcfg, 4, 32)),
                (STEP.decode_input_specs(cfg, 4),
                 RSTEP.decode_input_specs(rcfg, 4))):
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype) == "torch." + str(want[k].dtype)


def test_factories_refuse_a_mesh_of_more_than_one_device():
    """A mesh of more than one device without its ``DeviceMesh`` (no
    process group) cannot hold a step; with one it can
    (``tests/test_torch_mesh_model.py``)."""
    cfg = tcf.get_smoke("llama3_8b")
    mesh = ModelMesh(("data", "model"), (2, 4))
    for make, args in ((STEP.make_train_step, (4, adamw.AdamWConfig())),
                       (STEP.make_prefill_step, (4, 16, 32)),
                       (STEP.make_decode_step, (4, 32))):
        with pytest.raises(ValueError, match="needs its device_mesh"):
            make(cfg, Policy(), mesh, *args)


# ---- decode_attn ---------------------------------------------------------------

def _attn_inputs(dtype, S=24):
    rng = np.random.default_rng(5)
    B, H, Hkv, D = 3, 8, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    length = np.asarray([5, S, 17], np.int32)
    return q, k, v, length


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_matches_the_reference_at_one_shard(dtype):
    import jax.numpy as jnp

    from repro.parallel.decode_attn import make_distributed_decode_attn as R
    mesh = _ref_mesh()
    ins = _attn_inputs(dtype)
    ref = R(mesh, "data", ("model",))
    with mesh:
        want = ref(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                     for a in ins[:3]), jnp.asarray(ins[3]))
    got = make_distributed_decode_attn(CPU, "data", ("model",))(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in ins[:3]),
        torch.from_numpy(ins[3]))
    assert got.dtype == getattr(torch, dtype)
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    if dtype == "float32":
        assert float(np.abs(g - w).max()) <= ATTN_TOL * float(np.abs(w).max())
    else:
        assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-6)
    # the one-shard version is the model plane's decode attention
    TL_out = TL.decode_attention(*(torch.from_numpy(a) for a in ins[:3]),
                                 torch.from_numpy(ins[3]))
    if dtype == "float32":
        assert float((TL_out - got).abs().max()) <= ATTN_TOL * float(
            np.abs(w).max())


def _gloo_rank(rank, D, store, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, D),
                            rank=rank, world_size=D,
                            timeout=datetime.timedelta(seconds=120))
    try:
        q, k, v, length = (torch.from_numpy(a) for a in _attn_inputs(
            "float32"))
        S_loc = k.shape[1] // D
        sl = slice(rank * S_loc, (rank + 1) * S_loc)
        fn = make_distributed_decode_attn(CPU, "data", ("model",),
                                          group=dist.group.WORLD)
        np.save(f"{out}_r{rank}.npy", fn(q, k[:, sl], v[:, sl],
                                         length).numpy())
    finally:
        dist.destroy_process_group()


def test_decode_attn_over_two_gloo_shards_equals_one_shard(tmp_path):
    import torch.multiprocessing as mp
    D = 2
    mp.spawn(_gloo_rank, args=(D, str(tmp_path / "store"),
                               str(tmp_path / "out")), nprocs=D)
    q, k, v, length = (torch.from_numpy(a) for a in _attn_inputs("float32"))
    want = make_distributed_decode_attn(CPU, "data", ("model",))(
        q, k, v, length).numpy()
    for r in range(D):
        got = np.load(tmp_path / f"out_r{r}.npy")
        assert float(np.abs(got - want).max()) <= GLOO_TOL * float(
            np.abs(want).max())


# ---- twins of tests/test_system.py -----------------------------------------------

def _setup(arch="llama3_8b", gb=8, steps=200):
    cfg = tcf.get_smoke(arch)
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=10,
                                total_steps=steps)
    fn, shardings, abstracts = STEP.make_train_step(cfg, Policy(), CPU, gb,
                                                    opt_cfg)
    return cfg, opt_cfg, fn, abstracts


def _fresh(cfg, opt_cfg):
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    return params, adamw.init(opt_cfg, params)


def _batch(pipe, step):
    b = pipe.get_batch(step)
    return {"tokens": b["tokens"], "labels": b["labels"]}


def test_training_loss_decreases():
    cfg, opt_cfg, fn, _ = _setup()
    params, opt = _fresh(cfg, opt_cfg)
    store = IndexedSampleStore(StoreConfig(n_samples=256, seq_len=64,
                                           vocab=cfg.vocab), device="cpu")
    pipe = DataPipeline(store, PipelineConfig(global_batch=8))
    losses = []
    for step in range(60):
        params, opt, m = fn(params, opt, _batch(pipe, step))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.04, \
        (losses[:5], losses[-5:])
    slope = np.polyfit(np.arange(len(losses)), losses, 1)[0]
    assert slope < 0, f"loss trend not decreasing: slope={slope:.4f}"


def test_restart_resumes_bitexact(tmp_path):
    """Checkpoint at step 5, train on to step 8; a restart from step 5
    gives the same losses and params, bit for bit."""
    cfg, opt_cfg, fn, (p_abs, o_abs) = _setup()
    store = IndexedSampleStore(StoreConfig(n_samples=128, seq_len=64,
                                           vocab=cfg.vocab), device="cpu")
    pipe = DataPipeline(store, PipelineConfig(global_batch=8))
    mgr = CheckpointManager(str(tmp_path))
    params, opt = _fresh(cfg, opt_cfg)
    for step in range(5):
        params, opt, _ = fn(params, opt, _batch(pipe, step))
    mgr.save(5, {"params": params, "opt": opt})
    losses1 = []
    for step in range(5, 8):
        params, opt, m1 = fn(params, opt, _batch(pipe, step))
        losses1.append(float(m1["loss"]))
    st = mgr.restore(5, {"params": p_abs, "opt": o_abs}, device="cpu")
    p2, o2 = st["params"], st["opt"]
    losses2 = []
    for step in range(5, 8):
        p2, o2, m2 = fn(p2, o2, _batch(pipe, step))
        losses2.append(float(m2["loss"]))
    assert losses1 == losses2
    for a, b in zip(TT.leaves(params), TT.leaves(p2)):
        assert torch.equal(a, b)
    assert int(o2.count) == int(opt.count) == 8


def test_train_driver_with_failure_injection(tmp_path):
    """``launch.train`` survives an injected failure and finishes."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "llama3_8b", "--smoke", "--steps", "25",
         "--global-batch", "4", "--seq-len", "32", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "10", "--fail-at", "15",
         "--log-every", "10"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert "injected failure" in out.stdout, out.stdout + out.stderr
    assert "done: 25 steps" in out.stdout, out.stdout + out.stderr


def test_driver_replay_after_the_restore_equals_the_uninterrupted_run(
        tmp_path):
    from repro_torch.launch import train
    args = ["--device", "cpu", "--smoke", "--steps", "14", "--global-batch",
            "2", "--seq-len", "16", "--ckpt-every", "5", "--log-every", "100"]
    plain = dict(train.run(train.parse_args(
        args + ["--ckpt-dir", str(tmp_path / "a")])))
    hist = train.run(train.parse_args(
        args + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at", "12"]))
    assert [s for s, _ in hist] == list(range(13)) + list(range(10, 14))
    assert all(loss == plain[s] for s, loss in hist)


def test_driver_resumed_at_its_last_step_runs_no_step(tmp_path, capsys):
    """A second run on the first's checkpoint directory resumes from the
    final checkpoint and finishes without a step."""
    from repro_torch.launch import train
    args = train.parse_args(
        ["--device", "cpu", "--smoke", "--steps", "3", "--global-batch",
         "2", "--seq-len", "16", "--ckpt-dir", str(tmp_path),
         "--log-every", "100"])
    assert [s for s, _ in train.run(args)] == [0, 1, 2]
    capsys.readouterr()
    assert train.run(args) == []
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 3" in out
    assert "done: 3 steps, no step run" in out


def test_serve_step_factory_runs_on_host_mesh():
    cfg = tcf.get_smoke("llama3_8b")
    fn, _, (p_abs, cache_abs) = STEP.make_decode_step(cfg, Policy(), CPU, 2,
                                                      32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    cache = TT.init_cache(cfg, params, 2, 32, device="cpu")
    logits, new_cache = fn(params, cache,
                           {"tokens": torch.zeros((2, 1), dtype=torch.int32)})
    assert logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert torch.equal(new_cache["pos"], cache["pos"] + 1)
