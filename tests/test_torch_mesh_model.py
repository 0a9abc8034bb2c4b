"""The port's model plane across a 2x4 mesh of eight gloo ranks
(``train.step`` through DTensor, the grouped MoE dispatch, checkpoints
of DTensor trees) against repro's on an Auto-axis ``Mesh`` of eight
virtual devices, on the CPU, in fp32.

Two module fixtures run everything once:

* the reference: one fresh ``python`` with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the flag must
  precede JAX's start), its mesh ``jax.sharding.Mesh`` of shape (2, 4)
  over ``("data", "model")`` (``jax.make_mesh``'s Explicit axes break
  the reference's own factories, ROADMAP Queue 3).  For each smoke
  config (llama3_8b, granite_moe_1b, phi35_moe_42b, jamba_15_large_398b)
  it draws fp32 params with its ``ParamBuilder`` (key 0) and writes them
  first, then runs one ``make_train_step`` step under ``policy_for(arch)``
  on a seeded batch, the MoE layer of rep 0 under ``make_constraint_fn``
  (its ``moe_groups`` = 2 groups) and the grouped dispatch's integers,
  and, for llama3_8b and jamba, ``make_prefill_step`` and two
  ``make_decode_step`` steps on seeded tokens;
* the port: ``torch.multiprocessing.spawn`` of eight gloo ranks (a
  ``FileStore`` under the module's directory) that wait for those params,
  build the 2x4 mesh (``launch.mesh.model_mesh``) and run the same on it.
  Each rank then saves the DTensor params after the step through
  ``CheckpointManager`` on the mesh and rank 0 the same tree, gathered,
  from one device; each restores by ``shardings=`` on 2x4 and on the 1x1
  host mesh.

Compared: loss, ce, z, moe, grad_norm and lr within ``FP32_TOL = 1e-3``
of the value and the first moment (the clipped gradient) within
``FP32_TOL`` of each leaf's max abs; the updated params within
``FP32_TOL`` of each leaf's max abs (``tests/test_torch_train.py``'s
tolerances), which is less than the reference's largest update of the
leaf, so an update left out or of the wrong sign fails.  Exempt are
the entries whose reference gradient lies within ``NEAR_ZERO = 100 eps``
of zero: AdamW's first step moves an entry by ``lr g / (|g| + eps)``,
which there turns on the gradient's last bits (jamba's zero-init
``conv_b`` has one at 1.5e-7, whose param lies 1.2e-5 from the
reference's at a leaf max abs of 1.5e-3); those are held to AdamW's
largest step, ``lr (1 + wd |p|)``.  The MoE dispatch's
``tok_s``, ``slot`` and ``keep`` exact and its output within
``FP32_TOL``; prefill and decode logits within ``FP32_TOL`` of their max
abs; the checkpoint's leaf files byte for byte, and both restores
bit-equal.  This module imports no JAX at its top level, since every
spawned rank imports it.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.optim.adamw import AdamWConfig

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("llama3_8b", "granite_moe_1b", "phi35_moe_42b",
         "jamba_15_large_398b")
SERVE = ("llama3_8b", "jamba_15_large_398b")
MOE = ("granite_moe_1b", "phi35_moe_42b", "jamba_15_large_398b")
D, SHAPE, AXES = 8, (2, 4), ("data", "model")
GB, SEQ, MAX_LEN, DECODE = 4, 16, 32, 2
KW = dict(lr_peak=3e-3, warmup_steps=2, total_steps=20)
FP32_TOL = 1e-3
ADAM = AdamWConfig(**KW)            # b1, eps, weight_decay: both sides'
NEAR_ZERO = 100 * ADAM.eps


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (GB, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _decode_tokens(cfg):
    rng = np.random.default_rng(4)
    return rng.integers(0, cfg.vocab, (DECODE, GB, 1)).astype(np.int32)


def _moe_input(cfg):
    rng = np.random.default_rng(5)
    return rng.standard_normal((GB, SEQ, cfg.d_model)).astype(np.float32)


def _moe_position(cfg):
    return next(i for i, (_, f) in enumerate(cfg.pattern()) if f == "moe")


def _capacity(T, K, E, cf):
    C = int(cf * T * K / E) + 1
    return ((C + 127) // 128) * 128


# ---------------------------------------------------------------------------
# The reference, in its own process
# ---------------------------------------------------------------------------

def _reference_main(out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_smoke
    from repro.models import layers as L
    from repro.models import moe as RM
    from repro.models import transformer as T
    from repro.optim import adamw as RA
    from repro.parallel.sharding import make_constraint_fn, policy_for
    from repro.train import step as RSTEP
    from repro_torch.convert import flat_items

    out = Path(out_dir)
    mesh = Mesh(np.asarray(jax.devices()[:D]).reshape(SHAPE), AXES)
    params = {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        params[arch] = T._build_params(cfg, L.ParamBuilder(
            "init", jax.random.PRNGKey(0), dtype=jnp.float32))
        np.savez(out / f"params_{arch}.npz", **{
            k: np.asarray(v) for k, v in flat_items(params[arch])})
    (out / "params.done").write_text("ok")
    for arch in ARCHS:
        cfg, pol = get_smoke(arch), policy_for(arch)
        res = {}
        p = params[arch]
        toks, labels = _batch(cfg)
        rfn, _, _ = RSTEP.make_train_step(cfg, pol, mesh, GB,
                                          RA.AdamWConfig(**KW))
        opt = RA.init(RA.AdamWConfig(**KW), p)
        with mesh:
            new_p, new_o, m = rfn(jax.tree.map(jnp.copy, p), opt, {
                "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        res.update({f"metric.{k}": np.asarray(v) for k, v in m.items()})
        res.update({f"param.{k}": np.asarray(v)
                    for k, v in flat_items(new_p)})
        res.update({f"mu.{k}": np.asarray(v)
                    for k, v in flat_items(new_o.mu)})
        if arch in MOE:
            pos = _moe_position(cfg)
            ffn = jax.tree.map(lambda a: a[0], p["blocks"][pos]["ffn"])
            x = jnp.asarray(_moe_input(cfg))
            cs = make_constraint_fn(pol, mesh, GB)
            G = cs.moe_groups
            Tg = GB * SEQ // G
            E = ffn["router"].shape[1]
            C = _capacity(Tg, cfg.moe_top_k, E, cfg.capacity_factor)
            _, info, _ = jax.vmap(lambda xt: RM._dispatch_group(
                xt, ffn["router"], cfg.moe_top_k, C, E))(
                    x.reshape(G, Tg, cfg.d_model))
            for name, a in zip(("tok_s", "gate_s", "slot", "keep"), info):
                res[f"moe.{name}"] = np.asarray(a)
            with mesh:
                y, aux = jax.jit(lambda f, xx: RM.moe_fwd(
                    f, xx, top_k=cfg.moe_top_k,
                    capacity_factor=cfg.capacity_factor, cs=cs))(ffn, x)
            res["moe.y"], res["moe.aux"] = np.asarray(y), np.asarray(aux)
        if arch in SERVE:
            pre, _, _ = RSTEP.make_prefill_step(cfg, pol, mesh, GB, SEQ,
                                                MAX_LEN)
            dec, _, _ = RSTEP.make_decode_step(cfg, pol, mesh, GB, MAX_LEN)
            with mesh:
                lg, cache = pre(p, {"tokens": jnp.asarray(toks)})
                res["prefill"] = np.asarray(lg)
                for i, t in enumerate(_decode_tokens(cfg)):
                    lg, cache = dec(p, cache, {"tokens": jnp.asarray(t)})
                    res[f"decode.{i}"] = np.asarray(lg)
        np.savez(out / f"ref_{arch}.npz", **res)


# ---------------------------------------------------------------------------
# The port: eight gloo ranks
# ---------------------------------------------------------------------------

# layers.reshape on DTensors of the 2x4 mesh: (global shape, placements by
# mesh dim as "R", "S<dim>" or "P" (a partial sum), the new shape, the
# result's placements)
RESHAPE_CASES = {
    "split_kept": ((8, 12), ("R", "S1"), (8, 4, 3), ("R", "S1")),
    "split_cut_gathers": ((8, 12), ("R", "S1"), (8, 3, 4), ("R", "R")),
    "flatten_kept": ((4, 6, 8), ("S0", "S2"), (24, 8), ("S0", "S1")),
    "flatten_inner_gathers": ((4, 6, 8), ("S1", "R"), (24, 8), ("R", "R")),
    "minus_one": ((4, 6, 8), ("S0", "S2"), (-1, 8), ("S0", "S1")),
    "partial_stays": ((4, 6, 8), ("R", "P"), (4, 48), ("R", "P")),
}


def _reshape_case(mesh, shape, pls, new_shape, want_pls):
    """Whether ``layers.reshape`` of a DTensor gives the plain reshape's
    values, the placements ``want_pls`` and the plain reshape's
    gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.layers import reshape
    dm = mesh.device_mesh

    def placements(names):
        return [Replicate() if p == "R" else Partial() if p == "P"
                else Shard(int(p[1:])) for p in names]

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    w = torch.randn(x.numel(), generator=gen, dtype=torch.float64)
    if "P" in pls:         # each rank's part; their sum is x
        n = dm.size(pls.index("P"))
        dx = DTensor.from_local(x / n, dm, placements(pls), run_check=False)
    else:
        dx = DTensor.from_local(x, dm, [Replicate()] * len(pls),
                                run_check=False).redistribute(
                                    dm, placements(pls))
    dx = dx.detach().requires_grad_(True)
    y = reshape(dx, *new_shape)
    want = x.reshape(*new_shape)
    ok = torch.allclose(y.full_tensor(), want, rtol=0, atol=1e-12)
    ok &= tuple(y.shape) == tuple(want.shape)
    ok &= list(y.placements) == placements(want_pls)
    dw = DTensor.from_local(w.reshape(want.shape), dm,
                            [Replicate()] * len(pls), run_check=False)
    (y * dw).sum().full_tensor().backward()
    ok &= torch.allclose(dx.grad.full_tensor(), w.reshape(shape), rtol=0,
                         atol=1e-12)
    return bool(ok)


def _port_rank(rank, store, out_dir):
    import torch.distributed as dist

    from repro_torch import configs as tcf
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.convert import flat_items, params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh, model_mesh
    from repro_torch.models import moe as MOE_
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (P, make_constraint_fn,
                                               place, policy_for)
    from repro_torch.train import step as STEP
    torch.set_num_threads(1)
    out = Path(out_dir)
    dist.init_process_group("gloo", store=dist.FileStore(store, D),
                            rank=rank, world_size=D,
                            timeout=datetime.timedelta(seconds=300))
    try:
        t0 = time.time()
        while not (out / "params.done").exists():
            assert time.time() - t0 < 300, "the reference wrote no params"
            time.sleep(0.2)
        mesh = model_mesh(SHAPE, AXES, "cpu")
        host = make_host_mesh("cpu")

        def full(t):
            return t.full_tensor() if hasattr(t, "placements") else t

        got = {name: np.array(_reshape_case(mesh, *case))
               for name, case in RESHAPE_CASES.items()}
        if rank == 0:
            np.savez(out / "port_reshape.npz", **got)

        for arch in ARCHS:
            cfg, pol = tcf.get_smoke(arch), policy_for(arch)
            res = {}
            flat = dict(np.load(out / f"params_{arch}.npz"))
            params = params_from_numpy(flat, device="cpu")
            toks, labels = _batch(cfg)
            fn, (p_shd, o_shd, _), (p_abs, o_abs) = STEP.make_train_step(
                cfg, pol, mesh, GB, adamw.AdamWConfig(**KW))
            opt = adamw.init(adamw.AdamWConfig(**KW), params)
            new_p, new_o, m = fn(params, opt, {
                "tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)})
            res.update({f"metric.{k}": v.numpy() for k, v in m.items()})
            res.update({f"param.{k}": full(v).numpy()
                        for k, v in flat_items(new_p)})
            res.update({f"mu.{k}": full(v).numpy()
                        for k, v in flat_items(new_o.mu)})
            res["placed"] = np.array(all(hasattr(v, "placements")
                                         for _, v in flat_items(new_p)))
            # checkpoints: the mesh's, one device's, both restores
            tree = {"params": new_p}
            mgr = CheckpointManager(str(out / f"ckpt_mesh_{arch}"))
            mgr.save(1, tree)
            whole = {"params": {k: full(v) for k, v in
                                flat_items(new_p)}}
            if rank == 0:
                CheckpointManager(str(out / f"ckpt_one_{arch}")).save(
                    1, {"params": params_from_numpy(
                        {k: v.numpy() for k, v in whole["params"].items()},
                        device="cpu")})
            abstract = {"params": p_abs}
            back = mgr.restore(1, abstract, shardings={"params": p_shd},
                               mesh=mesh)
            # every rank gathers every leaf (no short cut: collectives)
            same = [(tuple(b.placements) == tuple(a.placements),
                     torch.equal(full(b), full(a)))
                    for (_, a), (_, b) in zip(flat_items(new_p),
                                              flat_items(back["params"]))]
            res["restore_mesh"] = np.array(all(p and v for p, v in same))
            back1 = mgr.restore(1, abstract, shardings={"params": p_shd},
                                mesh=host)
            res["restore_1x1"] = np.array(all(
                type(b) is torch.Tensor and torch.equal(b, full(a))
                for (_, a), (_, b) in zip(flat_items(new_p),
                                          flat_items(back1["params"]))))
            if arch in MOE:
                params = params_from_numpy(flat, device="cpu")
                pos = _moe_position(cfg)
                ffn = {k: v[0] for k, v in
                       params["blocks"][pos]["ffn"].items()}
                axes = {"router": ("embed", "experts"),
                        "w_gate": ("experts", "embed", "ffn"),
                        "w_up": ("experts", "embed", "ffn"),
                        "w_down": ("experts", "ffn", "embed")}
                ffn = {k: place(v, pol.param_spec(axes[k], mesh,
                                                  tuple(v.shape)), mesh)
                       for k, v in ffn.items()}
                cs = make_constraint_fn(pol, mesh, GB)
                x = place(torch.from_numpy(_moe_input(cfg)),
                          P(pol.batch_axes(mesh, GB), None, None), mesh)
                G = cs.moe_groups
                Tg = GB * SEQ // G
                E = ffn["router"].shape[1]
                C = _capacity(Tg, cfg.moe_top_k, E, cfg.capacity_factor)
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                with torch.no_grad(), implicit_replication():
                    xg = cs(x.reshape(G, Tg, cfg.d_model), "gtd")
                    _, tok_s, gate_s, slot, keep, _ = MOE_.dispatch(
                        xg, ffn["router"], cfg.moe_top_k, C, E)
                    y, aux = MOE_.moe_fwd(ffn, x, top_k=cfg.moe_top_k,
                                          capacity_factor=cfg.capacity_factor,
                                          cs=cs)
                for name, a in (("tok_s", tok_s), ("gate_s", gate_s),
                                ("slot", slot), ("keep", keep)):
                    res[f"moe.{name}"] = full(a).numpy()
                res["moe.y"], res["moe.aux"] = (full(y).numpy(),
                                                full(aux).numpy())
            if arch in SERVE:
                params = params_from_numpy(flat, device="cpu")
                pre, _, _ = STEP.make_prefill_step(cfg, pol, mesh, GB, SEQ,
                                                   MAX_LEN)
                dec, _, _ = STEP.make_decode_step(cfg, pol, mesh, GB,
                                                  MAX_LEN)
                lg, cache = pre(params, {"tokens": torch.from_numpy(toks)})
                res["prefill"] = full(lg).numpy()
                for i, t in enumerate(_decode_tokens(cfg)):
                    lg, cache = dec(params, cache,
                                    {"tokens": torch.from_numpy(t)})
                    res[f"decode.{i}"] = full(lg).numpy()
            if rank == 0:
                np.savez(out / f"port_{arch}.npz", **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_model")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={D}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    with open(out / "reference.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", "import sys, test_torch_mesh_model as t; "
             "t._reference_main(sys.argv[1])", str(out)],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            import torch.multiprocessing as mp
            mp.spawn(_port_rank, args=(str(out / "store"), str(out)),
                     nprocs=D)
        finally:
            rc = ref.wait(timeout=600)
    assert rc == 0, (out / "reference.log").read_text()[-3000:]
    return out


@pytest.fixture(scope="module")
def results(run_dir):
    out = {arch: (dict(np.load(run_dir / f"port_{arch}.npz")),
                  dict(np.load(run_dir / f"ref_{arch}.npz")))
           for arch in ARCHS}
    out.update({f"params.{arch}": dict(np.load(
        run_dir / f"params_{arch}.npz")) for arch in ARCHS})
    return out


def _close(got, want, tol, what):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all(), what
    assert float(np.abs(g - w).max()) <= tol * max(float(np.abs(w).max()),
                                                   1e-12), what


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_mesh_matches_the_reference(results, arch):
    port, ref = results[arch]
    assert bool(port["placed"])
    for k in ("loss", "ce", "z", "moe", "grad_norm", "lr"):
        _close(port[f"metric.{k}"], ref[f"metric.{k}"], FP32_TOL, k)
    for kind in ("mu", "param"):
        keys = [k for k in ref if k.startswith(kind + ".")]
        assert keys and sorted(keys) == sorted(
            k for k in port if k.startswith(kind + "."))
    _check_update(port, ref, results[f"params.{arch}"])


def _check_update(port, ref, old):
    """The first moments and the updated params of one train step against
    the reference's, by the rule of the module docstring."""
    lr, b1, wd = float(ref["metric.lr"]), ADAM.b1, ADAM.weight_decay
    for k in (k for k in ref if k.startswith("mu.")):
        _close(port[k], ref[k], FP32_TOL, k)
    for k in (k for k in ref if k.startswith("param.")):
        p0 = old[k[len("param."):]].astype(np.float32)
        w = ref[k].astype(np.float32)
        g = port[k].astype(np.float32)
        kept = np.abs(ref["mu." + k[len("param."):]] / (1 - b1)) > NEAR_ZERO
        tol = FP32_TOL * float(np.abs(w).max())
        assert np.isfinite(g).all() and g.shape == w.shape, k
        assert float(np.abs(g - w)[kept].max(initial=0.0)) <= tol, k
        assert tol < float(np.abs(w - p0)[kept].max(initial=np.inf)), k
        step = lr * (1 + wd * np.abs(p0)) * (1 + FP32_TOL)
        assert (np.abs(g - p0)[~kept] <= step[~kept]).all(), k


@pytest.mark.parametrize("case", list(RESHAPE_CASES))
def test_reshape_of_a_dtensor_equals_the_plain_reshape(run_dir, case):
    assert bool(np.load(run_dir / "port_reshape.npz")[case])


@pytest.mark.parametrize("arch", MOE)
def test_grouped_moe_routing_is_exact(results, arch):
    port, ref = results[arch]
    for name in ("tok_s", "slot", "keep"):
        assert np.array_equal(port[f"moe.{name}"], ref[f"moe.{name}"]), name
    _close(port["moe.gate_s"], ref["moe.gate_s"], FP32_TOL, "gate_s")
    _close(port["moe.y"], ref["moe.y"], FP32_TOL, "moe y")
    _close(port["moe.aux"], ref["moe.aux"], FP32_TOL, "moe aux")


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decode_on_the_mesh_match_the_reference(results, arch):
    port, ref = results[arch]
    _close(port["prefill"], ref["prefill"], FP32_TOL, "prefill logits")
    for i in range(DECODE):
        _close(port[f"decode.{i}"], ref[f"decode.{i}"], FP32_TOL,
               f"decode {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_on_the_mesh_equals_one_device_and_restores(
        run_dir, results, arch):
    port, _ = results[arch]
    mesh_dir = run_dir / f"ckpt_mesh_{arch}" / "step_1"
    one_dir = run_dir / f"ckpt_one_{arch}" / "step_1"
    names = sorted(p.name for p in mesh_dir.iterdir()
                   if p.name.startswith("leaf_"))
    assert names == sorted(p.name for p in one_dir.iterdir()
                           if p.name.startswith("leaf_"))
    assert names
    for n in names:
        assert (mesh_dir / n).read_bytes() == (one_dir / n).read_bytes(), n
    assert bool(port["restore_mesh"]) and bool(port["restore_1x1"])
