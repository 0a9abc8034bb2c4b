"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.costs``) on
a fake process group in this process, against the reference's shard
arithmetic and its compiled steps.

One module fixture runs the reference in a fresh ``python`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (the flag must
precede JAX's start):

* for every cell of ``configs.all_cells()`` on the 16x16 and the
  2x16x16 Auto-axis ``Mesh`` (``jax.make_mesh``'s Explicit axes break the
  reference's factories, ROADMAP Queue 3), at full width, the bytes of
  one device's shards of the step's inputs, ``NamedSharding.shard_shape``
  of each input under the factory's shardings (no compile);
* the smoke cells of ``tests/test_sharding.py``'s two dry-run cases
  (llama3_8b on a 2x4 mesh: a train step at batch 4 x 32 tokens, a
  decode step at batch 4 against 64 positions) and a MoE smoke cell
  (jamba_15_large_398b's train step under its policy), compiled:
  ``memory_analysis().argument_size_in_bytes`` and XLA's ``flops``.

The port's side runs here, each cell in a fake group of its size (no
spawn): its argument bytes under its placement equal the reference's,
cell for cell and byte for byte; on the smoke cells ``run_smoke_cell``
(the traced step) reports the same argument bytes, its per-device
product FLOPs times the devices are at least a 1x1 trace's and at most
``REPLICATION`` times it (the
reference's XLA flops are printed beside them, for information: they
count another set of ops), and jamba's traced step issues all-to-alls
(its ``ep_a2a`` dispatch).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs as tcf
from repro_torch.launch import dryrun as D
from repro_torch.parallel.sharding import Policy, policy_for

ROOT = Path(__file__).resolve().parent.parent
MESHES = (False, True)
SMOKE = {"llama_train": ("llama3_8b", "train", 4, 32, "default"),
         "llama_decode": ("llama3_8b", "decode", 4, 64, "default"),
         "jamba_train": ("jamba_15_large_398b", "train", 4, 32, "arch")}
# Per-device product FLOPs x 8 over one device's, at most: the batch's
# data split halves every product, and of the half left the model axis
# splits most 4 ways; what it repeats on each of its ranks (attention's
# scores and values, heads the axis does not divide, the router) makes
# these smoke cells' ratios 1.26-1.52, against 8 for a global count.
REPLICATION = 2.0

REFERENCE = r"""
import json, math, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import SHAPES, all_cells, get_config, get_smoke
from repro.launch.costs import cost_dict
from repro.optim import adamw
from repro.parallel.sharding import Policy, policy_for
from repro.train import step as STEP

SMOKE = json.loads(sys.argv[1])


def mesh_of(shape, axes):
    n = math.prod(shape)
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def shard_bytes(shd_tree, abs_tree):
    leaves = jax.tree.leaves(abs_tree)
    shds = jax.tree.leaves(shd_tree, is_leaf=lambda x: hasattr(
        x, "shard_shape"))
    assert len(leaves) == len(shds)
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for s, a in zip(shds, leaves))


def step_inputs(cfg, pol, mesh, kind, gb, seq, opt_cfg):
    if kind == "train":
        fn, (p, o, b), (pa, oa) = STEP.make_train_step(cfg, pol, mesh, gb,
                                                       opt_cfg)
        ba = STEP.train_input_specs(cfg, gb, seq)
        return fn, [(p, pa), (o, oa), (b, ba)], (pa, oa, ba)
    if kind == "prefill":
        fn, (p, b, _), (pa, _) = STEP.make_prefill_step(cfg, pol, mesh, gb,
                                                        seq, seq)
        ba = STEP.prefill_input_specs(cfg, gb, seq)
        return fn, [(p, pa), (b, ba)], (pa, ba)
    fn, (p, c, t), (pa, ca) = STEP.make_decode_step(cfg, pol, mesh, gb, seq)
    ta = STEP.decode_input_specs(cfg, gb)
    return fn, [(p, pa), (c, ca), (t, ta)], (pa, ca, ta)


out = {"cells": {}, "smoke": {}}
meshes = {False: mesh_of((16, 16), ("data", "model")),
          True: mesh_of((2, 16, 16), ("pod", "data", "model"))}
for arch, shape in all_cells():
    spec = SHAPES[shape]
    for mp, mesh in meshes.items():
        _, pairs, _ = step_inputs(get_config(arch), policy_for(arch), mesh,
                                  spec.kind, spec.global_batch,
                                  spec.seq_len, adamw.config_for(arch))
        out["cells"][f"{arch}|{shape}|{mp}"] = sum(
            shard_bytes(s, a) for s, a in pairs)
mesh = mesh_of((2, 4), ("data", "model"))
for name, (arch, kind, gb, seq, pol) in SMOKE.items():
    pol = Policy() if pol == "default" else policy_for(arch)
    fn, _, ins = step_inputs(get_smoke(arch), pol, mesh, kind, gb, seq,
                             adamw.AdamWConfig())
    with mesh:
        compiled = fn.lower(*ins).compile()
    out["smoke"][name] = {
        "argument_size_in_bytes":
            int(compiled.memory_analysis().argument_size_in_bytes),
        "flops": float(cost_dict(compiled).get("flops", 0.0))}
print("REFERENCE_JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", REPRO_MOE_BF16="1")
    run = subprocess.run([sys.executable, "-c", REFERENCE,
                          json.dumps(SMOKE)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=900)
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("REFERENCE_JSON ")]
    assert run.returncode == 0 and lines, run.stderr[-3000:]
    return json.loads(lines[-1][len("REFERENCE_JSON "):])


@pytest.fixture(scope="module")
def smoke_traces():
    out = {}
    for name, (arch, kind, gb, seq, pol) in SMOKE.items():
        policy = Policy() if pol == "default" else policy_for(arch)
        cfg = tcf.get_smoke(arch)
        out[name] = (D.run_smoke_cell(cfg, kind, gb, seq, policy=policy),
                     D.run_smoke_cell(cfg, kind, gb, seq, shape=(1, 1),
                                      policy=policy))
    return out


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_argument_bytes_equal_the_reference_shard_arithmetic(
        reference, arch, multi_pod):
    for a, shape in tcf.all_cells():
        if a != arch:
            continue
        got = D.argument_bytes(arch, shape, multi_pod, device="cpu")
        assert got == reference["cells"][f"{arch}|{shape}|{multi_pod}"], \
            (arch, shape, multi_pod)


@pytest.mark.parametrize("name", list(SMOKE))
def test_smoke_cell_argument_bytes_equal_the_reference_compiled(
        reference, smoke_traces, name):
    rec, _ = smoke_traces[name]
    want = reference["smoke"][name]["argument_size_in_bytes"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    if name == "llama_train":
        assert want == 156_676
    mem = rec["memory_analysis"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("name", list(SMOKE))
def test_per_device_flops_times_devices_cover_one_device(
        reference, smoke_traces, name):
    rec, one = smoke_traces[name]
    flops, flops1 = rec["cost_analysis"]["flops"], one["cost_analysis"][
        "flops"]
    print(f"{name}: per device {flops:.4g} x 8 = {8 * flops:.4g}, "
          f"one device {flops1:.4g}, the reference's XLA flops "
          f"{reference['smoke'][name]['flops']:.4g}")
    # every product is counted on some device, and none on all of them:
    # a count of the DTensor-level global products (8x) would fail
    assert flops > 0 and flops1 <= 8 * flops <= REPLICATION * flops1
    assert one["collectives"]["total_bytes"] == 0


def test_jamba_dispatch_issues_all_to_all(smoke_traces):
    rec, _ = smoke_traces["jamba_train"]
    per_kind = rec["collectives"]["per_kind"]
    assert per_kind.get("all-to-all", 0) > 0, per_kind
    assert rec["collectives"]["per_kind_ops"]["all-to-all"] >= 4
