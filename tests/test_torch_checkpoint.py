"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against repro's, on the CPU.

* Twins of ``tests/test_substrates.py``'s five checkpoint cases (the
  mesh-agnostic restore places the leaves on a chosen device).
* The same on-disk layout: a checkpoint written by the reference's
  ``CheckpointManager`` restores in the port bit for bit, and one written
  by the port restores in the reference, for a tree of bf16, fp32 and
  int32 leaves and for a whole smoke train state ``{"params", "opt"}``
  (llama3_8b's smoke params after one AdamW step, and jamba's smoke
  params with its bf16 first moment); the two write equal leaf files and
  dtype tags.
* The optimizer- and train-state converters round-trip bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from test_torch_train import one_torch_thread  # noqa: F401


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _abstract(tree):
    return adamw.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"), tree)


# ---- twins of tests/test_substrates.py ---------------------------------------

def test_checkpoint_roundtrip_bitexact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree)
    out = mgr.restore(10, _abstract(tree), device="cpu")
    for a, b in zip(adamw.tree_leaves(tree), adamw.tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save_async(5, tree)
    tree["a"].add_(1.0)            # the snapshot was taken at the call
    mgr.wait()
    assert mgr.latest_step() == 5
    out = mgr.restore(5, _abstract(tree), device="cpu")
    assert torch.equal(out["a"], tree["a"] - 1.0)


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    names = os.listdir(tmp_path)
    assert all(n.startswith("step_") for n in names)


def test_checkpoint_mesh_agnostic_restore(tmp_path):
    """Saved whole, restored onto the device the caller names; without a
    device it takes the GPU, and raises where there is none."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones((8, 4), dtype=torch.float32)}
    mgr.save(2, tree)
    out = mgr.restore(2, _abstract(tree), device="cpu")
    assert out["w"].device.type == "cpu" and torch.equal(out["w"], tree["w"])
    step, latest = mgr.restore_latest(_abstract(tree), device="cpu")
    assert step == 2 and torch.equal(latest["w"], tree["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(2, _abstract(tree))


# ---- the reference's files, both ways ----------------------------------------

def _ref_mixed():
    import jax.numpy as jnp
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7,
            "b": {"c": (jnp.arange(5, dtype=jnp.float32) / 3).astype(
                jnp.bfloat16), "d": jnp.int32(7)},
            "e": [jnp.arange(6, dtype=jnp.int32) * -3,
                  jnp.full((2, 2), -1.5, jnp.bfloat16)]}


def _ref_train_state(arch):
    """The reference's smoke params after one AdamW step (grads = params),
    so that every moment and ``count`` is set."""
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models import transformer as T
    from repro.optim import adamw as R
    cfg = ref_smoke(arch)
    opt_cfg = R.config_for(arch)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    params, opt, _ = R.update(opt_cfg, params, R.init(opt_cfg, params),
                              params)
    return {"params": params, "opt": opt}


def _port_abstract(arch):
    cfg = get_smoke(arch)
    ab = TT.abstract_params(cfg)
    return {"params": ab, "opt": adamw.abstract_state(adamw.config_for(arch),
                                                      ab)}


def _ref_abstract(tree):
    import jax
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype),
                        tree)


def _bits_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def _leaf_files_equal(d1, d2) -> None:
    names = sorted(n for n in os.listdir(d1) if n.startswith("leaf_"))
    assert names == sorted(n for n in os.listdir(d2)
                           if n.startswith("leaf_"))
    for n in names:
        if n.endswith(".meta"):
            assert open(os.path.join(d1, n)).read() == \
                open(os.path.join(d2, n)).read(), n
        else:
            a, b = np.load(os.path.join(d1, n)), np.load(os.path.join(d2, n))
            assert a.dtype == b.dtype and np.array_equal(a, b), n


def _mixed_port():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7,
            "b": {"c": (torch.arange(5, dtype=torch.float32) / 3).to(
                torch.bfloat16), "d": torch.tensor(7, dtype=torch.int32)},
            "e": [torch.arange(6, dtype=torch.int32) * -3,
                  torch.full((2, 2), -1.5, dtype=torch.bfloat16)]}


@pytest.mark.parametrize("case", ["mixed", "llama3_8b", "jamba_15_large_398b"])
def test_checkpoints_cross_between_the_packages(tmp_path, case):
    from repro.checkpoint.manager import CheckpointManager as RefManager

    from repro_torch.convert import params_to_numpy
    if case == "mixed":
        ref_tree, port_abs = _ref_mixed(), _abstract(_mixed_port())
        flat = params_to_numpy
    else:
        ref_tree, port_abs = _ref_train_state(case), _port_abstract(case)
        flat = train_state_to_numpy
    want = flat(ref_tree)

    # the reference writes, the port reads
    RefManager(str(tmp_path / "ref")).save(3, ref_tree)
    got = CheckpointManager(str(tmp_path / "ref")).restore(3, port_abs,
                                                           device="cpu")
    _bits_equal(flat(got), want)

    # the port writes, the reference reads
    CheckpointManager(str(tmp_path / "port")).save(3, got)
    back = RefManager(str(tmp_path / "port")).restore(3, _ref_abstract(
        ref_tree))
    _bits_equal(flat(back), want)
    _leaf_files_equal(tmp_path / "ref" / "step_3", tmp_path / "port" /
                      "step_3")


# ---- converters -----------------------------------------------------------------

def test_train_state_converters_round_trip_bit_for_bit():
    cfg = get_smoke("jamba_15_large_398b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    opt_cfg = adamw.config_for(cfg.name)
    params, opt, _ = adamw.update(opt_cfg, params, adamw.init(opt_cfg, params),
                                  params)
    state = {"params": params, "opt": opt}
    flat = train_state_to_numpy(state)
    assert flat["opt.count"].dtype == np.int32 and int(flat["opt.count"]) == 1
    assert any(v.dtype == np.uint16 for k, v in flat.items()
               if k.startswith("opt.mu."))          # jamba's bf16 mu
    back = train_state_from_numpy(flat, device="cpu")
    _bits_equal(train_state_to_numpy(back), flat)
    assert isinstance(back["opt"], adamw.AdamWState)
    for a, b in zip(adamw.tree_leaves([params, list(opt)]),
                    adamw.tree_leaves([back["params"], list(back["opt"])])):
        assert a.dtype == b.dtype and a.shape == b.shape
    ob = opt_state_from_numpy(opt_state_to_numpy(opt), device="cpu")
    _bits_equal(opt_state_to_numpy(ob), opt_state_to_numpy(opt))
