"""The port's sharding policy and model mesh (``repro_torch.parallel.
sharding``, ``repro_torch.launch.mesh``) against repro's, on the CPU.

The reference's policy reads only ``mesh.axis_names`` and ``mesh.shape``,
so it is handed a plain stand-in of each mesh shape, (1, 1), (16, 16) and
(2, 16, 16), and needs no devices; its ``NamedSharding`` is replaced by
the bare spec for the test (``monkeypatch``), nothing of the package
edited.  Compared spec for spec (as tuples):

* ``param_spec`` through ``param_sharding_tree`` and
  ``opt_sharding_tree`` for every leaf of every arch's *full*
  ``param_logical_axes``, under ``policy_for(arch)`` and ``Policy()``;
* ``act_spec`` for every kind, ``batch_axes``, ``cache_seq_axes`` and
  ``cache_spec_tree`` on ``init_cache``'s abstract tree;
* ``make_constraint_fn``'s ``moe_groups`` and ``moe_mode`` (its ``cs``
  is the identity on a mesh without a ``device_mesh``; placement on one
  is ``tests/test_torch_mesh_model.py``'s).

Also twins of the seven passing cases of ``tests/test_sharding.py`` and the
``MeshFallbackWarning`` path of ``make_production_mesh``.
"""
import warnings
from types import SimpleNamespace

import pytest
import torch

from repro_torch import configs as tcf
from repro_torch.convert import flat_items
from repro_torch.launch.mesh import (MeshFallbackWarning, ModelMesh, dp_axes,
                                     dp_size, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as TT
from repro_torch.parallel.sharding import (P, Policy, fitted_spec,
                                           make_constraint_fn, policy_for)
from test_torch_train import one_torch_thread  # noqa: F401

SHAPES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("btd", "b1d", "btv", "bt", "bpd", "b", "gtd", "gecd_dp", "gecd_ep",
         "gecf")
BATCHES = (1, 8, 32, 512)


def _meshes(name):
    sizes, axes = SHAPES[name]
    ref = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    return ref, ModelMesh(axes, sizes)


@pytest.fixture
def ref_sharding(monkeypatch):
    from repro.parallel import sharding as RS
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)
    return RS


def _policies(arch, RS):
    return {"policy_for": (RS.policy_for(arch), policy_for(arch)),
            "default": (RS.Policy(), Policy())}


def _specs(tree):
    return {k: tuple(v) for k, v in flat_items(tree)}


@pytest.mark.parametrize("mesh_name", list(SHAPES))
@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name,
                                                 ref_sharding):
    from repro.configs import get_config
    from repro.models import transformer as T
    rmesh, mesh = _meshes(mesh_name)
    rcfg, cfg = get_config(arch), tcf.get_config(arch)
    raxes, rabs = T.param_logical_axes(rcfg), T.abstract_params(rcfg)
    axes, ab = TT.param_logical_axes(cfg), TT.abstract_params(cfg)
    for rpol, pol in _policies(arch, ref_sharding).values():
        for method in ("param_sharding_tree", "opt_sharding_tree"):
            want = _specs(getattr(rpol, method)(raxes, rabs, rmesh))
            got = _specs(getattr(pol, method)(axes, ab, mesh))
            assert got == want, (arch, mesh_name, method)


@pytest.mark.parametrize("mesh_name", list(SHAPES))
def test_activation_and_cache_specs_equal_the_reference(mesh_name,
                                                        ref_sharding):
    from repro.configs import get_smoke
    from repro.models import transformer as T
    rmesh, mesh = _meshes(mesh_name)
    for arch in tcf.ARCH_IDS:
        for rpol, pol in _policies(arch, ref_sharding).values():
            for gb in BATCHES:
                assert pol.batch_axes(mesh, gb) == rpol.batch_axes(rmesh, gb)
                assert pol.cache_seq_axes(mesh, gb) == \
                    rpol.cache_seq_axes(rmesh, gb)
                for kind in KINDS:
                    assert tuple(pol.act_spec(kind, mesh, gb)) == \
                        tuple(rpol.act_spec(kind, rmesh, gb)), (arch, kind)
            for gb in (2, 16):
                rcache = T.init_cache(get_smoke(arch), T.abstract_params(
                    get_smoke(arch)), gb, 64, abstract=True)
                cache = TT.init_cache(tcf.get_smoke(arch), TT.abstract_params(
                    tcf.get_smoke(arch)), gb, 64, abstract=True)
                assert _specs(pol.cache_spec_tree(cache, mesh, gb)) == \
                    _specs(rpol.cache_spec_tree(rcache, rmesh, gb)), arch
        with pytest.raises(ValueError):
            Policy().act_spec("nope", mesh, 8)


@pytest.mark.parametrize("mesh_name", list(SHAPES))
def test_constraint_fn_matches_the_reference(mesh_name, ref_sharding):
    rmesh, mesh = _meshes(mesh_name)
    for arch in ("llama3_8b", "granite_moe_1b", "jamba_15_large_398b"):
        rpol, pol = _policies(arch, ref_sharding)["policy_for"]
        for gb in BATCHES:
            cs = make_constraint_fn(pol, mesh, gb)
            assert cs.moe_mode == rpol.moe_mode
            want_groups = (ref_sharding.dp_size(rmesh)
                           if gb % max(ref_sharding.dp_size(rmesh), 1) == 0
                           else 1)
            assert cs.moe_groups == want_groups
            x = torch.empty((gb, 7, 64), device="meta")
            # a mesh without a device_mesh holds plain tensors: identity
            assert cs.device_mesh is None and cs(x, "btd") is x
            # the reference's shape fit: an entry whose axis size does not
            # divide the dim is dropped
            spec = cs.spec(x, "btv")
            assert tuple(spec) == tuple(fitted_spec(
                pol.act_spec("btv", mesh, gb), (gb, 7, 64), mesh))
            assert len(spec) == 3 and spec[1] is None


def test_fitted_spec_drops_what_does_not_divide():
    _, mesh = _meshes("16x16")
    assert fitted_spec(P("data", None, "model"), (32, 4, 6), mesh) == \
        P("data", None, None)
    assert fitted_spec(P("data", "model"), (8,), mesh) == P(None, None)


# ---- twins of tests/test_sharding.py ---------------------------------------

def _mesh_16x16_sim():
    return ModelMesh(("data", "model"), (1, 1))


def test_param_spec_tp_on_divisible_dims():
    spec = Policy().param_spec(("embed", "heads", "head_dim"),
                               _mesh_16x16_sim(), (64, 4, 16))
    assert spec == P(None, "model", None)


def test_param_spec_row_parallel_fallback():
    """56 heads % 16 -> TP lands on the contraction dim instead."""
    spec = Policy().param_spec(("embed", "heads", "head_dim"),
                               _mesh_16x16_sim(), (64, 56, 128))
    assert spec[0] in (None, "model")
    # on a real 16-wide model axis, with a tensor too big to replicate
    _, mesh = _meshes("16x16")
    spec = Policy().param_spec(("embed", "heads", "head_dim"), mesh,
                               (8192, 56, 128))
    assert spec == P("model", None, None)


def test_param_spec_experts_to_data():
    spec = Policy().param_spec(("experts", "embed", "ffn"),
                               _mesh_16x16_sim(), (16, 64, 128))
    assert spec == P("data", None, "model")


def test_param_spec_no_duplicate_axes():
    for name in SHAPES:
        _, mesh = _meshes(name)
        spec = Policy(fsdp=True).param_spec(("experts", "embed", "ffn"), mesh,
                                            (16, 64, 128))
        flat = []
        for s in spec:
            if s is not None:
                flat.extend(s if isinstance(s, tuple) else [s])
        assert len(flat) == len(set(flat))


def test_policy_for_big_archs_enables_fsdp():
    assert policy_for("jamba_15_large_398b").fsdp
    assert policy_for("phi35_moe_42b").fsdp
    assert not policy_for("llama3_8b").fsdp


def test_batch_axes_divisibility():
    p = Policy()
    assert p.batch_axes(_mesh_16x16_sim(), 8) == "data"
    mesh1 = make_host_mesh("cpu")
    assert p.batch_axes(mesh1, 1) == "data"      # dp_size 1 divides 1
    _, mesh = _meshes("16x16")
    assert p.batch_axes(mesh, 8) is None
    _, mesh = _meshes("2x16x16")
    assert p.batch_axes(mesh, 64) == ("pod", "data")


def test_dp_axes_helpers():
    mesh = make_host_mesh("cpu")
    assert dp_axes(mesh) == ("data",)
    assert dp_size(mesh) == 1
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device == torch.device("cpu") and mesh.device_mesh is None
    _, mesh = _meshes("2x16x16")
    assert dp_axes(mesh) == ("pod", "data") and dp_size(mesh) == 32


def test_production_mesh_falls_back_with_a_warning():
    """Without a process group there is one device: both topologies
    degrade to 1x1 ('data', 'model') and say so; made an error, the
    warning stops the call."""
    for multi_pod in (False, True):
        with pytest.warns(MeshFallbackWarning, match="degrading to a 1x1"):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.axis_names == ("data", "model") and mesh.sizes == (1, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", MeshFallbackWarning)
        with pytest.raises(MeshFallbackWarning):
            make_production_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
