"""The port's kernel layer on the CPU: plain K1/K2, oracles and search_kernel
against repro's (Pallas kernels in interpret mode), plus the package's
import hygiene.  The CUDA kernels themselves are tested on a card by
``tests/test_torch_kernels_gpu.py``."""
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.kernel_budget import tile_bytes
from repro.core import sharded as shd
from repro.core import skiplist as sl
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro.kernels.foresight_traverse import (base_traverse,
                                              foresight_traverse,
                                              traversal_bound)
from repro_torch.convert import sharded_from_numpy, state_from_numpy
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import validated_traverse as tvt

PKG = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _case(n, cap, levels, foresight, batch, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 22, n, replace=False)).astype(np.int32)
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys + 1), capacity=cap,
                  levels=levels, foresight=foresight, seed=seed)
    ts = tsl.build(keys, keys + 1, capacity=cap, levels=levels,
                   foresight=foresight, seed=seed, device="cpu")
    q = np.concatenate([rng.choice(keys, batch // 2),
                        rng.integers(0, 1 << 22, batch - batch // 2)]
                       ).astype(np.int32)
    return js, ts, q


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,cap,levels,batch", [(100, 256, 8, 128),
                                                (1000, 2048, 12, 256)])
def test_plain_k1_matches_ref_and_pallas(n, cap, levels, batch):
    js, ts, q = _case(n, cap, levels, True, batch, n)
    got = tft.foresight_traverse(ts.fused, torch.from_numpy(q))
    _eq(got, kref.foresight_search_ref(js.fused, jnp.asarray(q)))
    _eq(got, foresight_traverse(js.fused, jnp.asarray(q)))
    _eq(tref.foresight_search_ref(ts.fused, torch.from_numpy(q)),
        kref.foresight_search_ref(js.fused, jnp.asarray(q)))


@pytest.mark.parametrize("n,cap,levels,batch", [(100, 256, 8, 128),
                                                (1000, 2048, 12, 256)])
def test_plain_k2_matches_ref_and_pallas(n, cap, levels, batch):
    js, ts, q = _case(n, cap, levels, False, batch, n)
    got = tft.base_traverse(ts.nxt, ts.keys, torch.from_numpy(q))
    _eq(got, kref.base_search_ref(js.nxt, js.keys, jnp.asarray(q)))
    _eq(got, base_traverse(js.nxt, js.keys, jnp.asarray(q)))
    _eq(tref.base_search_ref(ts.nxt, ts.keys, torch.from_numpy(q)),
        kref.base_search_ref(js.nxt, js.keys, jnp.asarray(q)))


@pytest.mark.parametrize("foresight", [True, False])
def test_plain_max_steps_truncates_like_pallas(foresight):
    js, ts, q = _case(1000, 2048, 12, foresight, 128, 4)
    qt, qj = torch.from_numpy(q), jnp.asarray(q)
    if foresight:
        got = tft.foresight_traverse(ts.fused, qt, max_steps=9)
        want = foresight_traverse(js.fused, qj, max_steps=9)
    else:
        got = tft.base_traverse(ts.nxt, ts.keys, qt, max_steps=9)
        want = base_traverse(js.nxt, js.keys, qj, max_steps=9)
    _eq(got, want)


def test_traversal_bound_and_tile_bytes_match_repro():
    for L, cap in [(4, 64), (14, 8192), (27, 2**26), (1, 1)]:
        assert tft.traversal_bound(L, cap) == traversal_bound(L, cap)
        for fs in (True, False):
            assert tops.tile_bytes(L, cap, fs) == tile_bytes(L, cap, fs)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("batch", [37, 200])
def test_search_kernel_matches_repro(foresight, batch):
    js, ts, q = _case(500, 1024, 10, foresight, batch, 9)
    want = kops.search_kernel(js, jnp.asarray(q))
    got = tops.search_kernel(ts, torch.from_numpy(q))
    assert got.found.shape == (batch,)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_search_kernel_float_matches_repro():
    rng = np.random.default_rng(12)
    f = np.sort(rng.normal(size=200).astype(np.float32))
    enc = np.array(kref.encode_float_keys(jnp.asarray(f)))
    np.testing.assert_array_equal(
        tref.encode_float_keys(torch.from_numpy(f)).numpy(), enc)
    np.testing.assert_array_equal(
        tref.decode_float_keys(torch.from_numpy(enc)).numpy(), f)
    vals = np.arange(200, dtype=np.int32)
    js = sl.build(jnp.asarray(enc), jnp.asarray(vals), capacity=512,
                  levels=10, foresight=True)
    ts = tsl.build(enc, vals, capacity=512, levels=10, device="cpu")
    q = np.concatenate([f[:64], rng.normal(size=64).astype(np.float32)])
    want = kops.search_kernel_float(js, jnp.asarray(q))
    got = tops.search_kernel_float(ts, torch.from_numpy(q))
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.vals[:64].numpy(), np.arange(64))


def test_search_kernel_rejects_sharded_states():
    """A state that is not the port's (repro's sharded index here, or a mesh
    index) is refused; stacked arrays convert through sharded_from_numpy
    only, into the port's ShardedSkipList, which search_kernel takes."""
    keys = jnp.arange(1, 200, dtype=jnp.int32)
    sharded = shd.build_sharded(keys, keys, n_shards=2, levels=6)
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="not a repro_torch state"):
        tops.search_kernel(sharded, q)
    arrays = {k: np.asarray(v) for k, v in sharded.shards._asdict().items()
              if v is not None}
    with pytest.raises(NotImplementedError, match="sharded_from_numpy"):
        state_from_numpy(arrays, "cpu")
    port = sharded_from_numpy({**{f"shards.{k}": v for k, v in arrays.items()},
                               "boundaries": np.asarray(sharded.boundaries)},
                              "cpu")
    want = kops.search_kernel(sharded, jnp.arange(0, 210, 7, dtype=jnp.int32))
    got = tops.search_kernel(port, torch.arange(0, 210, 7, dtype=torch.int32))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_index_range_limit_is_checked_on_shapes():
    tops.check_index_range(27, 2**26)
    tops.check_index_range(1, 2**31 - 1)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tops.check_index_range(32, 2**26)
    # A state on the meta device has shapes and no storage.
    st = tsl.empty(8, 4, device="cpu")
    big = st._replace(keys=torch.empty(2**26, dtype=torch.int32,
                                       device="meta"),
                      fused=torch.empty((33, 2**26, 2), dtype=torch.int32,
                                        device="meta"))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tops.search_kernel(big, torch.zeros(4, dtype=torch.int32))


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    fused = torch.empty((4, 16, 2), dtype=torch.int32, device="meta")
    q = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tft.foresight_traverse(fused, q)
    with pytest.raises(ValueError, match="CUDA"):
        tft.base_traverse(fused[..., 0], fused[0, :, 0], q)
    with pytest.raises(ValueError, match="CUDA"):
        tvt.validated_traverse(fused, fused[0, :, 0], q)


def test_cpu_lookups_launch_no_kernel():
    _, ts, q = _case(100, 256, 8, True, 64, 1)
    before = tft.foresight_traverse.launches
    tops.search_kernel(ts, torch.from_numpy(q))
    assert tft.foresight_traverse.launches == before


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import repro_torch, repro_torch.convert\n"
            "import repro_torch.core.skiplist, repro_torch.kernels.ops\n"
            "import repro_torch.kernels._build\n"
            "import repro_torch.core.validated, repro_torch.core.versioned\n"
            "import repro_torch.kernels.validated_traverse\n"
            "import repro_torch.core.sharded\n"
            "import repro_torch.configs, repro_torch.models.transformer\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_file_of_the_port_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)",
                         re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [PKG.parent.parent / name for name in
                                        ("chip_smoke.py",
                                         "chip_probe_train.py")]
    assert len(files) >= 11
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders
