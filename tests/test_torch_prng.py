"""The port's threefry and tower-height sampler against jax.random / repro."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as sl
from repro_torch.core import prng
from repro_torch.core import skiplist as tsl

SEEDS = [0, 1, 42, 2**31 - 1, -1, -5, 2**32 + 5, 2**40]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def test_reference_values():
    """Values of jax.random under jax 0.9.0, partitionable threefry."""
    k = prng.PRNGKey(0)
    assert _np(k).tolist() == [0, 0]
    s = prng.split(k)
    assert _np(s).tolist() == [[1797259609, 2579123966],
                               [928981903, 3453687069]]
    assert _np(prng.bits(s[1], (5,))).tolist() == [
        31327077, 89727312, 2497208264, 1554082365, 957939715]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert _np(tk).dtype == np.uint32
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_np(prng.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(0,), (1,), (5,), (3, 4), (2, 3, 5),
                                   (4099,)])
def test_bits_match_jax(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = _np(prng.bits(torch.from_numpy(np.array(key)), shape))
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ctz_matches_repro_on_zero_and_every_power_of_two():
    """ctz depends only on the lowest set bit, so these 33 inputs plus the
    random ones stand for all 2**32 (repro's float32 log2 is off by one at
    six of the powers, and the port must be too)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([[0], 1 << np.arange(32, dtype=np.uint64),
                        rng.integers(0, 2**32, 5000)]).astype(np.uint32)
    want = np.asarray(sl._count_trailing_zeros(jnp.asarray(x)))
    got = _np(tsl._count_trailing_zeros(torch.from_numpy(x.astype(np.int64))))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,shape,levels", [
    (0, (1000,), 12), (3, (4000,), 14), (9, (20000,), 32), (5, (7, 9), 4)])
def test_sample_heights_match_repro(seed, shape, levels):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(sl.sample_heights(key, shape, levels))
    got = _np(tsl.sample_heights(torch.from_numpy(np.array(key)), shape,
                                 levels))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
