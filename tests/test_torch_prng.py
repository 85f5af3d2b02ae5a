"""Port parity of grendel_tpu_torch/utils/prng.py, the JAX package's
random numbers drawn with PyTorch, against ``jax.random`` itself: keys,
folded keys and split keys equal; 32-bit draws, ``uniform`` and
``randint`` equal bit for bit, and the random background's draw from
(seed, iteration) byte for byte; ``normal`` from the same uniform draw
through XLA's erfinv
polynomial, within 4 ulp (measured: about 95% of values equal, the rest
at most 3 ulp apart, from log1p's and the multiply-adds' rounding).
"""

import jax
import numpy as np
import pytest
import torch

from grendel_tpu.testing import random_gaussians as jax_random_gaussians
from grendel_tpu_torch import testing
from grendel_tpu_torch.utils import prng

SEEDS = [0, 7, 3 * 1000003 + 47, 2 ** 31 - 1]


def key_tuple(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    k = jax.random.key(seed)
    assert key_tuple(k) == prng.key(seed)
    for data in (0, 1, 3, 2 ** 32 - 1):
        assert key_tuple(jax.random.fold_in(k, data)) == prng.fold_in(
            prng.key(seed), data), data
    assert [key_tuple(s) for s in jax.random.split(k)] == [
        prng.fold_in(prng.key(seed), i) for i in range(2)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5, 2, 3), (1024, 2, 3), (4097,)])
def test_bits_and_randint_equal_jax(seed, shape, monkeypatch):
    # a small chunk puts chunk edges inside every shape but the first
    monkeypatch.setattr(prng, "CHUNK", 1000)
    n = int(np.prod(shape))
    k = jax.random.key(seed)
    want = np.asarray(jax.random.bits(k, shape, dtype=np.uint32))
    got = prng.random_bits(prng.key(seed), n, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64).ravel())
    for high in (1, 2, 3, 4, 8, 100, 70000):
        want = np.asarray(jax.random.randint(k, shape, 0, high))
        got = prng.randint(prng.key(seed), shape, high, "cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(high))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo, hi", [(-1.5, 1.5), (-4.5, -2.5), (0.3, 0.95),
                                    (0.1, 0.9)])
def test_uniform_equals_jax(seed, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (50000,),
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.key(seed), (50000,), lo, hi, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed, iteration", [
    (0, 0), (7, 0), (7, 2), (0, 29_998), (5, 65_537), (3, 2 ** 20 + 6),
    (2 ** 31 - 1, 2 ** 31 - 2)])
def test_background_draw_equals_jax(seed, iteration):
    """The random background of the step at ``iteration``, JAX's
    ``uniform(fold_in(key(seed), iteration), (3,))`` in float32, byte for
    byte in each of the port's three ways: on the host in Python ints
    (the loops' draw), in tensors from a folded int key, and from the
    iteration as an int32 tensor (``DistributedTrainer.step``'s draw)."""
    want = np.asarray(jax.random.uniform(jax.random.fold_in(
        jax.random.key(seed), iteration), (3,), jax.numpy.float32))
    k = prng.fold_in(prng.key(seed), iteration)
    host = prng.uniform_host(k, 3, 0.0, 1.0)
    assert host.dtype == np.float32 and host.tobytes() == want.tobytes()
    assert prng.uniform(k, (3,), 0.0, 1.0, "cpu").numpy().tobytes() == (
        want.tobytes())
    k_dev = prng.fold_in(prng.key(seed),
                         torch.tensor(iteration, dtype=torch.int32))
    assert tuple(int(v) for v in k_dev) == k
    got = prng.uniform(k_dev, (3,), 0.0, 1.0, "cpu")
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seed, n, sh_degree", [(3, 120, 1), (0, 300, 3)])
def test_jax_random_gaussians_match_jax(seed, n, sh_degree):
    """The port's draw of the JAX package's random Gaussians: means and
    opacities bit for bit, the rest within a few ulp (XLA's exp and
    erfinv against PyTorch's)."""
    want = [np.asarray(x) for x in jax_random_gaussians(
        jax.random.PRNGKey(seed), n, sh_degree=sh_degree)]
    got = testing.jax_random_gaussians(seed, n, sh_degree=sh_degree)
    for name, a, b in zip(("means", "scales", "quats", "opac", "sh"), got,
                          want):
        assert a.dtype == np.float32 and a.shape == b.shape, name
        ulp = np.spacing(np.abs(b).astype(np.float32))
        assert (np.abs(a - b) <= 4 * ulp).all(), name
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax_within_four_ulp(seed):
    shape = (20000, 2, 3)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 4 * ulp).all()
    assert (got == want).mean() > 0.9
    assert abs(float(got.mean())) < 0.02 and abs(float(got.std()) - 1) < 0.02


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    want = np.asarray(jax.scipy.special.erfinv(x.numpy()))
    got = prng.erfinv(x).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[1]) and got[1] > 0
    np.testing.assert_allclose(got[2:], want[2:], rtol=3e-7)
