"""The port's threefry streams against jax.random (jax 0.9,
jax_threefry_partitionable=True — the reference streams depend on both).

Keys, raw bits, uniform, bernoulli and randint are bit-equal.  Two
transforms go through a float function whose rounding differs between
XLA-CPU and PyTorch-CPU by one ulp on some inputs:

  * exponential = -log1p(-u): <= 1 ulp (measured: ~7% of 1M draws at 1);
  * normal = sqrt(2) * erf_inv(u): the port evaluates XLA's own float32
    erf_inv polynomial, whose inner log1p carries that ulp; <= 3 ulp
    (measured maximum 3 over 8M draws; torch.erfinv would be ~90 off).

Neither feeds the detector's int/bool state: exponential scales probe
RTTs far inside the probe timeout, normal only orients Vivaldi springs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import ulps

from consul_tpu.utils import prng as jprng
from consul_tpu_torch.utils import prng

SEEDS = (0, 7, 2 ** 31 - 1)
TICKS = (0, 1, 5, 32767, 70000)
SHAPES = ((3,), (257,), (257, 3))


def _key(k) -> tuple:
    return tuple(int(x) for x in np.asarray(k))


def test_reference_stream_config():
    assert jax.__version__.startswith("0.9")
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bit_equal(seed):
    assert prng.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))
    for stream in range(1, 10):
        for tick in TICKS:
            assert prng.tick_key(seed, tick, stream) == \
                _key(jprng.tick_key(seed, tick, stream)), (stream, tick)
    k = jprng.tick_key(seed, 11, 1)
    assert prng.split(_key(k), 5) == [_key(x) for x in jax.random.split(k, 5)]
    assert prng.fold_in(_key(k), 70000) == _key(jax.random.fold_in(k, 70000))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_bit_equal(shape):
    k = jprng.tick_key(7, 33, 2)
    kt = _key(k)
    jb = np.asarray(jax.random.bits(k, shape, jnp.uint32)).view(np.int32)
    np.testing.assert_array_equal(prng.bits(kt, shape, "cpu").numpy(), jb)
    ju = np.asarray(jax.random.uniform(k, shape))
    tu = prng.uniform(kt, shape, "cpu").numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    for p in (0.99, 0.5, 0.01):
        np.testing.assert_array_equal(
            prng.bernoulli(kt, p, shape, "cpu").numpy(),
            np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("shape", SHAPES)
def test_exponential_within_one_ulp(shape):
    k = jprng.tick_key(7, 40, 1)
    je = np.asarray(jax.random.exponential(k, shape))
    te = prng.exponential(_key(k), shape, "cpu").numpy()
    assert ulps(je, te).max() <= 1


@pytest.mark.parametrize("n", (64, 1024, 262144, 1_000_000))
def test_randint_bit_equal(n):
    for tick in (0, 5, 999):
        k = jprng.tick_key(7, tick, 2)
        for shape in ((4,), (n % 1000 + 3, 2)):
            jr = np.asarray(jax.random.randint(k, shape, 1, n, dtype=jnp.int32))
            tr = prng.randint(_key(k), shape, 1, n, "cpu").numpy()
            np.testing.assert_array_equal(tr, jr)


def test_normal_within_three_ulp():
    k = jprng.tick_key(7, 3, 7)
    shape = (4096, 8)
    jn = np.asarray(jax.random.normal(k, shape))
    tn = prng.normal(_key(k), shape, "cpu").numpy()
    assert ulps(jn, tn).max() <= 3
