"""The port's threefry streams against jax.random (jax 0.9,
jax_threefry_partitionable=True — the reference streams depend on both).

Every draw goes through the port's API (`prng.bits`, ..., `prng.draw`),
which on the CPU runs the plain twins of kernel K1's modes.  Keys, raw
bits, uniform, bernoulli and randint are bit-equal.  Two
transforms go through a float function whose rounding differs between
XLA-CPU and PyTorch-CPU by one ulp on some inputs:

  * exponential = -log1p(-u): <= 1 ulp (measured: ~7% of 1M draws at 1);
  * normal = sqrt(2) * erf_inv(u): the port evaluates XLA's own float32
    erf_inv polynomial, whose inner log1p carries that ulp; <= 3 ulp
    (measured maximum 3 over 8M draws; torch.erfinv would be ~90 off).

Neither feeds the detector's int/bool state: exponential scales probe
RTTs far inside the probe timeout, normal only orients Vivaldi springs.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("span", (2 ** 16 - 3, 2 ** 16 + 1))
def test_randint_bit_equal_at_the_multiplier_wrap(span):
    """randint's multiplier (2^16 mod span)^2 mod 2^32 mod span wraps to 0
    for spans above 2^16 (2^32 mod 2^32), and is not 0 just below."""
    assert (prng._randint_span(-5, span - 5)[1] == 0) == (span > 2 ** 16)
    for tick in (0, 77):
        k = jprng.tick_key(3, tick, 4)
        shape = (513, 3)
        jr = np.asarray(jax.random.randint(k, shape, -5, span - 5,
                                           dtype=jnp.int32))
        tr = prng.randint(_key(k), shape, -5, span - 5, "cpu").numpy()
        np.testing.assert_array_equal(tr, jr)


def _probe_draws(n: int, k: int = 3):
    """The draws of one probe round, as swim._probe_round makes them."""
    kt = prng.tick_key(7, 40, 1)
    k_off, k_direct, k_leg, k_rtt, k_lha = prng.split(kt, 5)
    return [prng.Draw("randint", k_off, (1 + k,), 1, n),
            prng.Draw("exponential", k_rtt, (n,)),
            prng.Draw("uniform", k_direct, (n,)),
            prng.Draw("uniform", k_lha, (n,)),
            *[prng.Draw("uniform", key, (n, k)) for key in prng.split(k_leg, 3)],
            prng.Draw("normal", k_rtt, (n, 8)),
            prng.Draw("bits", k_lha, (n, 2)),
            prng.Draw("uniform", k_off, (n,), -2.0, 3.5)]


def test_draw_equals_the_same_draws_one_by_one():
    """prng.draw (one K1 launch per 8 draws on a card) gives each draw's
    tensor exactly as the single-draw functions do."""
    draws = _probe_draws(1000)
    single = {"bits": lambda d: prng.bits(d.key, d.shape, "cpu"),
              "uniform": lambda d: prng.uniform(d.key, d.shape, "cpu",
                                                d.minval, d.maxval),
              "exponential": lambda d: prng.exponential(d.key, d.shape, "cpu"),
              "normal": lambda d: prng.normal(d.key, d.shape, "cpu"),
              "randint": lambda d: prng.randint(d.key, d.shape, d.minval,
                                                d.maxval, "cpu")}
    got = prng.draw(draws, "cpu")
    assert len(got) == len(draws) > 8
    for d, t in zip(draws, got):
        want = single[d.kind](d)
        assert t.dtype == want.dtype and tuple(t.shape) == d.shape, d
        assert torch.equal(t.view(torch.int32), want.view(torch.int32)), d


def test_draw_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        prng.draw([prng.Draw("gamma", (0, 1), (3,))], "cpu")


def test_kernel_constants_are_the_plain_twins():
    """The erf_inv coefficients and sqrt(2) of K1's normal finish
    (common.cuh, shared by threefry.cu and vivaldi.cu) are the float32 bit
    patterns of the plain twin's constants."""
    text = (Path(prng.__file__).parents[1] / "kernels" / "csrc"
            / "common.cuh").read_text()
    bits32 = lambda x: int(np.float32(x).view(np.uint32))  # noqa: E731
    for name, coefs in (("kLt5", prng._ERFINV_LT5), ("kGe5", prng._ERFINV_GE5)):
        body = re.search(name + r"\[9\] = \{(.*?)\};", text, re.S).group(1)
        assert [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body)] == \
            [bits32(c) for c in coefs], name
    assert f"__uint_as_float(0x{bits32(np.sqrt(2)):08x}u)" in text
