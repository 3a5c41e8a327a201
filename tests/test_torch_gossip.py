"""The port's ring exchange and gossip pass against the JAX package on
the CPU: bit-equal views, outputs and counters; and on the CPU the gossip
pass takes its plain twin, so no kernel launch is counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)

from consul_tpu.ops import gossip as jgossip
from consul_tpu.ops import rolls as jrolls
from consul_tpu.utils import prng as jprng
from consul_tpu_torch import kernels
from consul_tpu_torch.ops import gossip, rolls


@pytest.mark.parametrize("shape", ((97,), (97, 16), (97, 2)))
def test_pull_push_pull_multi_bit_equal(shape):
    rng = np.random.default_rng(5)
    mat = rng.integers(-1000, 1000, size=shape).astype(np.int32)
    offs = np.array([1, 40, 96, 97 * 3 + 5], np.int32)
    jm, tm = jnp.asarray(mat), torch.from_numpy(mat)
    toffs = torch.from_numpy(offs)
    for jv, tv in zip(jrolls.pull_multi(jm, jnp.asarray(offs)),
                      rolls.pull_multi(tm, toffs)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for d in offs:
        np.testing.assert_array_equal(rolls.pull(tm, torch.tensor(d)).numpy(),
                                      np.asarray(jrolls.pull(jm, int(d))))
        np.testing.assert_array_equal(rolls.push(tm, torch.tensor(d)).numpy(),
                                      np.asarray(jrolls.push(jm, int(d))))


def test_offsets_bit_equal():
    for tick in range(0, 50, 7):
        k = jprng.tick_key(7, tick, 2)
        kt = tuple(int(x) for x in np.asarray(k))
        np.testing.assert_array_equal(
            rolls.offsets(kt, 1_000_000, 3, "cpu").numpy(),
            np.asarray(jrolls.offsets(k, 1_000_000, 3)))


def test_sharded_path_is_not_ported():
    """Node-axis sharding across cards is not ported; a shard count on one
    device gives the one-block result, as the JAX block rotation does."""
    x = torch.arange(16) * 3
    for blocks in (2, 4):
        assert torch.equal(rolls.pull(x, 5, blocks=blocks), rolls.pull(x, 5))
        assert torch.equal(rolls.push(x, 5, blocks=blocks), rolls.push(x, 5))
        views = rolls.pull_multi(x, [1, 7], blocks=blocks)
        assert [v.tolist() for v in views] == \
            [rolls.pull(x, d).tolist() for d in (1, 7)]


@pytest.mark.parametrize("s", (32, 40))
@pytest.mark.parametrize("p_loss", (0.0, 0.01, 0.05, 0.5))
def test_disseminate_bit_equal(p_loss, s):
    rng = np.random.default_rng(11)
    n, g = 301, 3
    know = rng.random((n, s)) < 0.2
    sends = rng.integers(0, 6, size=(n, s)).astype(np.int8)
    sender_ok = rng.random(n) < 0.9
    receiver_ok = rng.random(n) < 0.9
    slot_active = rng.random(s) < 0.8
    offs = np.array([17, 150, 299], np.int32)
    key = jprng.tick_key(3, 21, 5)
    kt = tuple(int(x) for x in np.asarray(key))
    ref = jgossip.disseminate(jnp.asarray(offs), jnp.asarray(know),
                              jnp.asarray(sends), jnp.asarray(sender_ok),
                              jnp.asarray(receiver_ok),
                              jnp.asarray(slot_active), 12, p_loss=p_loss,
                              key=key)
    kernels.reset_launches()
    got = gossip.disseminate(torch.from_numpy(offs), torch.from_numpy(know),
                             torch.from_numpy(sends),
                             torch.from_numpy(sender_ok),
                             torch.from_numpy(receiver_ok),
                             torch.from_numpy(slot_active), 12,
                             p_loss=p_loss, key=kt)
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    for name in ("know", "sends_left", "newly"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("delivered", "served", "lost"):
        assert float(getattr(got, name)) == float(getattr(ref, name)), name
    assert float(got.delivered) > 0
    if p_loss > 0:
        assert float(got.lost) > 0


def test_loss_mask_is_jax_bernoulli():
    """The plain twin's loss mask (from the plain threefry hash, the bits
    K2 draws itself) equals jax.random.bernoulli on the same key."""
    key = jprng.tick_key(3, 21, 5)
    kt = tuple(int(x) for x in np.asarray(key))
    ref = np.asarray(jax.random.bernoulli(key, 1.0 - 0.3, (301, 3)))
    np.testing.assert_array_equal(gossip.loss_mask(kt, 0.3, 301, 3, "cpu").numpy(),
                                  ref)
    assert gossip.loss_mask(kt, 0.0, 301, 3, "cpu") is None


def test_disseminate_optional_outputs():
    """newly only when asked; the stamp and the counter add match the
    unfused steps on the same result."""
    rng = np.random.default_rng(12)
    n, s = 97, 16
    know = torch.from_numpy(rng.random((n, s)) < 0.3)
    sends = torch.from_numpy(rng.integers(0, 6, size=(n, s)).astype(np.int8))
    ones = torch.ones(n, dtype=torch.bool)
    args = (torch.tensor([5, 40, 90], dtype=torch.int32), know, sends, ones,
            ones, torch.ones(s, dtype=torch.bool), 9)
    learn = torch.from_numpy(rng.integers(-300, 300, size=(n, s)).astype(np.int16))
    ctr = torch.arange(7, dtype=torch.float32)
    full = gossip.disseminate(*args, p_loss=0.1, key=(1, 2))
    fused = gossip.disseminate(*args, p_loss=0.1, key=(1, 2), learn_tick=learn,
                               tick16=-7, ctr=ctr, want_newly=False)
    assert fused.newly is None and full.learn_tick is None and full.ctr is None
    assert torch.equal(fused.know, full.know)
    assert torch.equal(fused.sends_left, full.sends_left)
    assert torch.equal(fused.learn_tick, torch.where(full.newly, -7, learn))
    want = ctr.clone()
    want[4:] += torch.stack([full.delivered, full.served, full.lost])
    assert torch.equal(fused.ctr, want)
    assert float(full.delivered) > 0 and float(full.lost) > 0
