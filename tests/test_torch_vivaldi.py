"""The port's standalone Vivaldi solver against the JAX package on the CPU.

`prng.other_nodes` is bit-equal (P1).  `observe` (both its row-aligned
and its scatter path), `synthetic_rtt`, `sim_step` and `relative_error`
are held per call (P2) on states made from a seed with numpy, with float
leaves within a scale-relative bound, max|port - ref| <= 1e-5 * max|ref|:
the norms, means and the normal draw's erf_inv round a few ulp apart in
XLA and PyTorch (the same bound as tests/test_torch_serf.py).  The
median is exact on equal inputs (an even count takes (lo + hi) * 0.5 as
jnp.median does), `sort_by_distance` is equal on equal inputs, and the
assertions of tests/test_vivaldi.py run on the port (P4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_dict

from consul_tpu.models import vivaldi as jviv
from consul_tpu.utils import prng as jprng
from consul_tpu_torch import convert
from consul_tpu_torch.models import vivaldi
from consul_tpu_torch.utils import prng

SCALE_RTOL = 1e-5


def _close(ref, got, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, what
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= SCALE_RTOL * max(np.abs(ref).max(), 1e-30), \
        f"{what}: {err} vs scale {np.abs(ref).max()}"


def _state(n, dims, seed, adj_index=3):
    """A mid-run-looking state from numpy: coords of tens of ms, some
    colocated rows (the random-direction branch), errors in (0, 1.5]."""
    rng = np.random.default_rng(seed)
    coords = (rng.standard_normal((n, dims)) * 0.02).astype(np.float32)
    coords[1] = coords[0]                    # colocated with node 0
    return {"coords": coords,
            "height": (rng.random(n) * 1e-3 + 1e-5).astype(np.float32),
            "error": (rng.random(n) * 1.4 + 0.05).astype(np.float32),
            "adj_window": (rng.standard_normal((n, 20)) * 1e-4
                           ).astype(np.float32),
            "adj_index": np.int32(adj_index),
            "adjustment": (rng.standard_normal(n) * 1e-4).astype(np.float32)}


def _jax_state(d):
    return jviv.VivaldiState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_state(js, ts, where):
    ref = jax_dict(js)
    got = convert.vivaldi_state_to_numpy(ts)
    assert int(got["adj_index"]) == int(ref["adj_index"]), where
    for name in ("coords", "height", "error", "adj_window", "adjustment"):
        _close(ref[name], got[name], f"{where}{name}")


@pytest.mark.parametrize("n,shape", [(2, (2,)), (24, (24,)), (100, (100, 3)),
                                     (4096, (4096,))])
def test_other_nodes_bit_equal(n, shape):
    key = prng.tick_key(11, 7, 8)
    ref = np.asarray(jprng.other_nodes(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(11), 8), 7), n, shape))
    got = prng.other_nodes(key, n, shape, "cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    rows = np.arange(n).reshape((n,) + (1,) * (len(shape) - 1))
    assert not (got == rows).any()


@pytest.mark.parametrize("aligned", [True, False])
def test_observe_matches_reference(aligned):
    n, dims = 96, 8
    d = _state(n, dims, seed=1)
    rng = np.random.default_rng(2)
    rtt = (rng.random(n) * 0.05).astype(np.float32)
    rtt[5] = 0.0                                  # floored at 1e-6
    mask = rng.random(n) < 0.8
    jp = jviv.VivaldiParams(n_nodes=n, dims=dims, seed=4)
    tp = vivaldi.VivaldiParams(n_nodes=n, dims=dims, seed=4)
    if aligned:
        src = None
        dst = ((np.arange(n) + 17) % n).astype(np.int32)
        dst[1] = 0                                # colocated pair
    else:
        src = rng.permutation(n)[:64].astype(np.int32)
        src[0], src[1] = 1, 7
        dst = rng.integers(0, n, 64).astype(np.int32)
        dst[0] = 0                                # colocated pair
        rtt, mask = rtt[:64], mask[:64]
    js = jviv.observe(jp, _jax_state(d), None if src is None
                      else jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(rtt), jnp.asarray(mask))
    ts = vivaldi.observe(tp, convert.vivaldi_state_from_numpy(d, "cpu"),
                         None if src is None else torch.from_numpy(src),
                         torch.from_numpy(dst), torch.from_numpy(rtt),
                         torch.from_numpy(mask))
    _assert_state(js, ts, "observe: ")


def test_observe_without_mask_matches_reference():
    n = 32
    d = _state(n, 4, seed=3)
    src = np.arange(n, dtype=np.int32)[::-1].copy()
    dst = ((src + 5) % n).astype(np.int32)
    rtt = np.full(n, 0.01, np.float32)
    jp = jviv.VivaldiParams(n_nodes=n, dims=4, seed=9)
    tp = vivaldi.VivaldiParams(n_nodes=n, dims=4, seed=9)
    js = jviv.observe(jp, _jax_state(d), jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(rtt))
    ts = vivaldi.observe(tp, convert.vivaldi_state_from_numpy(d, "cpu"),
                         torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(rtt))
    _assert_state(js, ts, "observe (no mask): ")


def test_synthetic_rtt_matches_reference():
    n = 200
    true = (np.random.default_rng(5).random((n, 2)) * 0.06).astype(np.float32)
    src = np.arange(n, dtype=np.int32)
    dst = ((src + 3) % n).astype(np.int32)
    dst[4] = 4                                    # zero distance: the floor
    key = prng.tick_key(3, 2, 8)
    jkey = jprng.tick_key(3, 2, 8)
    for jitter in (0.02, 0.0):
        ref = jviv.synthetic_rtt(jnp.asarray(true), jnp.asarray(src),
                                 jnp.asarray(dst), jkey, jitter=jitter)
        got = vivaldi.synthetic_rtt(torch.from_numpy(true),
                                    torch.from_numpy(src),
                                    torch.from_numpy(dst), key, jitter=jitter)
        _close(ref, got.numpy(), f"synthetic_rtt jitter={jitter}")


def test_sim_step_matches_reference_over_ticks():
    """Ten ticks of the standalone solver from the zero state and from a
    numpy state, each tick held (the first ticks take the colocated
    random-direction branch for every node)."""
    n, dims = 128, 8
    true = (np.random.default_rng(6).random((n, 2)) * 0.06).astype(np.float32)
    jp = jviv.VivaldiParams(n_nodes=n, dims=dims, seed=2)
    tp = vivaldi.VivaldiParams(n_nodes=n, dims=dims, seed=2)
    step = jax.jit(jviv.sim_step, static_argnums=0)
    for start in ("zero", "numpy"):
        if start == "zero":
            js, ts = jviv.init_state(jp), vivaldi.init_state(tp, device="cpu")
        else:
            d = _state(n, dims, seed=7, adj_index=0)
            js = _jax_state(d)
            ts = convert.vivaldi_state_from_numpy(d, "cpu")
        for t in range(10):
            js = step(jp, jnp.asarray(true), js, t)
            ts = vivaldi.sim_step(tp, torch.from_numpy(true), ts, t)
            _assert_state(js, ts, f"{start} tick {t}: ")


@pytest.mark.parametrize("n", [64, 128])
def test_relative_error_matches_reference(n):
    """An even n: the median averages the two middle ratios."""
    dims = 4
    true = (np.random.default_rng(n).random((n, 2)) * 0.06).astype(np.float32)
    d = _state(n, dims, seed=n + 1)
    jp = jviv.VivaldiParams(n_nodes=n, dims=dims, seed=5)
    tp = vivaldi.VivaldiParams(n_nodes=n, dims=dims, seed=5)
    for tick in (0, 1, 9):
        ref = float(jviv.relative_error(jp, jnp.asarray(true), _jax_state(d),
                                        tick))
        got = float(vivaldi.relative_error(
            tp, torch.from_numpy(true),
            convert.vivaldi_state_from_numpy(d, "cpu"), tick))
        assert abs(got - ref) <= SCALE_RTOL * abs(ref), (tick, got, ref)


@pytest.mark.parametrize("shape,dim", [((4,), -1), ((7,), -1), ((3, 4, 6), 1),
                                       ((2, 2, 4), -1)])
def test_median_is_jnp_median(shape, dim):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    ref = np.asarray(jnp.median(jnp.asarray(x), axis=dim))
    got = vivaldi.median(torch.from_numpy(x), dim).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sort_by_distance_equal():
    n = 300
    d = _state(n, 8, seed=8)
    d["coords"][10] = d["coords"][20]        # exact ties keep index order
    d["height"][10] = d["height"][20]
    d["adjustment"][10] = d["adjustment"][20]
    for origin in (0, 10, n - 1):
        ref = np.asarray(jviv.sort_by_distance(_jax_state(d), origin))
        got = vivaldi.sort_by_distance(
            convert.vivaldi_state_from_numpy(d, "cpu"), origin).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# P4: tests/test_vivaldi.py's assertions on the port
# ---------------------------------------------------------------------------

def _converge(n=256, ticks=400, seed=0, dims=4):
    params = vivaldi.VivaldiParams(n_nodes=n, dims=dims, seed=seed)
    true = prng.uniform(prng.PRNGKey(seed), (n, 2), "cpu") * 0.060
    s = vivaldi.init_state(params, device="cpu")
    for t in range(ticks):
        s = vivaldi.sim_step(params, true, s, t)
    return params, true, s


def test_spring_relaxation_converges():
    params, true, s = _converge()
    err0 = float(vivaldi.relative_error(
        params, true, vivaldi.init_state(params, device="cpu"), 0))
    err = float(vivaldi.relative_error(params, true, s, 1))
    assert err < 0.15, f"median relative RTT error {err}"
    assert err < err0 / 3
    assert float(vivaldi.median(s.error)) < 0.4


def test_rtt_sort_orders_by_true_distance():
    params, true, s = _converge(n=128, ticks=400, seed=1)
    order = vivaldi.sort_by_distance(s, 0).numpy()
    true = true.numpy()
    true_d = np.linalg.norm(true - true[0], axis=-1)
    top = set(order[:10].tolist()) - {0}
    true_top = set(np.argsort(true_d)[:30].tolist())
    assert len(top & true_top) >= 7


def test_estimate_rtt_positive_and_symmetricish():
    params, true, s = _converge(n=64, ticks=200, seed=2)
    src = torch.arange(64, dtype=torch.int32)
    dst = (src + 13) % 64
    ab = vivaldi.estimate_rtt(s, src, dst).numpy()
    ba = vivaldi.estimate_rtt(s, dst, src).numpy()
    assert (ab > 0).all()
    np.testing.assert_allclose(ab, ba, rtol=1e-5)
