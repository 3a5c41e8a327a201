"""The port's SWIM detector against the JAX package on the CPU.

Per pass: a JAX state some 60 ticks after two kills (N=256, U=16, so
suspect and dead rumors exist; a lossy variant adds refutations) is
converted through numpy, each main-path pass runs on both packages, and
the outputs are compared: int/bool leaves bit-equal, float leaves
(bulk_heard, bulk_cov, r_coverage, ctr, coords) within rtol 1e-6.  A
mass kill drives the bulk death channel; a `swim.run` trajectory over
200 ticks after a kill compares every 20 ticks.  Config and params parity close the file.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import swim as jswim
from consul_tpu_torch import config, convert, kernels
from consul_tpu_torch.models import swim

STATES = {
    # name: (p_loss, seed, tick at which the state is taken)
    "suspect": (0.01, 3, 70),
    "dead": (0.01, 3, 80),
    "lossy": (0.2, 3, 70),
}


def _params(n=256, u=16, p_loss=0.01, seed=3):
    sim_j = jconfig.SimConfig(n_nodes=n, rumor_slots=u, p_loss=p_loss, seed=seed)
    sim_t = config.SimConfig(n_nodes=n, rumor_slots=u, p_loss=p_loss, seed=seed)
    return (jswim.make_params(jconfig.GossipConfig.lan(), sim_j),
            swim.make_params(config.GossipConfig.lan(), sim_t))


_step = jax.jit(jswim.step, static_argnums=0)
_run = jax.jit(jswim.run, static_argnums=(0, 2, 3))


@functools.lru_cache(maxsize=None)
def _reference(name, u=16):
    """(jax params, port params, jax state at the named tick) for a
    u-slot rumor table."""
    p_loss, seed, tick = STATES[name]
    jp, tp = _params(u=u, p_loss=p_loss, seed=seed)
    s = jswim.init_state(jp)
    s, _ = _run(jp, s, 10)
    s = jswim.kill(jswim.kill(s, 9), 77)
    for _ in range(tick // 10 - 1):
        s, _ = _run(jp, s, 10)
    return jp, tp, s


def _port(s):
    return convert.swim_state_from_numpy(jax_dict(s), device="cpu")


def _assert_state(js, ts, where="", rtol=1e-6):
    assert_leaves(jax_dict(js), convert.swim_state_to_numpy(ts), where=where,
                  rtol=rtol)


# The bulk channel's float32 marginals (bulk_heard, bulk_cov) are bit-equal
# to the JAX passes run op by op (test_mass_kill_drives_bulk_channel's
# pass checks), but XLA's fused, jitted tick rounds some of them
# differently from its own op-by-op execution (measured: up to 3.3e-6
# relative within a tick).  Trajectories against the jitted reference hold
# those leaves to this tolerance; every int/bool leaf stays bit-equal.
BULK_RTOL = 1e-5


def _assert_maps(jm, tm):
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# config and params parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (1, 64, 128, 256, 1024, 262144, 1_000_000))
def test_config_matches_reference(n):
    for name in ("lan", "wan"):
        jg, tg = getattr(jconfig.GossipConfig, name)(), \
            getattr(config.GossipConfig, name)()
        assert jconfig.dataclasses.asdict(jg) == config.dataclasses.asdict(tg)
        assert tg.probe_period_ticks == jg.probe_period_ticks
        assert tg.retransmit_limit(n) == jg.retransmit_limit(n)
        assert tg.suspicion_min_ticks(n) == jg.suspicion_min_ticks(n)
        assert tg.suspicion_max_ticks(n) == jg.suspicion_max_ticks(n)
        assert tg.confirm_k() == jg.confirm_k()
        assert tg.packet_msgs() == jg.packet_msgs()
    assert jconfig.dataclasses.asdict(jconfig.SimConfig(n_nodes=n)) == \
        config.dataclasses.asdict(config.SimConfig(n_nodes=n))


@pytest.mark.parametrize("n", (64, 128, 1024, 1_000_000))
def test_params_match_reference(n):
    jp, tp = _params(n=n, u=32)
    assert jconfig.dataclasses.asdict(jp) == config.dataclasses.asdict(tp)


@pytest.mark.parametrize("n,u", ((128, 16), (256, 16), (512, 8),
                                 (1024, 32), (1_000_000, 32)))
def test_timeout_table_matches_reference(n, u):
    jp, tp = _params(n=n, u=u)
    ref = np.asarray(jswim._suspicion_timeout_ticks(
        jp, jnp.arange(65, dtype=jnp.int32)))
    assert swim.timeout_table(tp) == tuple(int(v) for v in ref)


# ---------------------------------------------------------------------------
# per pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STATES))
def test_state_conversion_roundtrip(name):
    _, _, js = _reference(name)
    _assert_state(js, _port(js))


@pytest.mark.parametrize("name", sorted(STATES))
def test_maps_and_belief_queries(name):
    jp, tp, js = _reference(name)
    ts = _port(js)
    jm, tm = jswim._maps(jp, js), swim._maps(tp, ts)
    _assert_maps(jm, tm)
    for d in (1, 37, 255):
        a = jswim._believes_down_shift(jp, js, jm, jnp.int32(d), js.tick)
        b = swim._believes_down_shift(tp, ts, tm, torch.tensor(d), ts.tick)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for subject in (9, 77, 5):
        a = np.asarray(jswim.believed_down_fraction(jp, js, subject))
        b = swim.believed_down_fraction(tp, ts, subject).numpy()
        assert a.dtype == b.dtype and a.view(np.int32) == b.view(np.int32)


def test_top_k_ties_match_lax_top_k():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, size=1000).astype(np.int32)
    a_v, a_i = jax.lax.top_k(jnp.asarray(x), 8)
    b_v, b_i = swim._top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(b_v.numpy(), np.asarray(a_v))
    np.testing.assert_array_equal(b_i.numpy(), np.asarray(a_i))


@pytest.mark.parametrize("name", sorted(STATES))
def test_originate(name):
    jp, tp, js = _reference(name)
    ts = _port(js)
    rng = np.random.default_rng(4)
    n = jp.n_nodes
    want = np.where(rng.random(n) < 0.05, rng.integers(1, 3, n), 0).astype(np.int32)
    row_subject = np.where(rng.random(n) < 0.3, rng.integers(0, n, n), -1).astype(np.int32)
    for kind in (jswim.SUSPECT, jswim.DEAD):
        ja, (js_, jsl, jok) = jswim._originate(jp, js, jnp.asarray(want), kind,
                                               js.incarnation, jnp.asarray(row_subject))
        ta, (ts_, tsl, tok) = swim._originate(tp, ts, torch.from_numpy(want), kind,
                                              ts.incarnation, torch.from_numpy(row_subject))
        _assert_state(ja, ta, where=f"kind {kind}: ")
        for a, b in ((js_, ts_), (jsl, tsl), (jok, tok)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", sorted(STATES))
def test_probe_round(name):
    jp, tp, js = _reference(name)
    ts = _port(js)
    ja, jobs, jm = jswim._probe_round(jp, js, jswim._maps(jp, js))
    ta, tobs, tm = swim._probe_round(tp, ts, swim._maps(tp, ts))
    _assert_state(ja, ta)
    _assert_maps(jm, tm)
    assert int(tobs.shift) == int(jobs.shift)
    np.testing.assert_array_equal(tobs.acked.numpy(), np.asarray(jobs.acked))
    # probe RTTs carry the exponential draw's one-ulp log1p difference
    np.testing.assert_allclose(tobs.rtt_ms.numpy(), np.asarray(jobs.rtt_ms),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(STATES))
def test_suspicion_passes(name):
    jp, tp, js = _reference(name)
    ts = _port(js)
    jm = jswim._maps(jp, js)
    tm = swim._maps(tp, ts)
    ja, jconv = jswim._suspicion_expiry(jp, js)
    ta, tconv = swim._suspicion_expiry(tp, ts)
    _assert_state(ja, ta, where="slot expiry: ")
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    jm = jswim._maps_convert(jm, ja, jconv)
    tm = swim._maps_convert(tm, ta, tconv)
    _assert_maps(jm, tm)
    for shift in (3, 101):
        jd = jswim._dense_suspicion_expiry(jp, ja, jnp.int32(shift), jm)
        td = swim._dense_suspicion_expiry(tp, ta, torch.tensor(shift), tm)
        _assert_state(jd, td, where=f"dense expiry shift {shift}: ")


@pytest.mark.parametrize("name", sorted(STATES))
def test_refutation_expire_disseminate(name):
    jp, tp, js = _reference(name)
    ts = _port(js)
    _assert_state(jswim._refutation(jp, js), swim._refutation(tp, ts),
                  where="refutation: ")
    _assert_state(jswim._expire(jp, js), swim._expire(tp, ts),
                  where="expire: ")
    _assert_state(jswim._disseminate(jp, js), swim._disseminate(tp, ts),
                  where="disseminate: ")
    np.testing.assert_array_equal(
        swim.metrics_vector(tp, ts).numpy().view(np.int32),
        np.asarray(jswim.metrics_vector(jp, js)).view(np.int32))
    _assert_state(jswim.kill(js, 200), swim.kill(ts, 200), where="kill: ")


@pytest.mark.parametrize("u", (16, 40))
@pytest.mark.parametrize("p_loss", (0.0, 0.01, 0.5))
@pytest.mark.parametrize("name", sorted(STATES))
def test_disseminate_stamp_and_counters(name, p_loss, u):
    """K2's plain path with the loss draw from (key, threshold), the
    learn-tick stamp and the counter add: every leaf bit-equal to JAX
    `_disseminate`, the float32 ctr included.  The reference states are
    quiet by their tick (every budget spent), so half of each active
    slot's holders forget it and the rest get a full budget back: the
    pass then learns, serves and (with loss) loses cells."""
    jp, tp, js = _reference(name, u)
    jp = dataclasses.replace(jp, p_loss=p_loss)
    tp = dataclasses.replace(tp, p_loss=p_loss)
    d = jax_dict(js)
    rng = np.random.default_rng(23)
    know = d["know"] & (rng.random(d["know"].shape) < 0.5)
    d["know"] = know
    d["sends_left"] = np.where(know, jp.retransmit_limit, 0).astype(np.int8)
    js = js.replace(know=jnp.asarray(know),
                    sends_left=jnp.asarray(d["sends_left"]))
    ts = convert.swim_state_from_numpy(d, device="cpu")
    kernels.reset_launches()
    ja, ta = jswim._disseminate(jp, js), swim._disseminate(tp, ts)
    assert kernels.LAUNCHES == {k: 0 for k in kernels.KERNELS}
    _assert_state(ja, ta, where=f"p_loss {p_loss}, {u} slots: ", rtol=0)
    moved = (ta.ctr - ts.ctr).numpy()
    delivered, served, lost = moved[swim.CTR_GOSSIP_DELIVERED:][:3]
    assert delivered > 0 and served > 0
    assert (lost > 0) == (p_loss > 0)
    fresh = ta.learn_tick.numpy() != ts.learn_tick.numpy()
    assert fresh.sum() == delivered
    assert (ta.learn_tick.numpy()[fresh] == swim._t16(ts.tick)).all()


# ---------------------------------------------------------------------------
# the convergence monitor on crafted rumor tables
# ---------------------------------------------------------------------------

SUBJECT = 9


def _crafted(case):
    """A JAX state and its port twin with the rumor table about SUBJECT
    rewritten for one monitor case (from the "suspect" reference)."""
    jp, tp, js = _reference("suspect")
    d = jax_dict(js)
    n, u = d["know"].shape
    rng = np.random.default_rng(17)
    tick = int(d["tick"])
    # no rumor names the subject unless the case adds one
    d["r_subject"] = np.where(d["r_subject"] == SUBJECT, 200,
                              d["r_subject"]).astype(np.int32)
    d["committed_dead"] = d["committed_dead"].copy()
    d["committed_inc"] = d["committed_inc"].copy()
    d["bulk_member"] = d["bulk_member"].copy()
    d["bulk_cov"] = d["bulk_cov"].copy()

    def rumor(slot, kind, inc, holders, age):
        d["r_active"][slot] = True
        d["r_kind"][slot] = kind
        d["r_subject"][slot] = SUBJECT
        d["r_inc"][slot] = inc
        d["r_confirm"][slot] = 1
        d["know"][:, slot] = holders
        d["learn_tick"][:, slot] = np.asarray(
            swim._t16(tick) - age, np.int64).astype(np.int16)

    for k in ("r_active", "r_kind", "r_inc", "r_confirm", "know",
              "learn_tick"):
        d[k] = d[k].copy()
    half = rng.random(n) < 0.5
    old = np.where(rng.random(n) < 0.5, 500, 3)   # expired / fresh suspicion
    if case == "committed":
        d["committed_dead"][SUBJECT] = True
    elif case == "dead_rumor":
        rumor(0, jswim.DEAD, 0, rng.random(n) < 0.3, 0)
    elif case == "expired_unrefuted":
        rumor(0, jswim.SUSPECT, 0, half, old)
    elif case == "refuted_by_alive":
        rumor(0, jswim.SUSPECT, 0, half, old)
        rumor(1, jswim.ALIVE, 1, rng.random(n) < 0.5, 0)
    elif case == "refuted_by_committed_inc":
        rumor(0, jswim.SUSPECT, 0, half, old)
        d["committed_inc"][SUBJECT] = 1
    elif case == "bulk_floor":
        d["bulk_member"][SUBJECT] = True
        d["bulk_cov"][SUBJECT] = np.float32(0.7)
    else:
        raise ValueError(case)
    js = js.replace(**{k: jnp.asarray(v) for k, v in d.items() if k != "tick"})
    return jp, tp, js, convert.swim_state_from_numpy(d, device="cpu")


@pytest.mark.parametrize("case", ("committed", "dead_rumor",
                                  "expired_unrefuted", "refuted_by_alive",
                                  "refuted_by_committed_inc", "bulk_floor"))
def test_believed_down_crafted_tables(case):
    """K3's plain twin, from the raw rumor-table leaves, bit-equal to JAX
    `believed_down_fraction` on each case, with the case's effect."""
    jp, tp, js, ts = _crafted(case)
    a = np.asarray(jswim.believed_down_fraction(jp, js, SUBJECT))
    kernels.reset_launches()
    b = swim.believed_down_fraction(tp, ts, SUBJECT).numpy()
    c = swim.believed_down_fraction_plain(tp, ts, SUBJECT).numpy()
    assert kernels.LAUNCHES == {k: 0 for k in kernels.KERNELS}
    assert a.dtype == b.dtype == c.dtype == np.float32
    assert a.view(np.int32) == b.view(np.int32) == c.view(np.int32)
    frac = float(b)
    expect = {"committed": lambda f: f == 1.0,
              "dead_rumor": lambda f: 0.2 < f < 0.4,
              "expired_unrefuted": lambda f: 0.15 < f < 0.35,
              "refuted_by_alive": lambda f: 0.05 < f < 0.2,
              "refuted_by_committed_inc": lambda f: f == 0.0,
              "bulk_floor": lambda f: f == float(np.float32(0.7))}[case]
    assert expect(frac), (case, frac)


@pytest.mark.parametrize("name", sorted(STATES))
def test_whole_ticks(name):
    jp, tp, js = _reference(name)
    ts = _port(js)
    for _ in range(6):               # one probe tick, then gossip-only ticks
        js = _step(jp, js)
        ts = swim.step(tp, ts)
        _assert_state(js, ts, where=f"tick {ts.tick}: ")


def test_refutations_happen_in_lossy_state():
    jp, tp, js = _reference("lossy")
    assert int(np.asarray(js.incarnation).max()) > 0
    kinds = np.asarray(js.r_kind)[np.asarray(js.r_active)]
    assert (kinds == jswim.ALIVE).any() and (kinds == jswim.SUSPECT).any()


# ---------------------------------------------------------------------------
# mass kill: the bulk death channel
# ---------------------------------------------------------------------------

def test_mass_kill_drives_bulk_channel():
    jp, tp = _params(n=512, u=8, p_loss=0.01, seed=9)
    js = jswim.init_state(jp)
    js, _ = _run(jp, js, 10)
    mask = np.zeros(512, bool)
    mask[np.random.default_rng(1).choice(512, 40, replace=False)] = True
    js = jswim.kill_mask(js, jnp.asarray(mask))
    ts = _port(js)
    for chunk in range(6):           # to tick 70: the victims' timers run
        js, _ = _run(jp, js, 10)
        ts, _ = swim.run(tp, ts, 10)
    _assert_state(js, ts, where="tick 70: ")
    bulk_ticks = 0
    for _ in range(12):              # the bulk channel fills and drains
        if np.asarray(js.bulk_member).any():
            bulk_ticks += 1
            jb = jswim._bulk_commit(jp, jswim._bulk_disseminate(jp, js))
            tb = swim._bulk_commit(tp, swim._bulk_disseminate(tp, ts))
            _assert_state(jb, tb, where=f"bulk pass, tick {ts.tick}: ",
                          rtol=0)
        js, ts = _step(jp, js), swim.step(tp, ts)
        _assert_state(js, ts, where=f"tick {ts.tick}: ", rtol=BULK_RTOL)
        # continue from the same reference state, so each tick's float
        # rounding is judged on its own rather than compounded
        ts = _port(js)
    assert bulk_ticks >= 3
    for _ in range(8):
        js, _ = _run(jp, js, 10)
        ts, _ = swim.run(tp, ts, 10)
    _assert_state(js, ts, where=f"tick {ts.tick}: ", rtol=BULK_RTOL)
    assert np.asarray(js.committed_dead)[mask].all()


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------

def test_swim_run_trajectory():
    jp, tp = _params(n=256, u=16, p_loss=0.01, seed=3)
    js = jswim.init_state(jp)
    ts = swim.init_state(tp, device="cpu")
    _assert_state(js, ts, where="init: ")
    js, _ = _run(jp, js, 10)
    ts, _ = swim.run(tp, ts, 10)
    js, ts = jswim.kill(js, 9), swim.kill(ts, 9)
    for chunk in range(10):
        js, jf = _run(jp, js, 20, 9)
        ts, tf = swim.run(tp, ts, 20, 9)
        _assert_state(js, ts, where=f"tick {ts.tick}: ")
        np.testing.assert_array_equal(tf.numpy().view(np.int32),
                                      np.asarray(jf).view(np.int32))
    assert float(tf[-1]) > 0.999
    assert math.isclose(float(np.asarray(js.ctr)[swim.CTR_SUSPICIONS]),
                        float(ts.ctr[swim.CTR_SUSPICIONS]))
