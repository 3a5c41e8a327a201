"""The port's nemesis (chaos) build against the JAX package on the CPU.

P2, per chaos pass: a chaos-build JAX state at N=256, U=16 (two kills,
then a 25% partition and a 10% degraded set from tick 20), taken at tick
70, is converted through numpy; `_probe_round`,
`_dense_suspicion_expiry`, `_disseminate`, `_bulk_disseminate` (on a
crafted bulk channel) and `ops.gossip.disseminate` itself run on both
packages.  Int/bool leaves are bit-equal; the bulk floats of one pass
are bit-equal too (rtol 0, both run op by op), every other float leaf
within rtol 1e-6.  P3: chaos `swim.run` at N=128, compared tick by tick
while faults switch between chunks.  Harness parity: the SWIM halves of
the four nemesis scenarios at N=128 against the JAX scenarios' detail,
violations and flight rows."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, consul_hooks, jax_dict

from consul_tpu import chaos as jchaos
from consul_tpu import config as jconfig
from consul_tpu import flight
from consul_tpu.ops import gossip as jgossip
from consul_tpu.models import swim as jswim
from consul_tpu.utils import prng as jprng
from consul_tpu_torch import chaos, config, convert, kernels
from consul_tpu_torch.models import swim
from consul_tpu_torch.ops import gossip

# The bulk marginals under XLA's fused, jitted tick: see
# test_torch_swim.BULK_RTOL (every int/bool leaf stays bit-equal).
BULK_RTOL = 1e-5


def _params(n=256, u=16, p_loss=0.01, seed=3, chaos_on=True):
    sim = dict(n_nodes=n, rumor_slots=u, p_loss=p_loss, seed=seed,
               chaos=chaos_on)
    return (jswim.make_params(jconfig.GossipConfig.lan(),
                              jconfig.SimConfig(**sim)),
            swim.make_params(config.GossipConfig.lan(),
                             config.SimConfig(**sim)))


def _faults(n):
    """(group [N] int16: a seeded quarter of the nodes in group 1, so any
    ring shift crosses the cut; ok [N] float32: every 10th node at 0.55)."""
    grp = (np.random.default_rng(4).random(n) < 0.25).astype(np.int16)
    ok = np.where(np.arange(n) % 10 == 5, np.float32(0.55),
                  np.float32(1.0)).astype(np.float32)
    return grp, ok


_step = jax.jit(jswim.step, static_argnums=0)
_run = jax.jit(jswim.run, static_argnums=(0, 2, 3))


@functools.lru_cache(maxsize=None)
def _reference(p_loss=0.01):
    """(jax params, port params, the chaos JAX state at tick 70)."""
    jp, tp = _params(p_loss=p_loss)
    s = jswim.init_state(jp)
    s, _ = _run(jp, s, 10)
    s = jswim.kill(jswim.kill(s, 9), 77)
    s, _ = _run(jp, s, 10)
    grp, ok = _faults(jp.n_nodes)
    s = s.replace(chaos_grp=jnp.asarray(grp), chaos_ok=jnp.asarray(ok))
    for _ in range(5):
        s, _ = _run(jp, s, 10)
    return jp, tp, s


def _port(s):
    return convert.swim_state_from_numpy(jax_dict(s), device="cpu")


def _assert_state(js, ts, where="", rtol=1e-6):
    assert_leaves(jax_dict(js), convert.swim_state_to_numpy(ts), where=where,
                  rtol=rtol)


def test_chaos_build_makes_params_like_the_reference():
    for n in (128, 256, 1_000_000):
        jp, tp = _params(n=n, u=32)
        assert tp.chaos
        assert jconfig.dataclasses.asdict(jp) == \
            config.dataclasses.asdict(tp)


def test_reference_state_has_partition_and_rumors():
    """The P2 state holds what the chaos passes gate: both groups, a
    degraded set, suspect or dead rumors, live members on both sides."""
    _, _, js = _reference()
    d = jax_dict(js)
    assert set(np.unique(d["chaos_grp"])) == {0, 1}
    assert (d["chaos_ok"] < 1).sum() == 26
    kinds = d["r_kind"][d["r_active"]]
    assert ((kinds == jswim.SUSPECT) | (kinds == jswim.DEAD)).any()


@pytest.mark.parametrize("p_loss", (0.01, 0.2))
def test_probe_round_chaos(p_loss):
    """Direct legs gated by same_t, relay legs by same_r and same_rt, the
    delivery rate times chaos_ok: the whole round bit-equal."""
    jp, tp, js = _reference()
    jp = dataclasses.replace(jp, p_loss=p_loss)
    tp = dataclasses.replace(tp, p_loss=p_loss)
    ts = _port(js)
    ja, jobs, jm = jswim._probe_round(jp, js, jswim._maps(jp, js))
    ta, tobs, tm = swim._probe_round(tp, ts, swim._maps(tp, ts))
    _assert_state(ja, ta)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tobs.acked.numpy(), np.asarray(jobs.acked))
    # the partition shows: some probes cross groups and fail
    grp = np.asarray(js.chaos_grp)
    d = int(tobs.shift)
    crossing = grp != np.roll(grp, -d)
    assert crossing.any()
    assert not tobs.acked.numpy()[crossing].any()


def _expired_timers(js):
    """js with the dense timers of 24 up-or-down subjects long expired, so
    the round wants more dead slots than alloc_cap gives (the overflow a
    non-chaos build hands to the bulk channel)."""
    d = jax_dict(js)
    sus = d["sus_start"].copy()
    conf = d["sus_confirm"].copy()
    up = d["up"].copy()
    subjects = np.arange(5, 245, 10)
    up[subjects] = False
    sus[subjects] = 0                # started at tick 0, expired by 70
    conf[subjects] = 3
    return js.replace(sus_start=jnp.asarray(sus), sus_confirm=jnp.asarray(conf),
                      up=jnp.asarray(up))


@pytest.mark.parametrize("shift", (3, 101))
def test_dense_suspicion_expiry_chaos_disables_overflow(shift):
    jp, tp, js = _reference()
    js = _expired_timers(js)
    ts = _port(js)
    jm, tm = jswim._maps(jp, js), swim._maps(tp, ts)
    jd = jswim._dense_suspicion_expiry(jp, js, jnp.int32(shift), jm)
    td = swim._dense_suspicion_expiry(tp, ts, torch.tensor(shift), tm)
    _assert_state(jd, td, where=f"shift {shift}: ")
    assert not td.bulk_member.any()
    # the same round without the nemesis does overflow into the bulk channel
    jp0, tp0 = dataclasses.replace(jp, chaos=False), \
        dataclasses.replace(tp, chaos=False)
    td0 = swim._dense_suspicion_expiry(tp0, ts, torch.tensor(shift), tm)
    _assert_state(jswim._dense_suspicion_expiry(jp0, js, jnp.int32(shift), jm),
                  td0, where=f"non-chaos shift {shift}: ")
    assert td0.bulk_member.any()


def _fresh_budgets(js, jp, seed=23):
    """Half of each active slot's holders forget it, the rest get a full
    budget, so the gossip pass learns, serves and loses cells."""
    d = jax_dict(js)
    rng = np.random.default_rng(seed)
    know = d["know"] & (rng.random(d["know"].shape) < 0.5)
    sends = np.where(know, jp.retransmit_limit, 0).astype(np.int8)
    return js.replace(know=jnp.asarray(know), sends_left=jnp.asarray(sends))


@pytest.mark.parametrize("p_loss", (0.0, 0.01, 0.3))
def test_disseminate_chaos(p_loss):
    """swim._disseminate with group and node_ok: every leaf bit-equal, the
    gossip counters (lost included) too."""
    jp, tp, js = _reference()
    jp = dataclasses.replace(jp, p_loss=p_loss)
    tp = dataclasses.replace(tp, p_loss=p_loss)
    js = _fresh_budgets(js, jp)
    ts = _port(js)
    kernels.reset_launches()
    ja, ta = jswim._disseminate(jp, js), swim._disseminate(tp, ts)
    assert kernels.LAUNCHES == {k: 0 for k in kernels.KERNELS}
    _assert_state(ja, ta, where=f"p_loss {p_loss}: ", rtol=0)
    moved = (ta.ctr - ts.ctr).numpy()[swim.CTR_GOSSIP_DELIVERED:]
    assert moved[0] > 0 and moved[1] > 0 and moved[2] > 0


@pytest.mark.parametrize("s", (16, 40))
@pytest.mark.parametrize("hooks", ("group", "node_ok", "both"))
@pytest.mark.parametrize("p_loss", (0.0, 0.01, 0.5))
def test_gossip_disseminate_chaos_bit_equal(p_loss, hooks, s):
    """ops.gossip.disseminate's chaos branch on random rows: the draw is
    taken even at p_loss 0, severed contacts are not lost."""
    rng = np.random.default_rng(31)
    n, g = 301, 3
    know = rng.random((n, s)) < 0.2
    sends = rng.integers(0, 6, size=(n, s)).astype(np.int8)
    sender_ok = rng.random(n) < 0.9
    receiver_ok = rng.random(n) < 0.9
    slot_active = rng.random(s) < 0.8
    group = (rng.random(n) < 0.3).astype(np.int16)
    node_ok = np.where(rng.random(n) < 0.2, np.float32(0.4),
                       np.float32(1.0)).astype(np.float32)
    offs = np.array([17, 150, 299], np.int32)
    key = jprng.tick_key(3, 21, 5)
    kt = tuple(int(x) for x in np.asarray(key))
    kw = {"group": group if hooks in ("group", "both") else None,
          "node_ok": node_ok if hooks in ("node_ok", "both") else None}
    ref = jgossip.disseminate(
        jnp.asarray(offs), jnp.asarray(know), jnp.asarray(sends),
        jnp.asarray(sender_ok), jnp.asarray(receiver_ok),
        jnp.asarray(slot_active), 12, p_loss=p_loss, key=key,
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = gossip.disseminate(
        torch.from_numpy(offs), torch.from_numpy(know), torch.from_numpy(sends),
        torch.from_numpy(sender_ok), torch.from_numpy(receiver_ok),
        torch.from_numpy(slot_active), 12, p_loss=p_loss, key=kt,
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()})
    for name in ("know", "sends_left", "newly"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("delivered", "served", "lost"):
        assert float(getattr(got, name)) == float(getattr(ref, name)), name
    assert float(got.delivered) > 0
    # chaos draws even without loss: a degraded contact can drop
    if hooks != "group" or p_loss > 0:
        assert float(got.lost) > 0


def test_gossip_chaos_needs_a_key_like_the_reference():
    """Without a key the JAX branch (`chaotic and key is not None`) skips
    the chaos masks entirely; so does the port."""
    rng = np.random.default_rng(5)
    n, s = 97, 16
    know = torch.from_numpy(rng.random((n, s)) < 0.3)
    sends = torch.from_numpy(rng.integers(0, 6, size=(n, s)).astype(np.int8))
    ones = torch.ones(n, dtype=torch.bool)
    args = (torch.tensor([5, 40, 90], dtype=torch.int32), know, sends, ones,
            ones, torch.ones(s, dtype=torch.bool), 9)
    plain = gossip.disseminate(*args)
    gated = gossip.disseminate(*args, group=torch.ones(n, dtype=torch.int16),
                               node_ok=torch.zeros(n))
    assert torch.equal(plain.know, gated.know)
    assert float(gated.lost) == 0


def _bulk_state(js, n_bulk=30):
    """js with a bulk channel mid-flight: n_bulk down subjects at mixed
    coverage and fractional heard counts on every node."""
    d = jax_dict(js)
    rng = np.random.default_rng(8)
    n = d["up"].shape[0]
    subjects = rng.choice(n, n_bulk, replace=False)
    bm = np.zeros(n, bool)
    bm[subjects] = True
    up = d["up"] & ~bm
    cov = np.where(bm, rng.random(n).astype(np.float32) * 0.9, 0.0)
    heard = (rng.random(n) * n_bulk).astype(np.float32)
    return js.replace(up=jnp.asarray(up), bulk_member=jnp.asarray(bm),
                      bulk_cov=jnp.asarray(cov.astype(np.float32)),
                      bulk_heard=jnp.asarray(heard))


def test_bulk_disseminate_chaos_gates_views():
    """The chaos views: cross-group contacts carry nothing, the rest scale
    by (v * ok_sender) * ok_receiver — bit-equal, op by op.  The commit
    that follows sums the committed subjects' coverage over [N] in float32
    (`removed`), whose summation order differs between XLA and torch: with
    many subjects committing in one pass, bulk_heard lands within one ulp
    (BULK_RTOL; queue C), every int/bool leaf bit-equal."""
    jp, tp, js = _reference()
    js = _bulk_state(js)
    ts = _port(js)
    jb, tb = jswim._bulk_disseminate(jp, js), swim._bulk_disseminate(tp, ts)
    _assert_state(jb, tb, rtol=0)
    jc, tc = jswim._bulk_commit(jp, jb), swim._bulk_commit(tp, tb)
    _assert_state(jc, tc, rtol=BULK_RTOL)
    assert tc.committed_dead.sum() > tb.committed_dead.sum()
    # the gate moves the result: the same pass without the nemesis differs
    tp0 = dataclasses.replace(tp, chaos=False)
    t0 = swim._bulk_disseminate(tp0, ts)
    assert not torch.equal(t0.bulk_heard, tb.bulk_heard)


def test_whole_chaos_ticks():
    jp, tp, js = _reference()
    ts = _port(js)
    for _ in range(6):               # one probe tick, then gossip-only ticks
        js = _step(jp, js)
        ts = swim.step(tp, ts)
        _assert_state(js, ts, where=f"tick {ts.tick}: ")


def test_chaos_run_trajectory_with_faults_between_chunks():
    """P3: chaos swim.run at N=128 from init; kills, a partition and a
    degraded set at tick 20, the heal at tick 80, calm at 100; int/bool
    leaves bit-equal every tick for 120 ticks."""
    jp, tp = _params(n=128, seed=7)
    js = jswim.init_state(jp)
    ts = swim.init_state(tp, device="cpu")
    grp, ok = _faults(128)
    mask = np.zeros(128, bool)
    mask[[3, 50, 77]] = True
    for chunk in range(12):
        if chunk == 2:
            js = jswim.kill_mask(js.replace(chaos_grp=jnp.asarray(grp),
                                            chaos_ok=jnp.asarray(ok)),
                                 jnp.asarray(mask))
            ts = swim.kill_mask(ts.replace(chaos_grp=torch.from_numpy(grp),
                                           chaos_ok=torch.from_numpy(ok)),
                                torch.from_numpy(mask))
        if chunk == 8:
            js = js.replace(chaos_grp=jnp.zeros(128, jnp.int16))
            ts = ts.replace(chaos_grp=torch.zeros(128, dtype=torch.int16))
        if chunk == 10:
            js = js.replace(chaos_ok=jnp.ones(128, jnp.float32))
            ts = ts.replace(chaos_ok=torch.ones(128))
        for _ in range(10):
            js = _step(jp, js)
            ts = swim.step(tp, ts)
            _assert_state(js, ts, where=f"tick {ts.tick}: ", rtol=BULK_RTOL)
    assert np.asarray(js.committed_dead)[mask].any()


def test_compiled_swim_run_is_cached_per_key():
    _, tp = _params(n=64)
    a = chaos.compiled_swim_run(tp, 10)
    assert chaos.compiled_swim_run(tp, 10) is a
    assert chaos.compiled_swim_run(tp, 10, 3) is not a
    s = swim.init_state(tp, device="cpu")
    s2, fr = a(s)
    assert s2.tick == 10 and fr.shape == (10,)


# ---------------------------------------------------------------------------
# the SWIM halves of the scenarios against the JAX scenarios
# ---------------------------------------------------------------------------

SWIM_ROW = ("serf.member.flap", "chaos.fault.injected", "chaos.fault.healed")


def _swim_rows(rows):
    """(name, labels, ts) of the SWIM harness's flight rows: the raft half
    of a JAX scenario journals faults without a tick label."""
    return [(r["name"], r["labels"], r["ts"]) for r in rows
            if r["name"] in SWIM_ROW and "tick" in r["labels"]]


@pytest.mark.parametrize("name", sorted(chaos.SCENARIOS))
def test_scenario_swim_half_matches_reference(name):
    seed = 7
    with flight.use(flight.FlightRecorder(clock=lambda: 0.0,
                                          forward_to_log=False)) as rec:
        ref = getattr(jchaos, f"scenario_{name}")(seed)
    jrows = _swim_rows(rec.read())
    with flight.use(flight.FlightRecorder(clock=lambda: 0.0,
                                          forward_to_log=False)) as rec:
        violations, detail = chaos.SCENARIOS[name](seed, device="cpu",
                                                   hooks=consul_hooks())
    trows = _swim_rows(rec.read())
    assert detail == ref["detail"]["swim"]
    assert violations == [v for v in ref["violations"]
                          if v.startswith("swim")] == []
    assert trows == jrows and len(trows) >= 2
