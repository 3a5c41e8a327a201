"""The reference's behavior tests of the main path, re-run on the port.

The device assertions of tests/test_swim.py (all twelve), tests/
test_serf.py (both), tests/test_events.py's first four and tests/
test_device_counters.py's first four, against consul_tpu_torch with
device="cpu", at the same sizes, seeds and horizons, nothing loosened.
Only the spelling changes: torch for jnp, a Python loop of port ticks for
the jitted scan.  (The parity tests hold the port's trajectories to the
JAX package; these hold its behavior to what the reference asserts.)
"""

import dataclasses

import numpy as np
import torch

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import events, serf, swim, vivaldi


def make(n, seed=0, p_loss=0.01, rumor_slots=16):
    params = swim.make_params(GossipConfig.lan(),
                              SimConfig(n_nodes=n, rumor_slots=rumor_slots,
                                        p_loss=p_loss, seed=seed))
    return params, swim.init_state(params, device="cpu")


def run_n(params, state, ticks, monitor=None):
    s, frac = swim.run(params, state, ticks, monitor)
    return s, frac.numpy()


# ---------------------------------------------------------------------------
# tests/test_swim.py
# ---------------------------------------------------------------------------

def test_no_false_positives_clean_network():
    params, s = make(128, p_loss=0.0)
    s, _ = run_n(params, s, 100)
    assert not bool(s.r_active.any())
    assert not bool(s.committed_dead.any())
    assert int(s.incarnation.sum()) == 0


def test_crash_detection_converges():
    params, s = make(256, p_loss=0.01)
    s, _ = run_n(params, s, 20)
    s = swim.kill(s, 7)
    s, frac = run_n(params, s, 400, monitor=7)
    assert frac[-1] > 0.99, f"final believed-down fraction {frac[-1]}"
    assert frac[-1] >= frac[200] >= frac[0] - 1e-6
    assert bool(s.committed_dead[7])


def test_no_detection_before_suspicion_timeout():
    params, s = make(256, p_loss=0.01)
    s = swim.kill(s, 7)
    s, frac = run_n(params, s, params.suspicion_min_ticks // 2, monitor=7)
    assert float(frac[-1]) == 0.0


def test_refutation_of_live_node():
    params, s = make(64, p_loss=0.0)
    s = swim.inject_suspicion(params, s, subject=3, origin=11)
    s, frac = run_n(params, s, 300, monitor=3)
    assert int(s.incarnation[3]) >= 1
    assert not bool(s.committed_dead.any())
    assert float(frac[-1]) == 0.0


def test_graceful_leave_propagates():
    params, s = make(64, p_loss=0.0)
    s = swim.leave(params, s, 5)
    s, frac = run_n(params, s, 120, monitor=5)
    assert float(frac[-1]) > 0.99
    assert bool(s.committed_left[5])
    assert not bool(s.committed_dead[5])


def test_deterministic():
    params, s0 = make(64, p_loss=0.05, seed=42)
    s0 = swim.kill(s0, 1)
    a, _ = run_n(params, s0, 60)
    b, _ = run_n(params, s0, 60)
    assert a.tick == b.tick and a.bulk_live == b.bulk_live
    for name in swim.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), err_msg=name)


def test_timer_formulas_match_memberlist():
    g = GossipConfig.lan()
    assert g.retransmit_limit(9) == 4 * 1
    assert g.retransmit_limit(255) == 4 * 3
    assert g.retransmit_limit(10**6) == 4 * 7
    assert g.suspicion_min_ticks(10) == 4 * 1 * 5
    assert g.suspicion_min_ticks(1000) == 4 * 3 * 5
    w = GossipConfig.wan()
    assert w.probe_period_ticks == 10


def test_rejoin_after_committed_death():
    params, s = make(128, p_loss=0.0)
    s, _ = run_n(params, s, 20)
    inc_before = int(s.incarnation[9])
    s = swim.kill(s, 9)
    s, frac = run_n(params, s, 400, monitor=9)
    assert frac[-1] > 0.99
    assert bool(s.committed_dead[9])
    s = swim.rejoin(params, s, 9)
    assert not bool(s.committed_dead[9])
    assert int(s.incarnation[9]) == inc_before + 1
    s, frac = run_n(params, s, 200, monitor=9)
    assert frac[-1] < 0.01, "alive refutation did not spread"
    assert not bool(s.committed_dead[9])
    assert bool(s.up[9]) and bool(s.member[9])


def test_sparse_pool_elastic_join():
    params, _ = make(64, p_loss=0.0)
    s = swim.init_state(params, n_initial=48, device="cpu")
    assert int(s.member.sum()) == 48
    s, _ = run_n(params, s, 400)
    assert int(s.committed_dead.sum()) == 0
    assert int((s.r_active & (s.r_kind == swim.SUSPECT)).sum()) == 0
    s = swim.rejoin(params, s, 50)
    assert bool(s.member[50]) and bool(s.up[50])
    s, _ = run_n(params, s, 120)
    assert int(s.member.sum()) == 49
    assert not bool(s.committed_dead[50])
    s = swim.kill(s, 5)
    s, frac = run_n(params, s, 400, monitor=5)
    assert frac[-1] > 0.99
    assert bool(s.committed_dead[5])


def test_lifeguard_awareness_tracks_own_health():
    params, s = make(128, p_loss=0.0)
    s, _ = run_n(params, s, 60)
    assert int(s.awareness.sum()) == 0
    lossy, sl = make(128, p_loss=0.30, rumor_slots=16)
    sl, _ = run_n(lossy, sl, 60)
    assert int(sl.awareness.sum()) > 0
    clean = swim.make_params(
        GossipConfig.lan(),
        SimConfig(n_nodes=128, rumor_slots=16, p_loss=0.0, seed=0))
    before = int(sl.awareness.sum())
    sl2, _ = run_n(clean, sl, 120)
    assert int(sl2.awareness.sum()) < before


def test_awareness_delta_zero_on_failed_probe_without_indirect_checks():
    gossip = dataclasses.replace(GossipConfig.lan(), indirect_checks=0)
    params = swim.make_params(
        gossip, SimConfig(n_nodes=64, rumor_slots=16, p_loss=0.0, seed=1))
    s = swim.init_state(params, device="cpu")
    s, _ = run_n(params, s, 20)
    assert int(s.awareness.sum()) == 0
    s = swim.kill(s, 7)
    s, _ = run_n(params, s, 120)
    assert int(s.awareness.sum()) == 0
    assert bool(s.committed_dead[7]) or bool(s.r_active.any())


def test_lifeguard_reduces_false_suspicions_under_loss():
    counts = {}
    for on in (True, False):
        gossip = GossipConfig.lan() if on else dataclasses.replace(
            GossipConfig.lan(), awareness_max_multiplier=0)
        params = swim.make_params(
            gossip, SimConfig(n_nodes=256, rumor_slots=16, p_loss=0.15,
                              seed=3))
        s = swim.init_state(params, device="cpu")
        s, _ = run_n(params, s, 400)
        assert not bool(s.committed_dead.any())
        counts[on] = int(s.sus_count.sum())
    assert counts[False] > 0
    assert counts[True] < counts[False], counts


# ---------------------------------------------------------------------------
# tests/test_serf.py
# ---------------------------------------------------------------------------

def _serf(n, seed, p_loss):
    params = serf.make_params(GossipConfig.lan(),
                              SimConfig(n_nodes=n, rumor_slots=16,
                                        p_loss=p_loss, seed=seed))
    return params, serf.init_state(params, device="cpu")


def test_probe_acks_drive_coordinate_convergence():
    params, s = _serf(128, 4, 0.0)
    s, _ = serf.run(params, s, 1500)
    src = torch.arange(128, dtype=torch.int32)
    dst = (src + 31) % 128
    true_ms = torch.sqrt(((s.swim.coords[src.long()] - s.swim.coords[dst.long()])
                          ** 2).sum(-1)) + params.swim.rtt_base_ms
    est_s = vivaldi.estimate_rtt(s.coords, src, dst).numpy()
    true_ms = true_ms.numpy()
    rel = np.median(np.abs(est_s * 1000.0 - 2.0 * true_ms) / (2.0 * true_ms))
    assert rel < 0.35, f"median relative coordinate error {rel}"


def test_cluster_step_keeps_detection_working():
    params, s = _serf(128, 5, 0.01)
    s, _ = serf.run(params, s, 10)
    s = s.replace(swim=swim.kill(s.swim, 9))
    s, frac = serf.run(params, s, 400, 9)
    assert float(frac[-1]) > 0.99


# ---------------------------------------------------------------------------
# tests/test_events.py
# ---------------------------------------------------------------------------

def _ev(n=128, seed=0):
    return _serf(n, seed, 0.0)


def test_event_reaches_whole_cluster():
    params, s = _ev(128)
    s = serf.fire_event(params, s, origin=3, event_id=42)
    s, _ = serf.run(params, s, 30)
    cov = float(events.coverage(params.events, s.events, 0, s.swim.up,
                                s.swim.member))
    assert cov > 0.999
    assert int(s.events.e_id[0]) == 42


def test_lamport_clocks_advance_and_order():
    params, s = _ev(64)
    s = serf.fire_event(params, s, origin=0, event_id=1)
    s, _ = serf.run(params, s, 20)
    assert int(torch.where(s.events.know[:, 0], s.events.lamport, 1).min()) >= 1
    s = serf.fire_event(params, s, origin=17, event_id=2)
    lt1, lt2 = int(s.events.e_ltime[0]), int(s.events.e_ltime[1])
    assert lt2 > lt1


def test_event_slot_recycles_oldest_when_full():
    params, s = _ev(32)
    ep = params.events
    for i in range(ep.event_slots + 3):
        s = serf.fire_event(params, s, origin=i % 32, event_id=100 + i)
    ids = set(s.events.e_id.tolist())
    assert 100 not in ids
    assert 100 + ep.event_slots + 2 in ids


def test_dead_node_does_not_learn_event():
    params, s = _ev(64)
    s = s.replace(swim=swim.kill(s.swim, 9))
    s = serf.fire_event(params, s, origin=0, event_id=7)
    s, _ = serf.run(params, s, 30)
    assert int(s.events.deliver_tick[9, 0]) == -1
    cov = float(events.coverage(params.events, s.events, 0, s.swim.up,
                                s.swim.member))
    assert cov > 0.999


# ---------------------------------------------------------------------------
# tests/test_device_counters.py
# ---------------------------------------------------------------------------

def _pool(n=32, seed=3, p_loss=0.05):
    params = serf.make_params(GossipConfig.lan(),
                              SimConfig(n_nodes=n, rumor_slots=8,
                                        p_loss=p_loss, seed=seed))
    return params, serf.init_state(params, device="cpu")


def test_counters_accumulate_inside_the_step():
    params, s = _pool()
    assert s.swim.ctr.numpy().sum() == 0.0
    for _ in range(3 * params.swim.probe_period_ticks):
        s = serf.step(params, s)
    ctr = s.swim.ctr.numpy()
    assert ctr[swim.CTR_PROBES_SENT] > 0
    assert ctr[swim.CTR_PROBE_ACKS] > 0
    assert ctr[swim.CTR_PROBE_ACKS] <= ctr[swim.CTR_PROBES_SENT]
    before = ctr.copy()
    s = serf.step(params, s)
    assert (s.swim.ctr.numpy() >= before).all()


def test_kill_shows_up_in_failure_counters_and_queue_gauges():
    params, s = _pool(p_loss=0.0)
    for _ in range(2 * params.swim.probe_period_ticks):
        s = serf.step(params, s)
    s = s.replace(swim=swim.kill(s.swim, 5))
    for _ in range(6 * params.swim.probe_period_ticks):
        s = serf.step(params, s)
    m = dict(zip(swim.METRIC_NAMES, serf.metrics_vector(params, s).numpy()))
    assert m["probe.failed"] >= 1
    assert m["suspicion.started"] >= 1
    assert m["queue.suspect"] + m["queue.dead"] >= 1
    assert m["queue.depth"] >= m["queue.suspect"]
    assert m["members.alive"] == 31
    assert 0.0 <= m["convergence.fraction"] <= 1.0
    assert 0.0 <= m["slot.utilization"] <= 1.0


def test_metrics_vector_matches_names_and_is_one_transfer():
    params, s = _pool(n=16)
    vec = serf.metrics_vector(params, s)
    assert vec.shape == (len(swim.METRIC_NAMES),)
    vals = vec.numpy()
    assert np.isfinite(vals).all()
    m = dict(zip(swim.METRIC_NAMES, vals))
    assert m["members.alive"] == 16.0
    assert m["tick"] == 0.0


def test_gossip_dissemination_counters_flow():
    params, s = _pool(n=32, p_loss=0.2)
    s = s.replace(swim=swim.leave(params.swim, s.swim, 7))
    for _ in range(8):
        s = serf.step(params, s)
    ctr = s.swim.ctr.numpy()
    assert ctr[swim.CTR_GOSSIP_SERVED] > 0
    assert ctr[swim.CTR_GOSSIP_DELIVERED] > 0
    assert ctr[swim.CTR_GOSSIP_LOST] > 0
