"""P4 on the mass-event path: the assertions of the JAX package's
tests/test_correlated_failures.py (rumor-table saturation, the bulk death
channel, flap revives) and tests/test_f1.py (the coverage-guarded commit,
the F1 harness), re-run against the port on the CPU at their own sizes,
through the port's own chunk runner (`chaos.compiled_swim_run`),
`kill_mask`, `revive`, `mass_detection_stats` and `f1.run_one`."""

import numpy as np
import torch

import torch_parity  # noqa: F401  (one intra-op thread)

from consul_tpu_torch import config, f1
from consul_tpu_torch.chaos import compiled_swim_run
from consul_tpu_torch.models import swim

CPU = "cpu"


def _params(n=512, slots=8):
    return swim.make_params(
        config.GossipConfig.lan(),
        config.SimConfig(n_nodes=n, rumor_slots=slots, p_loss=0.0, seed=13))


def _run(params, s, ticks, monitor=None):
    return compiled_swim_run(params, ticks, monitor)(s)


def _mask(n, victims):
    mask = np.zeros(n, bool)
    mask[victims] = True
    return mask, torch.from_numpy(mask)


def _stats(params, s, mask_t):
    rec, fp = swim.mass_detection_stats(params, s, mask_t)
    return float(rec), int(fp)


# --- tests/test_correlated_failures.py ---------------------------------------

def test_mass_kill_exceeding_slot_table_converges():
    params = _params(n=512, slots=8)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    victims = np.random.default_rng(3).choice(512, size=32, replace=False)
    _, mask_t = _mask(512, victims)
    s = swim.kill_mask(s, mask_t)
    rec = 0.0
    for _ in range(40):
        s, _ = _run(params, s, 100)
        rec, fp = _stats(params, s, mask_t)
        if rec >= 0.999:
            break
    assert rec >= 0.999, f"recall stalled at {rec:.3f}"
    assert fp == 0, f"{fp} live nodes believed down"
    for _ in range(40):
        if s.committed_dead.numpy()[victims].all():
            break
        s, _ = _run(params, s, 100)
    assert s.committed_dead.numpy()[victims].all()


def test_pressure_eviction_preserves_commit_rules():
    params = _params(n=256, slots=4)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    victims = np.random.default_rng(5).choice(256, size=8, replace=False)
    _, mask_t = _mask(256, victims)
    s = swim.kill_mask(s, mask_t)
    saw_full_table = False
    for _ in range(60):
        s, _ = _run(params, s, 50)
        if int(s.r_active.sum()) == 4:
            saw_full_table = True
        rec, fp = _stats(params, s, mask_t)
        assert fp == 0
        if rec >= 0.999:
            break
    assert rec >= 0.999
    assert saw_full_table, "table never saturated; test too weak"


def test_single_victim_path_unchanged():
    params = _params(n=1024, slots=16)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    s = swim.kill(s, 123)
    s, frac = _run(params, s, 600, 123)
    frac = frac.numpy()
    assert frac[-1] >= 0.99
    assert int(np.argmax(frac > 0.99)) < 300


def test_bulk_channel_engages_and_drains_without_waves():
    params = _params(n=512, slots=4)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    victims = np.random.default_rng(11).choice(512, size=64, replace=False)
    _, mask_t = _mask(512, victims)
    s = swim.kill_mask(s, mask_t)
    saw_bulk = False
    ticks = 0
    rec = 0.0
    for _ in range(400):
        s, _ = _run(params, s, 5)
        ticks += 5
        saw_bulk = saw_bulk or int(s.bulk_member.sum()) > 0
        rec, fp = _stats(params, s, mask_t)
        assert fp == 0
        if rec >= 0.999:
            break
    assert saw_bulk, "overflow never reached the bulk channel"
    assert rec >= 0.999, f"recall stalled at {rec:.3f}"
    gossip = config.GossipConfig.lan()
    sus = params.suspicion_max_ticks
    drain = int(64 * 6.0 / (gossip.gossip_nodes * params.packet_msgs)) + 1
    assert ticks <= 2 * (sus + drain) + 200, (
        f"converged in {ticks} ticks — wave-like behavior")
    for _ in range(40):
        if s.committed_dead.numpy()[victims].all():
            break
        s, _ = _run(params, s, 50)
    assert s.committed_dead.numpy()[victims].all()


def test_bulk_channel_idle_for_small_kills():
    params = _params(n=512, slots=32)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    victims = np.random.default_rng(7).choice(512, size=4, replace=False)
    _, mask_t = _mask(512, victims)
    s = swim.kill_mask(s, mask_t)
    for _ in range(12):
        s, _ = _run(params, s, 50)
        assert int(s.bulk_member.sum()) == 0
        rec, _ = _stats(params, s, mask_t)
        if rec >= 0.999:
            break
    assert rec >= 0.999


def test_revive_withdraws_bulk_entry():
    params = _params(n=256, slots=2)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    node = 42
    up, bulk = s.up.clone(), s.bulk_member.clone()
    up[node], bulk[node] = False, True
    s = s.replace(up=up, bulk_member=bulk, bulk_heard=s.bulk_heard + 0.5,
                  bulk_live=True)
    s = swim.revive(s, node)
    assert not bool(s.bulk_member[node])
    s, _ = _run(params, s, 600)
    assert not bool(s.committed_dead[node])
    assert bool(s.up[node])


def test_bulk_straggler_keeps_own_clock():
    params = _params(n=512, slots=4)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    old = np.random.default_rng(21).choice(512, size=50, replace=False)
    live_n = 512 - 50
    bm = np.zeros(512, bool)
    bm[old] = True
    cov = np.zeros(512, np.float32)
    cov[old] = 0.992
    bm_t = torch.from_numpy(bm)
    s = s.replace(up=s.up & ~bm_t, bulk_member=bm_t,
                  bulk_cov=torch.from_numpy(cov),
                  bulk_heard=torch.from_numpy(
                      np.where(~bm, 49.6, 0.0).astype(np.float32)),
                  bulk_live=True)
    straggler = int(np.setdiff1d(np.arange(512), old)[7])
    up, bulk, bcov = s.up.clone(), s.bulk_member.clone(), s.bulk_cov.clone()
    up[straggler], bulk[straggler] = False, True
    bcov[straggler] = 1.0 / live_n
    s = s.replace(up=up, bulk_member=bulk, bulk_cov=bcov)
    _, mask_t = _mask(512, [straggler])
    rec, _ = _stats(params, s, mask_t)
    assert rec < 0.01, "straggler detected the tick it entered"
    assert float(swim.believed_down_fraction(params, s, straggler)) < 0.05
    s, _ = _run(params, s, 200)
    assert s.committed_dead.numpy()[old].all(), \
        "rolling commit starved by the straggler"
    for _ in range(10):
        if bool(s.committed_dead[straggler]):
            break
        s, _ = _run(params, s, 100)
    assert bool(s.committed_dead[straggler])


def test_flap_revive_rejoins_with_bumped_incarnation():
    params = _params(n=512, slots=8)
    s = swim.init_state(params, device=CPU)
    s, _ = _run(params, s, 25)
    node = 100
    _, mask_t = _mask(512, [node])
    s = swim.kill_mask(s, mask_t)
    stale = None
    for _ in range(40):
        s, _ = _run(params, s, 25)
        stale = s.r_active.numpy() & (s.r_kind.numpy() == swim.DEAD) \
            & (s.r_subject.numpy() == node)
        if stale.any() or bool(s.committed_dead[node]):
            break
    assert stale is not None and stale.any(), \
        "setup: no dead rumor before commit"
    inc_before = int(s.incarnation[node])
    s = swim.revive(s, node)
    assert int(s.incarnation[node]) > inc_before
    assert not (s.r_active.numpy() & stale).any()
    assert not s.know.numpy()[:, np.flatnonzero(stale)].any()
    for _ in range(20):
        s, _ = _run(params, s, 100)
        assert not bool(s.committed_dead[node]), "flap death recommitted"
    assert bool(s.up[node]) and bool(s.member[node])


# --- tests/test_f1.py --------------------------------------------------------

def _f1_params(n=256, p_loss=0.0, seed=3):
    return swim.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=n, rumor_slots=16, alloc_cap=4, p_loss=p_loss, seed=seed))


def test_unspread_dead_rumor_does_not_commit():
    params = _f1_params()
    s = swim.init_state(params, device=CPU)
    victim = 9
    r_active, r_kind = s.r_active.clone(), s.r_kind.clone()
    r_subject, r_start = s.r_subject.clone(), s.r_start.clone()
    know, sends = s.know.clone(), s.sends_left.clone()
    r_active[0], r_kind[0], r_subject[0] = True, swim.DEAD, victim
    r_start[0] = s.tick
    know[0, 0], sends[0, 0] = True, 0
    s = s.replace(r_active=r_active, r_kind=r_kind, r_subject=r_subject,
                  r_start=r_start, know=know, sends_left=sends)
    s2, _ = swim.run(params, s, 4 * params.expiry_gossip_ticks + 50)
    assert not bool(s2.committed_dead[victim]), \
        "an undisseminated dead rumor was committed"
    assert not bool(s2.r_active[0]), "slot was never freed"


def test_real_death_still_commits_with_guard():
    params = _f1_params()
    s = swim.init_state(params, device=CPU)
    s, _ = swim.run(params, s, 25)
    s = swim.kill(s, 7)
    s, _ = swim.run(params, s, 700)
    assert bool(s.committed_dead[7]), "real death failed to commit"


def test_no_false_commits_at_p_loss_005():
    params = _f1_params(n=512, p_loss=0.05, seed=11)
    s = swim.init_state(params, device=CPU)
    s, _ = swim.run(params, s, 25)
    victims = [5, 50, 500]
    for v in victims:
        s = swim.kill(s, v)
    s, _ = swim.run(params, s, 900)
    up = s.up.numpy()
    committed = s.committed_dead.numpy()
    assert int((committed & up).sum()) == 0, "false committed death(s)"
    for v in victims:
        assert bool(committed[v]), f"victim {v} not committed dead"


def test_f1_harness_clean_network():
    res = f1.run_one(n=512, kills=4, ticks=700, p_loss=0.0, seed=5,
                     device=CPU)
    assert res["f1"] == 1.0
    assert res["false_commits"] == 0
