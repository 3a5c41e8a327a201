"""The port's anti-entropy model against the JAX package on the CPU.

P3: `step` over 60 ticks from a converted state, with services
registered, re-registered at bumped versions and deregistered every few
ticks and a set of agents held down for a stretch; every leaf (all int32
and bool) equal after every tick, the tick mirror included.
`in_sync_fraction` is equal at every tick (float32, same integer counts,
same division).  `sync_masks` (the diff in its step form) against the
masks JAX's step takes, tick by tick.  P4: tests/test_antientropy.py's
six tests on the port.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, jax_dict

from consul_tpu.models import antientropy as jae
from consul_tpu.ops import reconcile as jrec
from consul_tpu_torch import convert
from consul_tpu_torch.models import antientropy as ae
from consul_tpu_torch.ops import reconcile

INV = reconcile.INVALID_ID


def _churn(rng, live, ver, owner, n_reg, n_dereg):
    """Re-register n_reg live ids at a bumped version and deregister
    n_dereg others (host numpy bookkeeping); returns the command args."""
    pick = rng.choice(sorted(live), n_reg + n_dereg, replace=False)
    reg, dereg = pick[:n_reg], pick[n_reg:]
    ver[reg] += 1
    for i in dereg:
        live.discard(int(i))
    return ((reg.astype(np.int32), owner[reg].astype(np.int32),
             ver[reg].astype(np.int32)), dereg.astype(np.int32))


def test_step_trajectory_matches_reference():
    params = dict(n_agents=48, capacity=512, sync_interval_ticks=6, seed=9)
    jp, tp = jae.AEParams(**params), ae.AEParams(**params)
    rng = np.random.default_rng(4)
    n_svc = 400
    ids = rng.choice(10_000, n_svc, replace=False).astype(np.int32)
    owner = np.zeros(10_000, np.int64)
    owner[ids] = rng.integers(0, 48, n_svc)
    ver = np.zeros(10_000, np.int64)
    ver[ids] = 1
    js = jae.init_state(jp)
    ts = convert.ae_state_from_numpy(jax_dict(js), "cpu")
    # first registration in random order, in two batches
    for part in np.array_split(rng.permutation(ids), 2):
        js = jae.register_desired(js, part, owner[part].astype(np.int32),
                                  ver[part].astype(np.int32))
        ts = ae.register_desired(ts, part, owner[part].astype(np.int32),
                                 ver[part].astype(np.int32))
    assert_leaves(jax_dict(js), convert.ae_state_to_numpy(ts),
                  where="registered: ")
    live = set(int(i) for i in ids)
    step = jax.jit(jae.step, static_argnums=0)
    down = np.zeros(48, bool)
    down[:6] = True
    for t in range(60):
        if t % 3 == 1:
            (reg, dereg) = _churn(rng, live, ver, owner, 12, 3)
            js = jae.register_desired(js, *reg)
            ts = ae.register_desired(ts, *reg)
            js = jae.deregister_desired(js, dereg)
            ts = ae.deregister_desired(ts, dereg)
        up = ~down if 10 <= t < 35 else np.ones(48, bool)
        js = step(jp, js, up)
        ts = ae.step(tp, ts, torch.from_numpy(up))
        assert_leaves(jax_dict(js), convert.ae_state_to_numpy(ts),
                      where=f"tick {t}: ")
        a = np.asarray(jae.in_sync_fraction(js))
        b = ae.in_sync_fraction(ts).numpy()
        assert a.dtype == b.dtype and a == b, (t, a, b)
    assert float(b) == 1.0
    assert int((ts.a_ids != INV).sum()) == len(live)


@jax.jit
def _jax_sync_masks(s, up):
    """antientropy.step's due agents and the diff's masks (:122-134)."""
    due_full = (s.tick >= s.next_full) & up
    row_dirt_owner = jax.numpy.zeros_like(up).at[
        jax.numpy.where(s.d_dirty, s.d_node, 0)].max(s.d_dirty)
    due = (due_full | s.n_dirty | row_dirt_owner) & up
    diff = jrec.diff_sorted(s.d_ids, s.d_ver, s.a_ids, s.a_ver)
    return due_full, due, diff.push & due[s.d_node], diff.drop & due[s.a_node]


@pytest.mark.parametrize("seed", [5, 17])
def test_sync_masks_match_reference_step_masks(seed):
    """sync_masks (the diff in its step form, masked by the due agents at
    the rows' owners) against the masks JAX's step takes, along a churn
    run with agents down and deregistrations (drops) in flight."""
    params = dict(n_agents=40, capacity=384, sync_interval_ticks=5, seed=seed)
    jp, tp = jae.AEParams(**params), ae.AEParams(**params)
    rng = np.random.default_rng(seed)
    ids = rng.choice(5_000, 300, replace=False).astype(np.int32)
    owner = np.zeros(5_000, np.int64)
    owner[ids] = rng.integers(0, 40, 300)
    ver = np.zeros(5_000, np.int64)
    ver[ids] = 1
    js = jae.register_desired(jae.init_state(jp), ids,
                              owner[ids].astype(np.int32),
                              ver[ids].astype(np.int32))
    ts = convert.ae_state_from_numpy(jax_dict(js), "cpu")
    live = set(int(i) for i in ids)
    step = jax.jit(jae.step, static_argnums=0)
    for t in range(24):
        if t % 2 == 1:
            reg, dereg = _churn(rng, live, ver, owner, 10, 4)
            js = jae.deregister_desired(jae.register_desired(js, *reg), dereg)
            ts = ae.deregister_desired(ae.register_desired(ts, *reg), dereg)
        up = rng.random(40) < (0.7 if 6 <= t < 16 else 1.0)
        ref = _jax_sync_masks(js, up)
        got = ae.sync_masks(tp, ts, torch.from_numpy(up))
        for name, r, g in zip(("due_full", "due", "push", "drop"), ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"tick {t} {name}")
        js = step(jp, js, up)
        ts = ae.step(tp, ts, torch.from_numpy(up))
    assert_leaves(jax_dict(js), convert.ae_state_to_numpy(ts), where="end: ")


# ---------------------------------------------------------------------------
# P4: tests/test_antientropy.py on the port
# ---------------------------------------------------------------------------

def test_scale_factor_matches_reference():
    for n, want in ((1, 1), (128, 1), (129, 2), (256, 2), (512, 3),
                    (8192, 7)):
        assert ae.scale_factor(n) == want == jae.scale_factor(n)


def test_diff_sorted_basic():
    src = torch.tensor([2, 5, 9, INV], dtype=torch.int32)
    sv = torch.tensor([1, 1, 3, 0], dtype=torch.int32)
    dst = torch.tensor([2, 7, 9, INV], dtype=torch.int32)
    dv = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    d = reconcile.diff_sorted(src, sv, dst, dv)
    np.testing.assert_array_equal(d.push.numpy(), [False, True, True, False])
    np.testing.assert_array_equal(d.drop.numpy(), [False, True, False, False])


def test_full_sync_converges_catalog():
    params = ae.AEParams(n_agents=32, capacity=256, sync_interval_ticks=10,
                         seed=3)
    s = ae.init_state(params, device="cpu")
    ids = torch.arange(100, 200, dtype=torch.int32)
    s = ae.register_desired(s, ids, ids % 32, torch.ones(100, dtype=torch.int32))
    up = torch.ones(32, dtype=torch.bool)
    for _ in range(30):
        s = ae.step(params, s, up)
    assert float(ae.in_sync_fraction(s)) == 1.0
    assert int((s.a_ids != INV).sum()) == 100


def test_deregister_syncs_promptly():
    params = ae.AEParams(n_agents=8, capacity=64, sync_interval_ticks=50,
                         seed=4)
    s = ae.init_state(params, device="cpu")
    ids = torch.arange(10, 30, dtype=torch.int32)
    s = ae.register_desired(s, ids, ids % 8, torch.ones(20, dtype=torch.int32))
    up = torch.ones(8, dtype=torch.bool)
    for _ in range(60):
        s = ae.step(params, s, up)
    s = ae.deregister_desired(s, torch.tensor([12, 17], dtype=torch.int32))
    # the n_dirty edge trigger: the deletion lands on the next tick
    s = ae.step(params, s, up)
    a = s.a_ids.numpy()
    assert 12 not in a and 17 not in a
    assert int((a != INV).sum()) == 18


def test_down_agent_rows_go_stale_until_it_returns():
    params = ae.AEParams(n_agents=4, capacity=64, sync_interval_ticks=5,
                         seed=5)
    s = ae.init_state(params, device="cpu")
    s = ae.register_desired(s, [7], [2], [1])
    down = torch.tensor([True, True, False, True])
    for _ in range(20):
        s = ae.step(params, s, down)
    assert float(ae.in_sync_fraction(s)) < 1.0   # agent 2 never synced
    up = torch.ones(4, dtype=torch.bool)
    for _ in range(20):
        s = ae.step(params, s, up)
    assert float(ae.in_sync_fraction(s)) == 1.0


def test_version_bump_is_pushed():
    params = ae.AEParams(n_agents=4, capacity=32, sync_interval_ticks=5,
                         seed=6)
    s = ae.init_state(params, device="cpu")
    s = ae.register_desired(s, [9], [1], [1])
    up = torch.ones(4, dtype=torch.bool)
    for _ in range(12):
        s = ae.step(params, s, up)
    s = ae.register_desired(s, [9], [1], [2])    # re-register marks it dirty
    s = ae.step(params, s, up)
    pos = int(np.searchsorted(s.a_ids.numpy(), 9))
    assert int(s.a_ver[pos]) == 2


def test_init_state_matches_reference():
    """The stagger is K1's randint on stream 11, bit-equal."""
    for n, seed in ((32, 3), (1000, 7)):
        jp = jae.AEParams(n_agents=n, capacity=64, sync_interval_ticks=60,
                          seed=seed)
        tp = ae.AEParams(n_agents=n, capacity=64, sync_interval_ticks=60,
                         seed=seed)
        assert_leaves(jax_dict(jae.init_state(jp)),
                      convert.ae_state_to_numpy(ae.init_state(tp, "cpu")))
    assert int(jrec.INVALID_ID) == INV


def test_churn_workload_ends_in_sync():
    """scenarios.ae_churn (chip_smoke.py's phase 9 workload) at 2,048
    services over 128 agents: after the churn and the final step every
    live desired row is in the catalog at its version, and two runs give
    one digest."""
    from consul_tpu_torch import scenarios
    cfg = scenarios.Churn(n_agents=128, capacity=2304, services=2048,
                          reregister=6, deregister=2, down_agents=4,
                          down_from=5, down_to=40)
    a = scenarios.ae_churn(cfg, "cpu", digest=True)
    assert a["in_sync"] == 1.0
    assert a["catalog_live"] == a["desired_live"] == a["desired_rows"] \
        == 2048 - 2 * cfg.params.scaled_interval
    assert a["steps"] == cfg.params.scaled_interval + 2 == a["ticks"]
    b = scenarios.ae_churn(cfg, "cpu", digest=True)
    assert a["digest"] == b["digest"]
