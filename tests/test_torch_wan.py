"""The port's federation (models/wan.py) against the JAX package on the CPU.

P3: JAX's jitted single-device `wan.step` and the port's step from one
converted state at 3 DCs x 64 nodes x 3 servers with 8 rumor and event
slots, an event fired in DC 0 at a non-server node and DC 2 killed in the
WAN pool mid-run: every int and bool leaf of every LAN pool and of the
WAN pool, the bridged-id rings and their cursors equal after every one
of 150 ticks, both bridge directions fired.  The float leaves are held by
the scale-relative bound of tests/test_torch_serf.py (Vivaldi's norms and
erf_inv round a few ulp apart in XLA and PyTorch; nothing float feeds the
int state).  `dc_distance_matrix` is held with an even server count (2:
four pairs, the median averages two).  P4: tests/test_wan.py's four
tests on the port.  The bridge reads the device only on ticks with an
active event slot.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, int_leaves, jax_dict

from consul_tpu.models import wan as jwan
from consul_tpu_torch import convert, kernels
from consul_tpu_torch.models import wan

SCALE_RTOL = 1e-5
_step = jax.jit(jwan.step, static_argnums=0)


def _mk(n_dcs=3, nodes=64, servers=3, seed=0, p_loss=0.0):
    kw = dict(n_dcs=n_dcs, nodes_per_dc=nodes, servers_per_dc=servers,
              p_loss=p_loss, seed=seed, rumor_slots=8, event_slots=8)
    return wan.make_params(**kw), jwan.make_params(**kw)


def _cluster_dict(c) -> dict:
    return {"swim": jax_dict(c.swim), "coords": jax_dict(c.coords),
            "events": jax_dict(c.events)}


def _wan_dict(s) -> dict:
    return {"lan": _cluster_dict(s.lan), "wan": _cluster_dict(s.wan),
            "bridged": np.asarray(s.bridged),
            "bridged_ptr": np.asarray(s.bridged_ptr)}


def _assert_pool(ref: dict, got: dict, where: str) -> None:
    for part in ("swim", "events", "coords"):
        a, b = ref[part], got[part]
        assert_leaves(a, b, only=int_leaves(a), where=f"{where}{part}.")
        for name in set(a) - set(int_leaves(a)):
            err = np.abs(np.asarray(b[name]) - np.asarray(a[name])).max()
            scale = max(np.abs(np.asarray(a[name])).max(), 1e-30)
            assert err <= SCALE_RTOL * scale, \
                f"{where}{part}.{name}: {err} vs scale {scale}"


def _assert_wan(js, ts, where: str) -> None:
    ref, got = _wan_dict(js), convert.wan_state_to_numpy(ts)
    _assert_pool(ref["wan"], got["wan"], where + "wan.")
    _assert_pool(ref["lan"], got["lan"], where + "lan.")
    for name in ("bridged", "bridged_ptr"):
        assert_leaves(ref, got, only=[name], where=where)


def test_state_converts_both_ways():
    tp, jp = _mk()
    js = jwan.init_state(jp)
    ts = wan.init_state(tp, device="cpu")
    _assert_wan(js, ts, "init: ")
    back = convert.wan_state_from_numpy(_wan_dict(js), "cpu")
    _assert_wan(js, back, "converted: ")
    assert back.lan[1].events.active_host == ts.lan[1].events.active_host


def test_wan_trajectory_matches_reference():
    tp, jp = _mk(p_loss=0.01, seed=3)
    js = jwan.init_state(jp)
    ts = convert.wan_state_from_numpy(_wan_dict(js), "cpu")
    for _ in range(5):
        js, ts = _step(jp, js), wan.step(tp, ts)
    js = jwan.fire_event(jp, js, dc=0, origin=17, event_id=99)
    ts = wan.fire_event(tp, ts, dc=0, origin=17, event_id=99)
    _assert_wan(js, ts, "fired: ")
    for t in range(150):
        if t == 60:
            js = jwan.wan_kill_dc(jp, js, dc=2)
            ts = wan.wan_kill_dc(tp, ts, dc=2)
        js, ts = _step(jp, js), wan.step(tp, ts)
        _assert_wan(js, ts, f"tick {t}: ")
    # both directions fired: DC 0 injected into the WAN, DCs 1 and 2 took
    # the event from it
    assert ts.bridged_ptr[0] >= 1 and ts.bridged_ptr[1] >= 1 \
        and ts.bridged_ptr[2] >= 1
    assert 99 in ts.bridged[0] and 99 in ts.bridged[1]
    cov_j = np.asarray(jwan.event_coverage_by_dc(jp, js, 99))
    cov_t = wan.event_coverage_by_dc(tp, ts, 99).numpy()
    np.testing.assert_array_equal(cov_t, cov_j)
    np.testing.assert_array_equal(wan.dc_reachable(tp, ts).numpy(),
                                  np.asarray(jwan.dc_reachable(jp, js)))


def test_dc_distance_matrix_matches_reference_with_even_servers():
    tp, jp = _mk(n_dcs=3, nodes=32, servers=2, seed=1)
    js = jwan.init_state(jp)
    d = _wan_dict(js)
    rng = np.random.default_rng(5)
    c = d["wan"]["coords"]
    c["coords"] = (rng.standard_normal(c["coords"].shape) * 0.03
                   ).astype(np.float32)
    c["height"] = (rng.random(c["height"].shape) * 1e-3).astype(np.float32)
    c["adjustment"] = (rng.standard_normal(c["adjustment"].shape) * 1e-3
                       ).astype(np.float32)
    ts = convert.wan_state_from_numpy(d, "cpu")
    js = js.replace(wan=js.wan.replace(coords=js.wan.coords.replace(
        **{k: jax.numpy.asarray(c[k]) for k in ("coords", "height",
                                                "adjustment")})))
    ref = np.asarray(jwan.dc_distance_matrix(jp, js))
    got = wan.dc_distance_matrix(tp, ts).numpy()
    assert got.shape == ref.shape == (3, 3) and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=SCALE_RTOL, atol=0)
    # the lower middle value alone (torch.median's rule) is not the answer
    n = 6
    ids = np.arange(n)
    cc, hh, aa = c["coords"], c["height"], c["adjustment"]
    raw = np.linalg.norm(cc[ids][:, None] - cc[ids][None], axis=-1) \
        + hh[:, None] + hh[None]
    adj = raw + aa[:, None] + aa[None]
    dist = np.where(adj > 0, adj, raw).reshape(3, 2, 3, 2).transpose(
        0, 2, 1, 3).reshape(3, 3, 4)
    lower = np.sort(dist, -1)[..., 1]
    assert not np.allclose(got, lower, rtol=1e-3)


def test_bridge_reads_nothing_while_every_table_is_idle(monkeypatch):
    tp, _ = _mk()
    s = wan.init_state(tp, device="cpu")
    syncs = wan.host_syncs
    launches = dict(kernels.LAUNCHES)
    monkeypatch.setattr(wan, "_read_bridge_tables",
                        lambda *a: pytest.fail("read with no active slot"))
    s = wan.run(tp, s, 12)
    assert wan.host_syncs == syncs
    monkeypatch.undo()
    s = wan.fire_event(tp, s, dc=1, origin=20, event_id=5)
    s = wan.run(tp, s, 4)               # one read per tick in flight
    assert wan.host_syncs == syncs + 4
    assert kernels.LAUNCHES == launches    # the CPU path launches nothing


# ---------------------------------------------------------------------------
# P4: tests/test_wan.py on the port
# ---------------------------------------------------------------------------

def _port(n_dcs=3, nodes=64, servers=3, seed=0):
    params = _mk(n_dcs, nodes, servers, seed)[0]
    return params, wan.init_state(params, device="cpu")


def test_event_crosses_datacenters():
    params, s = _port()
    s = wan.fire_event(params, s, dc=0, origin=17, event_id=99)
    s = wan.run(params, s, 80)
    cov = wan.event_coverage_by_dc(params, s, 99).numpy()
    assert cov[0] > 0.99, f"origin DC coverage {cov}"
    assert cov[1] > 0.99 and cov[2] > 0.99, f"remote DC coverage {cov}"


def test_event_does_not_duplicate_local_slots():
    params, s = _port()
    s = wan.fire_event(params, s, dc=1, origin=5, event_id=42)
    s = wan.run(params, s, 80)
    for dc in range(params.n_dcs):
        ev = s.lan[dc].events
        assert int(((ev.e_id == 42) & ev.e_active).sum()) <= 1


def test_dc_partition_detected_over_wan():
    params, s = _port()
    s = wan.run(params, s, 10)
    s = wan.wan_kill_dc(params, s, dc=2)
    s = wan.run(params, s, 900)
    assert wan.dc_reachable(params, s).tolist() == [True, True, False]


def test_dc_distance_matrix_shape_and_symmetry():
    params, s = _port()
    s = wan.run(params, s, 200)
    m = wan.dc_distance_matrix(params, s).numpy()
    assert m.shape == (3, 3)
    np.testing.assert_allclose(m, m.T, rtol=1e-4)


def test_wan_point_matches_the_reference_loop():
    """scenarios.wan_point (chip_smoke.py's phase 8 workload) at 2 DCs x 128
    nodes x 3 servers against the same loop over JAX's jitted wan.run on
    one device: the same coverage tick and per-DC coverage."""
    from consul_tpu_torch import scenarios
    params, s, row = scenarios.wan_point(2, 128, 3, "cpu")
    jp = jwan.make_params(n_dcs=2, nodes_per_dc=128, servers_per_dc=3,
                          p_loss=0.01, seed=7)
    js = jwan.init_state(jp)
    run = jax.jit(jwan.run, static_argnums=(0, 2))
    for _ in range(6):
        js = run(jp, js, 5)
    js = jwan.fire_event(jp, js, 0, 127, 7)
    conv = -1
    for chunk in range(1, 51):
        js = run(jp, js, 5)
        cov = np.asarray(jwan.event_coverage_by_dc(jp, js, 7))
        if cov.min() >= 0.99:
            conv = 5 * chunk
            break
    assert row["convergence_ticks"] == conv > 0
    assert row["coverage"] == cov.tolist()
    _assert_wan(js, s, "covered: ")
    s, part = scenarios.wan_partition(params, s, 1)
    assert part["reachable_ticks"] == 0 and part["committed_ticks"] > 0
    assert wan.dc_reachable(params, s).tolist() == [True, False]
