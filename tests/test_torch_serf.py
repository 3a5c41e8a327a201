"""The port's serf pool against the JAX package on the CPU.

`serf.run` in the setup of tests/test_serf.py (N=128, U=16, p_loss 0.01,
seed 5; 10 ticks, kill node 9, 400 monitored ticks): the monitor
fractions are bit-equal on every tick and every int/bool leaf of the
SWIM and event states is equal at each 40-tick checkpoint.  Vivaldi is
held by a scale-relative bound, max|port - ref| <= 1e-5 * max|ref| per
leaf: its normal draw's erf_inv and its norms and means round a few ulp
apart in XLA and PyTorch (measured at most 6e-7 of scale after 400
ticks), and Vivaldi never feeds back into SWIM.  A fired user event and
the bench pipeline at N=1024 close the file.
"""

import jax
import numpy as np

from torch_parity import assert_leaves, int_leaves, jax_dict

import bench as jbench
from consul_tpu import config as jconfig
from consul_tpu.models import events as jevents
from consul_tpu.models import serf as jserf
from consul_tpu.models import swim as jswim
from consul_tpu_torch import bench, config, convert
from consul_tpu_torch.models import events, serf, swim

VIVALDI_SCALE_RTOL = 1e-5
_run = jax.jit(jserf.run, static_argnums=(0, 2, 3))


def _params(n=128, u=16, p_loss=0.01, seed=5):
    return (jserf.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(
                n_nodes=n, rumor_slots=u, p_loss=p_loss, seed=seed)),
            serf.make_params(config.GossipConfig.lan(), config.SimConfig(
                n_nodes=n, rumor_slots=u, p_loss=p_loss, seed=seed)))


def _assert_cluster(js, ts, where):
    a = jax_dict(js.swim)
    assert_leaves(a, convert.swim_state_to_numpy(ts.swim), only=int_leaves(a),
                  where=where + "swim.")
    e = jax_dict(js.events)
    assert_leaves(e, convert.event_state_to_numpy(ts.events),
                  where=where + "events.")
    v = jax_dict(js.coords)
    got = convert.vivaldi_state_to_numpy(ts.coords)
    assert int(got["adj_index"]) == int(v["adj_index"])
    for name in ("coords", "height", "error", "adj_window", "adjustment"):
        ref = v[name]
        err = np.abs(got[name] - ref).max()
        assert err <= VIVALDI_SCALE_RTOL * np.abs(ref).max(), \
            f"{where}coords.{name}: {err} vs scale {np.abs(ref).max()}"


def test_serf_run_matches_reference():
    jp, tp = _params()
    js = jserf.init_state(jp)
    ts = serf.init_state(tp, device="cpu")
    js, _ = _run(jp, js, 10)
    ts, _ = serf.run(tp, ts, 10)
    _assert_cluster(js, ts, "tick 10: ")
    js = js.replace(swim=jswim.kill(js.swim, 9))
    ts = ts.replace(swim=swim.kill(ts.swim, 9))
    for chunk in range(10):
        js, jf = _run(jp, js, 40, 9)
        ts, tf = serf.run(tp, ts, 40, 9)
        np.testing.assert_array_equal(tf.numpy().view(np.int32),
                                      np.asarray(jf).view(np.int32))
        _assert_cluster(js, ts, f"tick {ts.swim.tick}: ")
    assert float(tf[-1]) > 0.99
    mv = np.asarray(jax.jit(jserf.metrics_vector, static_argnums=0)(jp, js))
    np.testing.assert_array_equal(serf.metrics_vector(tp, ts).numpy(), mv)


def test_fired_event_matches_reference():
    jp, tp = _params(n=128, u=16, p_loss=0.05, seed=8)
    js = jserf.init_state(jp)
    ts = serf.init_state(tp, device="cpu")
    js, _ = _run(jp, js, 10)
    ts, _ = serf.run(tp, ts, 10)
    for origin, eid in ((3, 101), (70, 102)):
        js = jserf.fire_event(jp, js, origin, eid)
        ts = serf.fire_event(tp, ts, origin, eid)
    _assert_cluster(js, ts, "fired: ")
    for chunk in range(4):           # spreads, then the slots expire
        js, _ = _run(jp, js, 10)
        ts, _ = serf.run(tp, ts, 10)
        _assert_cluster(js, ts, f"tick {ts.swim.tick}: ")
    for slot in (0, 1):
        a = float(jevents.coverage(jp.events, js.events, slot, js.swim.up,
                                   js.swim.member))
        b = float(events.coverage(tp.events, ts.events, slot, ts.swim.up,
                                  ts.swim.member))
        assert a == b and b > 0.9
    assert not any(ts.events.active_host)


def test_bench_pipeline_matches_reference():
    """bench.run_convergence at N=1024 (victim n // 3, as the CPU-scaled
    bench guard runs it: the default victim 123456 is outside the pool)."""
    ref = jbench.run_convergence(n_nodes=1024, victim=341)
    got = bench.run_convergence(n_nodes=1024, victim=341, device="cpu")
    for key in ("ticks", "converged", "f1", "false_commits"):
        assert got[key] == ref[key], key
    assert got["converged"] and got["f1"] == 1.0 and got["false_commits"] == 0
    mv = np.asarray(jax.jit(jserf.metrics_vector, static_argnums=0)(
        ref["params"], ref["state"]))
    for name, value in zip(jswim.METRIC_NAMES, mv):
        assert got["sim_counters"][name] == float(value), name
    assert got["launches"] == {name: 0 for name in got["launches"]}
