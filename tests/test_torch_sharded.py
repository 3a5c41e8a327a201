"""The node-sharded pool of the port (parallel/mesh.py) against the JAX
package on the CPU: the gossip tick, the monitor and the oracle's reads.

A JAX serf pool (U = 16, E = 8, 5% loss, a kill) is run to a gossip tick
with rumors queued, a user event is fired, and the state is carried to
the port and cut into B blocks.  Over the gossip ticks up to the next
probe tick the port's sharded `serf.step` (K2's twin block by block:
rolls' block rotations, each block's loss draws, the counters as
integer totals added in block order) is held to JAX's single-device
`serf.step`, plain and in the nemesis build's chaos mode: every leaf
bit-equal, floats included (a gossip tick writes no float but the
counters, and those are integer totals), and the sharded monitor's
fraction equal to JAX's after every tick.  At B = 8 (one compile) the
same ticks are held to JAX's own 8-device sharded `serf.run`, built as
tests/test_sharding.py builds it.  The sharded oracle's reads equal the
unsharded oracle's and move fewer than N bytes each; a sharded probe
tick raises before anything runs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import serf as jserf
from consul_tpu.models import swim as jswim
from consul_tpu.parallel import mesh as jmesh
from consul_tpu_torch import config, convert
from consul_tpu_torch import oracle as poracle
from consul_tpu_torch.models import serf, swim
from consul_tpu_torch.ops import gossip
from consul_tpu_torch.parallel import mesh

BLOCKS = (2, 4, 8)
SIZES = (64, 256)
MODES = ("plain", "chaos")
U, E = 16, 8
VICTIM = 3


def _cpu_mesh(blocks):
    return mesh.make_mesh(["cpu"] * blocks)


def _jax_params(n, mode, blocks=1):
    return jserf.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(
        n_nodes=n, rumor_slots=U, p_loss=0.05, seed=11, chaos=mode == "chaos",
        shard_blocks=blocks), event_slots=E)


def _port_params(n, mode, blocks):
    return serf.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=n, rumor_slots=U, p_loss=0.05, seed=11, chaos=mode == "chaos",
        shard_blocks=blocks), event_slots=E)


def _as_dict(js) -> dict:
    return {"swim": jax_dict(js.swim), "coords": jax_dict(js.coords),
            "events": jax_dict(js.events)}


@functools.lru_cache(maxsize=None)
def _jax_ticks(n, mode):
    """(the JAX state at a gossip tick right after a probe tick, rumors
    queued and a user event just fired, as a dict; the dicts after each
    gossip tick up to the next probe tick; the monitor's fraction after
    each), from JAX's jitted single-device serf.step."""
    jp = _jax_params(n, mode)
    step = jax.jit(jserf.step, static_argnums=0)
    frac = jax.jit(jswim.believed_down_fraction, static_argnums=(0, 2))
    js = jserf.init_state(jp)
    js = js.replace(swim=jswim.kill(js.swim, VICTIM))
    if mode == "chaos":
        rng = np.random.default_rng(n)
        r = rng.random(n)
        js = js.replace(swim=js.swim.replace(
            chaos_grp=jnp.asarray((r < 0.3).astype(np.int16)),
            chaos_ok=jnp.asarray(np.where(r > 0.85, 0.6, 1.0)
                                 .astype(np.float32))))
    period = jp.swim.probe_period_ticks
    for _ in range(400):
        t = int(js.swim.tick)
        if t % period == 1 and bool((js.swim.sends_left > 0).any()):
            break
        js = step(jp, js)
    else:
        raise AssertionError("no gossip tick with rumors queued")
    js = jserf.fire_event(jp, js, 7, 42)
    start = _as_dict(js)
    states, fracs = [], []
    for _ in range(period - 1):
        js = step(jp, js)
        states.append(_as_dict(js))
        fracs.append(np.asarray(frac(jp.swim, js.swim, VICTIM)))
    return start, states, fracs


def _assert_state(want: dict, got: serf.ClusterState, where: str) -> None:
    flat = mesh.unshard_state(got)
    assert_leaves(want["swim"], convert.swim_state_to_numpy(flat.swim),
                  rtol=0, where=where + "swim.")
    assert_leaves(want["events"], convert.event_state_to_numpy(flat.events),
                  rtol=0, where=where + "events.")
    assert_leaves(want["coords"], convert.vivaldi_state_to_numpy(flat.coords),
                  rtol=0, where=where + "coords.")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("blocks,n", [(b, n) for b in BLOCKS for n in SIZES])
def test_sharded_gossip_ticks_match_jax(blocks, n, mode):
    start, states, fracs = _jax_ticks(n, mode)
    tp = _port_params(n, mode, blocks)
    s = mesh.shard_state(convert.cluster_state_from_numpy(start, "cpu"),
                         _cpu_mesh(blocks))
    mesh.assert_node_sharded(s.swim.know, blocks, "knowledge")
    served0 = float(s.swim.ctr.home[swim.CTR_GOSSIP_SERVED])
    for t, (want, frac) in enumerate(zip(states, fracs)):
        s = serf.step(tp, s)
        mesh.assert_node_sharded(s.events.know, blocks, "event knowledge")
        _assert_state(want, s, f"tick {t}: ")
        got = swim.believed_down_fraction(tp.swim, s.swim, VICTIM)
        assert got.numpy().tobytes() == frac.astype(np.float32).tobytes()
    # the ticks carried rumors and the event: the counters moved
    assert float(s.swim.ctr.home[swim.CTR_GOSSIP_SERVED]) > served0
    assert bool(s.events.know.parts[0].any() | s.events.know.parts[-1].any())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("blocks", BLOCKS)
def test_sharded_swim_step_matches_jax(blocks, mode):
    """swim.step alone (no event layer) on the same start, N = 256."""
    start, states, _ = _jax_ticks(256, mode)
    jp = _jax_params(256, mode)
    step = _jax_swim_step()
    js = _jax_from_dict(jserf.init_state(jp), start).swim
    tp = _port_params(256, mode, blocks)
    s = mesh.shard_state(convert.swim_state_from_numpy(start["swim"], "cpu"),
                         _cpu_mesh(blocks))
    for t in range(len(states)):
        js = step(jp.swim, js)
        s = swim.step(tp.swim, s)
        assert_leaves(jax_dict(js), convert.swim_state_to_numpy(
            mesh.unshard_state(s)), rtol=0, where=f"tick {t}: ")


@functools.lru_cache(maxsize=None)
def _jax_swim_step():
    return jax.jit(jswim.step, static_argnums=0)


def test_sharded_ticks_match_jax_eight_device_sharded_run():
    """B = 8 against JAX's own sharded run on the 8-device CPU mesh
    (tests/test_sharding.py:26-43), shard_blocks = 8 in both."""
    n, mode = 256, "plain"
    start, states, fracs = _jax_ticks(n, mode)
    jp = _jax_params(n, mode, blocks=8)
    js = _jax_from_dict(jserf.init_state(jp), start)
    m = jmesh.make_mesh()
    sharding = jmesh.state_sharding(js, m)
    run = jax.jit(jserf.run, static_argnums=(0, 2, 3),
                  out_shardings=(sharding, None))
    got_j, frac_j = run(jp, jax.device_put(js, sharding), len(states), VICTIM)
    jmesh.assert_node_sharded(got_j.swim.know, 8, "JAX knowledge")
    tp = _port_params(n, mode, 8)
    s = mesh.shard_state(convert.cluster_state_from_numpy(start, "cpu"),
                         _cpu_mesh(8))
    s, frac_p = serf.run(tp, s, len(states), VICTIM)
    _assert_state(_as_dict(got_j), s, "8-device: ")
    np.testing.assert_array_equal(frac_p.numpy(), np.asarray(frac_j))
    np.testing.assert_array_equal(frac_p.numpy(), np.stack(fracs))


def _jax_from_dict(template, d: dict):
    """A JAX ClusterState holding the arrays of `d`."""
    def part(sub, vals):
        return sub.replace(**{k: jnp.asarray(v) for k, v in vals.items()})
    return template.replace(swim=part(template.swim, d["swim"]),
                            coords=part(template.coords, d["coords"]),
                            events=part(template.events, d["events"]))


def _random_call(n, slots, seed, chaos_mode):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    call = dict(
        offs=torch.tensor([1, n // 3, n - 1], dtype=torch.int32),
        know=rnd(n, slots) < 0.3, sends_left=(rnd(n, slots) * 8).to(torch.int8),
        sender_ok=rnd(n) < 0.95, receiver_ok=rnd(n) < 0.95,
        slot_active=rnd(slots) < 0.9, retransmit_limit=12, p_loss=0.05,
        key=(0x1234, 0xBEEF),
        learn_tick=((rnd(n, slots) * 65536) - 32768).to(torch.int16),
        tick16=-1234,
        # counters near 2^24: the totals are added as integers, once
        ctr=torch.tensor([1.0, 2.0, 16777215.0, 16777216.0, 33554430.0]),
        want_newly=True)
    if chaos_mode:
        call["group"] = (rnd(n) < 0.3).to(torch.int16)
        call["node_ok"] = torch.where(rnd(n) > 0.8, 0.7, 1.0)
    return call


def _shard_call(call, m, n):
    out = {}
    for k, v in call.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == n:
            out[k] = mesh.shard_state(v, m, n)
        elif isinstance(v, torch.Tensor):
            out[k] = mesh.Replicated.of(v, m.distinct)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("chaos_mode", (False, True))
@pytest.mark.parametrize("blocks,n,slots", [(2, 64, 8), (4, 256, 16),
                                            (8, 256, 64), (4, 64, 40)])
def test_sharded_gossip_twin_equals_the_unsharded_pass(blocks, n, slots,
                                                       chaos_mode):
    """K2's per-block twin on random rows (every output asked for, the
    chaos mode, U = 8 ... 64) equals the one-device twin, the counters'
    float32 values included, where ctr sits at and above 2^24."""
    call = _random_call(n, slots, blocks + n + slots, chaos_mode)
    want = gossip.disseminate_plain(**call)
    got = gossip.disseminate(**_shard_call(call, _cpu_mesh(blocks), n))
    for name in ("know", "sends_left", "newly", "learn_tick"):
        a = mesh.unshard_state(getattr(got, name))
        assert torch.equal(a, getattr(want, name)), name
    assert torch.equal(got.ctr.home.view(torch.int32),
                       want.ctr.view(torch.int32))
    for name in ("delivered", "served", "lost"):
        assert float(getattr(got, name)) == float(getattr(want, name)), name
    assert float(want.served) > 0 and float(want.delivered) > 0


def _reads_pool(n):
    """A port pool with members failed and left and a spread of rumors:
    the oracle's reads have something to report."""
    sim = config.SimConfig(n_nodes=n, rumor_slots=U, p_loss=0.02, seed=5,
                           n_initial=n - 8)
    p = serf.make_params(config.GossipConfig.lan(), sim)
    s = serf.init_state(p, n_initial=n - 8, device="cpu")
    s = s.replace(swim=swim.kill(s.swim, VICTIM))
    s = s.replace(swim=swim.kill(s.swim, n // 2 + 1))
    s, _ = serf.run(p, s, 60)
    s = s.replace(swim=swim.leave(p.swim, s.swim, 9))
    s, _ = serf.run(p, s, 3)
    return sim, s


def _oracles(n, blocks):
    sim, s = _reads_pool(n)
    # one pool, its shard count given to both (the per-shard gauges)
    sim = dataclasses.replace(sim, shard_blocks=blocks)
    d = convert.cluster_state_to_numpy(s)
    prov = np.arange(n) < n - 8
    ref = convert.oracle_from_numpy(config.GossipConfig.lan(), sim, d, prov,
                                    device="cpu")
    sh = convert.oracle_from_numpy(config.GossipConfig.lan(), sim, d, prov,
                                   device="cpu", mesh=_cpu_mesh(blocks))
    return ref, sh


def _reads(o, n):
    return [
        ("members", lambda: o.members(limit=8)),
        ("members offset", lambda: o.members(limit=8, offset=n // 2 - 3)),
        ("summary", o.members_summary),
        ("status", lambda: o.status(f"node{VICTIM}")),
        ("status left", lambda: o.status("node9")),
        ("delta", lambda: o.members_delta(8)),
        ("delta again", lambda: o.members_delta(8)),
        ("coordinate", lambda: o.coordinate(f"node{n - 9}")),
        ("sort_by_rtt", lambda: o.sort_by_rtt("node1", ["node5", "node2",
                                                        f"node{n - 10}"])),
        ("shard_metrics", o.shard_metrics),
        ("believed_down", lambda: o.believed_down_fraction(f"node{VICTIM}")),
    ]


@pytest.mark.parametrize("blocks,n", [(b, n) for b in BLOCKS for n in SIZES])
def test_sharded_oracle_reads_equal_unsharded_and_move_under_n_bytes(
        blocks, n, monkeypatch):
    ref, sh = _oracles(n, blocks)
    assert sh.sim.shard_blocks == blocks and sh.device == torch.device("cpu")
    mesh.assert_node_sharded(sh._state.swim.know, blocks, "oracle state")
    summary = ref.members_summary()
    assert summary["failed"] >= 1 and summary["left"] >= 1
    moved = [0]          # the unsharded read's transfers land in slot -2
    real = poracle._to_host

    def spy(x):
        a = real(x)
        moved[-1] += a.nbytes
        return a

    monkeypatch.setattr(poracle, "_to_host", spy)
    for (name, want), (_, got) in zip(_reads(ref, n), _reads(sh, n)):
        expect = want()
        moved.append(0)
        assert got() == expect, name
        # each read moves its page, never the node axis; the per-shard
        # gauges are [B, 4] float32
        if name == "shard_metrics":
            assert moved[-1] == 16 * blocks
        else:
            assert 0 < moved[-1] < n, (name, moved[-1])
    status = swim.status_vector(sh.params.swim, sh._state.swim)
    assert isinstance(status, mesh.Blocks)
    assert torch.equal(mesh.unshard_state(status),
                       swim.status_vector(ref.params.swim, ref._state.swim))


def test_sharded_probe_tick_raises_before_anything_runs():
    """A sharded probe tick runs now (tests/test_torch_sharded_probe.py).
    What still raises before anything runs is a tick that starts with the
    bulk channel live, a probe tick included (ROADMAP queue A item 3b-ii),
    gathering nothing and leaving the blocks as they were."""
    start, _, _ = _jax_ticks(64, "plain")
    tp = _port_params(64, "plain", 4)
    s = mesh.shard_state(convert.cluster_state_from_numpy(start, "cpu"),
                         _cpu_mesh(4))
    while s.swim.tick % tp.swim.probe_period_ticks:
        s = serf.step(tp, s)
    live = s.replace(swim=s.swim.replace(bulk_live=True))
    know = [p.clone() for p in s.swim.know.parts]
    for fn in (lambda: serf.step(tp, live),
               lambda: swim.step(tp.swim, live.swim),
               lambda: serf.run(tp, live, 3)):
        with pytest.raises(NotImplementedError, match="3b-ii"):
            fn()
    assert all(torch.equal(a, b) for a, b in zip(know, s.swim.know.parts))
    gossip = live.replace(swim=live.swim.replace(tick=live.swim.tick + 1))
    with pytest.raises(NotImplementedError, match="bulk channel"):
        serf.step(tp, gossip)
    assert swim.metrics_vector(tp.swim, s.swim).shape == (
        len(swim.METRIC_NAMES),)


def test_sharded_oracle_refuses_ticks_and_commands():
    """The sharded oracle advances, warms up, kills, revives and reads its
    metrics now (tests/test_torch_sharded_probe.py); the commands of
    ROADMAP queue A item 3b-ii still raise, before anything runs."""
    o = poracle.GossipOracle(sim=config.SimConfig(n_nodes=64, rumor_slots=8),
                             device="cpu", mesh=_cpu_mesh(4))
    assert o.members_summary()["alive"] == 64
    for call in (lambda: o.leave("node1"), lambda: o.spawn(),
                 lambda: o.fire_event("e", b"", "node1"),
                 lambda: o.rtt("node1", "node2"),
                 lambda: o.event_coverage(0)):
        with pytest.raises(NotImplementedError, match="3b-ii"):
            call()
    assert o.tick == 0
