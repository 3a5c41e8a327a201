"""The node-sharded probe tick of the port (models/swim_blocks.py) against
the JAX package and the unsharded port, on the CPU.

Each probe pass's block twin (the subject maps, the probe round with its
origination, slot suspicion expiry, the maps' conversion, dense expiry
with its origination, refutation, expire and Vivaldi's ring observation)
walks a JAX state converted at a probe tick, cut into B = 2, 4, 8 blocks
of N = 64 and 256 nodes, plain and in the nemesis build with a partition:
every leaf bit-equal to the port's unsharded twin at each pass, and to
the JAX pass (int and bool leaves bit-equal, floats within rtol 1e-6, the
RTT's one-ulp log1p difference, as tests/test_torch_probe.py holds
them).  Then the reference's own sharded test (tests/test_sharding.py:
46-75) on the port: serf.run from init_state with a kill and the monitor,
against JAX's single device at each B and JAX's 8-device sharded run at B
= 8 (the Vivaldi floats within VIVALDI_SCALE_RTOL of their scale, every
other leaf and the monitor bit-equal), and against the unsharded port
with every leaf bit-equal.  Then K1's block draws, the index-0 sentinels,
evicting origination, the metrics vector, the bench and the oracle on a
mesh, and the refusal of a live bulk channel (ROADMAP queue A item
3b-ii).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, int_leaves, jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import serf as jserf
from consul_tpu.models import swim as jswim
from consul_tpu.models import vivaldi as jvivaldi
from consul_tpu.parallel import mesh as jmesh
from consul_tpu_torch import bench, config, convert
from consul_tpu_torch import oracle as poracle
from consul_tpu_torch.models import serf, swim, swim_blocks, vivaldi
from consul_tpu_torch.parallel import mesh
from consul_tpu_torch.utils import prng

BLOCKS = (2, 4, 8)
SIZES = (64, 256)
MODES = ("plain", "chaos")
U = 16
VIVALDI_SCALE_RTOL = 1e-5
PASSES = ("maps", "probe_round", "suspicion_expiry", "maps_convert",
          "dense_expiry", "refutation", "expire", "observe_ring")

_jrun = jax.jit(jswim.run, static_argnums=(0, 2, 3))


def _cpu_mesh(blocks):
    return mesh.make_mesh(["cpu"] * blocks)


def _sim(pkg, n, mode, blocks=1, **kw):
    return pkg.SimConfig(**dict(dict(
        n_nodes=n, rumor_slots=U, p_loss=0.02, seed=11, chaos=mode == "chaos",
        shard_blocks=blocks), **kw))


@functools.lru_cache(maxsize=None)
def _probe_state(n, mode):
    """(jax serf params, the JAX serf state at a probe tick with rumors,
    dense timers and kills in flight; the nemesis build's with a
    partition and a degraded tenth)."""
    jp = jserf.make_params(jconfig.GossipConfig.lan(), _sim(jconfig, n, mode))
    step = jax.jit(jserf.step, static_argnums=0)
    js = jserf.init_state(jp)
    for _ in range(10):
        js = step(jp, js)
    js = js.replace(swim=jswim.kill(jswim.kill(js.swim, 3), n // 2 + 5))
    if mode == "chaos":
        r = np.random.default_rng(n).random(n)
        js = js.replace(swim=js.swim.replace(
            chaos_grp=jnp.asarray((r < 0.3).astype(np.int16)),
            chaos_ok=jnp.asarray(np.where(r > 0.9, 0.6, 1.0)
                                 .astype(np.float32))))
    for _ in range(20):
        js = step(jp, js)
    assert int(js.swim.tick) % jp.swim.probe_period_ticks == 0
    return jp, js


def _port_params(n, mode, blocks=1, **kw):
    return serf.make_params(config.GossipConfig.lan(),
                            _sim(config, n, mode, blocks, **kw))


def _swim_dict(s) -> dict:
    return convert.swim_state_to_numpy(mesh.unshard_state(s))


def _unshard(x):
    if isinstance(x, mesh.Replicated):
        return x.home
    return mesh.unshard_state(x)


@functools.lru_cache(maxsize=None)
def _jax_chain(n, mode):
    """The JAX passes of the probe tick, stage by stage: {stage: (state
    dict, extra)}."""
    jp, js = _probe_state(n, mode)
    p, s = jp.swim, js.swim
    out = {}
    maps = jswim._maps(p, s)
    out["maps"] = (jax_dict(s), tuple(np.asarray(m) for m in maps))
    s, obs, maps = jswim._probe_round(p, s, maps)
    out["probe_round"] = (jax_dict(s), tuple(np.asarray(m) for m in maps))
    s, convert_ = jswim._suspicion_expiry(p, s)
    out["suspicion_expiry"] = (jax_dict(s), np.asarray(convert_))
    maps = jswim._maps_convert(maps, s, convert_)
    out["maps_convert"] = (jax_dict(s), tuple(np.asarray(m) for m in maps))
    s = jswim._dense_suspicion_expiry(p, s, obs.shift, maps)
    out["dense_expiry"] = (jax_dict(s), None)
    s = jswim._refutation(p, s)
    out["refutation"] = (jax_dict(s), None)
    s = jswim._expire(p, s)
    out["expire"] = (jax_dict(s), None)
    c = jvivaldi.observe_ring(jp.vivaldi, js.coords, obs.shift,
                              obs.rtt_ms / 1000.0, obs.acked)
    out["observe_ring"] = (jax_dict(c), None)
    return out


def _chain(p, s, coords, ops, stop: str):
    """The port's probe-tick passes through `ops` (swim's unsharded twins
    or swim_blocks' block twins) up to `stop`: (swim state, extra, or the
    Vivaldi state for observe_ring)."""
    maps = ops["maps"](p.swim, s)
    if stop == "maps":
        return s, maps
    s, obs, maps = ops["probe_round"](p.swim, s, maps)
    if stop == "probe_round":
        return s, maps
    if stop == "observe_ring":
        return None, vivaldi.observe_ring(p.vivaldi, coords, obs.shift,
                                          obs.rtt_ms, obs.acked)
    s, conv = ops["suspicion_expiry"](p.swim, s)
    if stop == "suspicion_expiry":
        return s, conv
    maps = ops["maps_convert"](maps, s, conv)
    if stop == "maps_convert":
        return s, maps
    s = ops["dense_expiry"](p.swim, s, obs.shift, maps)
    if stop == "dense_expiry":
        return s, None
    s = ops["refutation"](p.swim, s)
    if stop == "refutation":
        return s, None
    return ops["expire"](p.swim, s), None


UNSHARDED = {"maps": swim._maps_plain, "probe_round": swim._probe_round_plain,
             "suspicion_expiry": swim._suspicion_expiry_plain,
             "maps_convert": swim._maps_convert_plain,
             "dense_expiry": swim._dense_suspicion_expiry_plain,
             "refutation": swim._refutation_plain,
             "expire": swim._expire_plain}
SHARDED = {"maps": swim_blocks.maps_plain,
           "probe_round": swim_blocks.probe_round,
           "suspicion_expiry": swim_blocks.suspicion_expiry_plain,
           "maps_convert": swim_blocks.maps_convert_plain,
           "dense_expiry": swim_blocks.dense_expiry_plain,
           "refutation": swim_blocks.refutation_plain,
           "expire": swim_blocks.expire_plain}


@pytest.mark.parametrize("stage", PASSES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("blocks,n", [(b, n) for b in BLOCKS for n in SIZES])
def test_block_twin_of_each_probe_pass(stage, mode, blocks, n):
    """Each pass's block twin equals the unsharded twin (every leaf and
    output bit-equal) and the JAX pass."""
    _, js = _probe_state(n, mode)
    cs = convert.cluster_state_from_numpy(
        {"swim": jax_dict(js.swim), "coords": jax_dict(js.coords),
         "events": jax_dict(js.events)}, "cpu")
    tp = _port_params(n, mode, blocks)
    ref_s, ref_x = _chain(tp, cs.swim, cs.coords, UNSHARDED, stage)
    sh = mesh.shard_state(cs, _cpu_mesh(blocks))
    mesh.assert_node_sharded(sh.swim.know, blocks, "knowledge")
    got_s, got_x = _chain(tp, sh.swim, sh.coords, SHARDED, stage)
    want, want_x = _jax_chain(n, mode)[stage]
    where = f"{stage} B={blocks}: "
    if stage == "observe_ring":
        got = convert.vivaldi_state_to_numpy(mesh.unshard_state(got_x))
        assert_leaves(convert.vivaldi_state_to_numpy(ref_x), got, rtol=0,
                      where=where)
        _assert_vivaldi(want, got, where + "jax ")
        return
    got = _swim_dict(got_s)
    assert_leaves(convert.swim_state_to_numpy(ref_s), got, rtol=0,
                  where=where)
    assert_leaves(want, got, rtol=1e-6, where=where + "jax ")
    if isinstance(ref_x, tuple):           # the maps
        for a, b, c in zip(ref_x, got_x, want_x):
            assert torch.equal(a, _unshard(b)), where
            np.testing.assert_array_equal(_unshard(b).numpy(), c)
    elif ref_x is not None:                # convert
        assert torch.equal(ref_x, got_x)
        np.testing.assert_array_equal(got_x.numpy(), want_x)


def test_the_chain_moves_every_pass():
    """The probe-tick states these tests walk convert slots, originate
    rumors and run dense timers: no pass is held on an empty input."""
    jp, js = _probe_state(256, "plain")
    chain = _jax_chain(256, "plain")
    assert chain["probe_round"][0]["r_active"].sum() \
        > np.asarray(js.swim.r_active).sum() - 1
    assert (chain["probe_round"][0]["sus_start"] >= 0).any()
    assert np.asarray(js.swim.r_active).any()
    acked = chain["observe_ring"][0]["coords"]
    assert np.abs(acked).max() > 0


# ----------------------------------------------- serf.run from init_state

def _serf_run_jax(blocks, shard):
    """tests/test_sharding.py's trajectory: N = 256, U = 16, 2% loss, seed
    11, a kill of node 3, 40 ticks with node 3 monitored."""
    params = jserf.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(
        n_nodes=256, rumor_slots=16, p_loss=0.02, seed=11,
        shard_blocks=blocks))
    s = jserf.init_state(params)
    s = s.replace(swim=jswim.kill(s.swim, 3))
    kw = {}
    if shard:
        m = jmesh.make_mesh()
        sharding = jmesh.state_sharding(s, m)
        s = jax.device_put(s, sharding)
        kw["out_shardings"] = (sharding, None)
    run = jax.jit(jserf.run, static_argnums=(0, 2, 3), **kw)
    out, frac = run(params, s, 40, 3)
    return out, np.asarray(frac)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(sharded: bool):
    out, frac = _serf_run_jax(8 if sharded else 1, sharded)
    if sharded:
        jmesh.assert_node_sharded(out.swim.know, 8, "JAX knowledge")
    return ({"swim": jax_dict(out.swim), "coords": jax_dict(out.coords),
             "events": jax_dict(out.events)}, frac)


@functools.lru_cache(maxsize=None)
def _port_trajectory(blocks: int):
    p = serf.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=256, rumor_slots=16, p_loss=0.02, seed=11,
        shard_blocks=blocks))
    s = serf.init_state(p, device="cpu")
    s = s.replace(swim=swim.kill(s.swim, 3))
    if blocks > 1:
        s = mesh.shard_state(s, _cpu_mesh(blocks))
    out, frac = serf.run(p, s, 40, 3)
    if blocks > 1:
        mesh.assert_node_sharded(out.swim.know, blocks, "knowledge")
        out = mesh.unshard_state(out)
    return convert.cluster_state_to_numpy(out), frac.numpy()


def _assert_vivaldi(v: dict, c: dict, where: str):
    """The port's Vivaldi leaves against JAX's: the cursor equal, each
    float leaf within VIVALDI_SCALE_RTOL of its largest magnitude (as
    tests/test_torch_serf.py holds them)."""
    assert int(c["adj_index"]) == int(v["adj_index"])
    for name in ("coords", "height", "error", "adj_window", "adjustment"):
        err = np.abs(c[name] - v[name]).max()
        assert err <= VIVALDI_SCALE_RTOL * np.abs(v[name]).max(), \
            f"{where}coords.{name}: {err}"


def _assert_run(want: dict, want_frac, got: dict, got_frac, where: str):
    np.testing.assert_array_equal(got_frac, want_frac)
    assert_leaves(want["swim"], got["swim"], only=int_leaves(want["swim"]),
                  where=where + "swim.")
    assert_leaves(want["events"], got["events"], where=where + "events.")
    _assert_vivaldi(want["coords"], got["coords"], where)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_sharded_serf_run_from_init_state_matches_jax(blocks):
    want, want_frac = _jax_trajectory(False)
    got, frac = _port_trajectory(blocks)
    _assert_run(want, want_frac, got, frac, f"B={blocks}: ")


@pytest.mark.parametrize("blocks", BLOCKS)
def test_sharded_serf_run_from_init_state_equals_the_unsharded_port(blocks):
    want, want_frac = _port_trajectory(1)
    got, frac = _port_trajectory(blocks)
    np.testing.assert_array_equal(frac, want_frac)
    for part in ("swim", "coords", "events"):
        assert_leaves(want[part], got[part], rtol=0, where=f"{part}.")


def test_sharded_serf_run_matches_jax_eight_device_sharded_run():
    """B = 8 against JAX's own 8-device sharded serf.run (one compile)."""
    want, want_frac = _jax_trajectory(True)
    got, frac = _port_trajectory(8)
    _assert_run(want, want_frac, got, frac, "8-device: ")


def test_sharded_run_crosses_commits_and_evictions():
    """150 ticks with two kills at alloc_cap 4: the sharded pool commits
    the deaths (K12's release), evicts under pressure (K8) and stays
    bit-equal to the unsharded port in every leaf, plain and chaos."""
    for mode in MODES:
        res = []
        for blocks in (1, 4):
            p = _port_params(256, mode, blocks, alloc_cap=4, p_loss=0.05)
            s = serf.init_state(p, device="cpu")
            s = s.replace(swim=swim.kill(swim.kill(s.swim, 3), 200))
            if blocks > 1:
                s = mesh.shard_state(s, _cpu_mesh(blocks))
            out, frac = serf.run(p, s, 150, 3)
            res.append((convert.cluster_state_to_numpy(
                mesh.unshard_state(out)), frac))
        (want, wf), (got, gf) = res
        assert torch.equal(wf, gf)
        assert float(wf[-1]) == 1.0
        assert int(want["swim"]["committed_dead"].sum()) == 2
        for part in ("swim", "coords", "events"):
            assert_leaves(want[part], got[part], rtol=0,
                          where=f"{mode} {part}.")


# ------------------------------------------------------------ K1 offsets

@pytest.mark.parametrize("blocks,n", [(b, n) for b in BLOCKS for n in SIZES]
                         + [(8, 1000)])
def test_block_draws_are_the_rows_of_the_whole_draw(blocks, n):
    """prng.draw_blocks: block b of each node-leading draw holds rows [bL,
    (b + 1)L) of the whole draw (each element from its global index), the
    offsets replicated; L * width not a multiple of 4 included."""
    key = prng.tick_key(11, 35, 1)
    draws = [prng.Draw("uniform", key, (n,)), prng.Draw("exponential", key,
                                                         (n,)),
             prng.Draw("normal", key, (n, 8)), prng.Draw("uniform", key, (n, 3)),
             prng.Draw("bits", key, (n, 5)), prng.Draw("randint", key, (n, 2),
                                                       0, 97),
             prng.Draw("randint", key, (4,), 1, n)]
    like = mesh.shard_state(torch.zeros(n, dtype=torch.bool),
                            _cpu_mesh(blocks), n)
    whole = prng.draw_plain(draws, "cpu")
    got = prng.draw_blocks(draws, like)
    for d, w, g in zip(draws, whole, got):
        if d.shape[0] == n:
            assert isinstance(g, mesh.Blocks)
            assert torch.equal(mesh.unshard_state(g), w), d
        else:
            assert isinstance(g, mesh.Replicated)
            assert torch.equal(g.home, w)


# ------------------------------------------------------ index-0 sentinels

def _sentinel_state(blocks, n=64):
    """A port state whose every block's row 0 holds a value the masked
    lanes' index-0 scatter would change (committed_inc and incarnation at
    -5, each map at -7), with no rumor subject in block 0, and slots that
    commit alive at 50% coverage while others do not."""
    tp = _port_params(n, "plain", blocks)
    s = serf.init_state(tp, device="cpu").swim
    ell = n // blocks
    firsts = torch.arange(0, n, ell)
    inc = torch.zeros(n, dtype=torch.int32)
    inc[firsts] = -5
    u = U
    subj = torch.tensor([ell + 1 + k % (ell - 1) for k in range(u)],
                        dtype=torch.int32)          # block 1, not its row 0
    s = s.replace(committed_inc=inc.clone(), incarnation=inc.clone(),
                  r_active=torch.ones(u, dtype=torch.bool),
                  r_kind=torch.tensor([swim.ALIVE] * (u // 2)
                                      + [swim.SUSPECT] * (u - u // 2),
                                      dtype=torch.int8),
                  r_subject=subj, r_inc=torch.full((u,), 3, dtype=torch.int32),
                  r_start=torch.zeros(u, dtype=torch.int32),
                  know=torch.ones((n, u), dtype=torch.bool))
    return tp, s.replace(tick=10 ** 4), firsts


@pytest.mark.parametrize("blocks", BLOCKS)
def test_masked_lanes_land_on_global_row_0_only(blocks):
    """With no subject in block 0, the masked lanes of _release's
    committed_inc scatter (max with 0), _refutation's incarnation scatter
    (max with -1) and K9's map updates (max with -1, min with 1 << 30) land
    on node 0 alone, never on another block's row 0."""
    tp, s, firsts = _sentinel_state(blocks)
    sh = mesh.shard_state(s, _cpu_mesh(blocks))
    want = swim._expire_plain(tp.swim, s)
    got = mesh.unshard_state(swim_blocks.expire_plain(tp.swim, sh))
    assert torch.equal(got.committed_inc, want.committed_inc)
    assert int(want.committed_inc[0]) == 0
    assert (want.committed_inc[firsts[1:]] == -5).all()
    # refutation: suspect slots whose subjects know them, up, members
    want = swim._refutation_plain(tp.swim, s)
    got = mesh.unshard_state(swim_blocks.refutation_plain(tp.swim, sh))
    assert torch.equal(got.incarnation, want.incarnation)
    assert int(want.incarnation[0]) == -1
    assert (want.incarnation[firsts[1:]] == -5).all()
    # the maps: a masked pair and a slot that does not convert
    n = s.up.shape[0]
    m = torch.full((n,), 3, dtype=torch.int32)
    m[firsts] = -7
    pairs = (torch.tensor([n - 1, 0], dtype=torch.int32),
             torch.tensor([2, 5], dtype=torch.int32),
             torch.tensor([True, False]))
    bm = mesh.shard_state(m, _cpu_mesh(blocks), n)
    got = mesh.unshard_state(swim_blocks.map_add_plain(bm, *pairs))
    want = swim._map_add_plain(m, *pairs)
    assert torch.equal(got, want) and int(want[0]) == -1
    assert (want[firsts[1:]] == -7).all()
    conv = torch.zeros(U, dtype=torch.bool)
    conv[U - 1] = True
    maps = (m, m.clone(), m.clone(), m.clone())
    want = swim._maps_convert_plain(maps, s, conv)
    got = swim_blocks.maps_convert_plain(tuple(
        mesh.shard_state(x, _cpu_mesh(blocks), n) for x in maps), sh, conv)
    for a, b in zip(want, got):
        assert torch.equal(a, mesh.unshard_state(b))


# -------------------------------------------------- origination, metrics

@pytest.mark.parametrize("evicting", (False, True))
@pytest.mark.parametrize("blocks", BLOCKS)
def test_block_originate_matches_jax(blocks, evicting):
    """K8's block twin against JAX's _originate and the unsharded twin, with
    and without the pressure eviction (every slot active and fully
    disseminated, so demand exceeds the free slots), wants tied across
    blocks."""
    jp, js = _probe_state(256, "plain")
    p, s = jp.swim, js.swim
    if evicting:
        u = U
        s = s.replace(r_active=jnp.ones(u, bool),
                      r_kind=jnp.asarray(np.arange(u) % 4, np.int8),
                      r_subject=jnp.asarray(np.arange(u) * 13 + 7, np.int32),
                      know=jnp.ones_like(s.know))
    want = np.zeros(256, np.int32)
    want[[5, 70, 71, 130, 200, 255]] = [2, 3, 3, 1, 3, 2]
    rs = np.where(np.arange(256) % 9 == 0, np.arange(256)[::-1], -1) \
        .astype(np.int32)
    ja, jalloc = jswim._originate(p, s, jnp.asarray(want), jswim.DEAD,
                                  s.incarnation, jnp.asarray(rs))
    tp = _port_params(256, "plain", blocks).swim
    ts = convert.swim_state_from_numpy(jax_dict(s), "cpu")
    ua, ualloc = swim._originate_plain(tp, ts, torch.from_numpy(want),
                                       swim.DEAD, ts.incarnation,
                                       torch.from_numpy(rs))
    m = _cpu_mesh(blocks)
    sh = mesh.shard_state(ts, m)
    ba, balloc = swim_blocks.originate_plain(
        tp, sh, mesh.shard_state(torch.from_numpy(want), m, 256), swim.DEAD,
        sh.incarnation, mesh.shard_state(torch.from_numpy(rs), m, 256))
    got = _swim_dict(ba)
    assert_leaves(convert.swim_state_to_numpy(ua), got, rtol=0)
    assert_leaves(jax_dict(ja), got, rtol=1e-6)
    for a, b, c in zip(ualloc, balloc, jalloc):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    if evicting:
        assert int(got["committed_dead"].sum()) > 0


@pytest.mark.parametrize("blocks", BLOCKS)
def test_metrics_vector_on_blocks(blocks):
    """swim.metrics_vector of a sharded state: every gauge bit-equal to the
    unsharded vector's except bulk.coverage, a float32 sum of the bulk
    members' coverage added block by block (within rtol 1e-6)."""
    _, js = _probe_state(256, "plain")
    ts = convert.swim_state_from_numpy(jax_dict(js.swim), "cpu")
    gen = torch.Generator().manual_seed(blocks)
    bulk = torch.rand(256, generator=gen) < 0.2
    ts = ts.replace(bulk_member=bulk,
                    bulk_cov=torch.where(bulk, torch.rand(256, generator=gen),
                                         0.0),
                    awareness=(torch.rand(256, generator=gen) * 8).to(
                        torch.int8))
    tp = _port_params(256, "plain", blocks).swim
    want = swim.metrics_vector(tp, ts)
    got = swim.metrics_vector(tp, mesh.shard_state(ts, _cpu_mesh(blocks)))
    at = swim.METRIC_NAMES.index("bulk.coverage")
    keep = [i for i in range(len(want)) if i != at]
    assert torch.equal(got[keep], want[keep])
    np.testing.assert_allclose(float(got[at]), float(want[at]), rtol=1e-6)
    ref = np.asarray(jswim.metrics_vector(
        jswim.make_params(jconfig.GossipConfig.lan(),
                          _sim(jconfig, 256, "plain")),
        js.swim.replace(**{k: jnp.asarray(getattr(ts, k).numpy())
                           for k in ("bulk_member", "bulk_cov",
                                     "awareness")})))
    np.testing.assert_array_equal(got.numpy()[keep], ref[keep])
    np.testing.assert_allclose(float(got[at]), ref[at], rtol=1e-6)


# ---------------------------------------------- the bench and the oracle

def test_bench_run_convergence_on_a_mesh_equals_the_unsharded_run():
    """bench.run_convergence(mesh=) at N = 256: the pool sharded from
    init_state, the same ticks, fractions, F1, false commits, counters and
    final state as the unsharded run, one flag read a probe tick."""
    kw = dict(n_nodes=256, chunk=20, victim=17, max_ticks=300)
    a = bench.run_convergence(device="cpu", **kw)
    b = bench.run_convergence(mesh=_cpu_mesh(4), **kw)
    assert a["converged"] and b["converged"]
    for k in ("ticks", "fracs", "f1", "false_commits", "sim_counters",
              "host_syncs", "timed_ticks_run"):
        assert a[k] == b[k], k
    assert b["topology"]["mesh_shape"] == {mesh.NODE_AXIS: 4}
    assert b["state"].swim.know.n_blocks == 4
    got = convert.cluster_state_to_numpy(mesh.unshard_state(b["state"]))
    want = convert.cluster_state_to_numpy(a["state"])
    for part in ("swim", "coords", "events"):
        assert_leaves(want[part], got[part], rtol=0, where=f"{part}.")


def test_sharded_oracle_commands_equal_the_unsharded_oracle():
    """GossipOracle(mesh=): warmup, advance, kill, revive and sim_metrics
    give what the unsharded oracle gives, and the pool stays sharded."""
    sim = config.SimConfig(n_nodes=64, rumor_slots=8)
    ref = poracle.GossipOracle(sim=sim, device="cpu")
    sh = poracle.GossipOracle(sim=sim, device="cpu", mesh=_cpu_mesh(4))
    for o in (ref, sh):
        o.warmup()
        o.advance(7)
        o.kill("node5")
        o.advance(60)
        o.revive("node9")
        o.advance(13)
    assert sh.sim_metrics() == ref.sim_metrics()
    assert sh.members_summary() == ref.members_summary()
    assert sh.members_summary()["failed"] == 1
    assert sh.tick == ref.tick == 80
    mesh.assert_node_sharded(sh._state.swim.know, 4, "oracle state")
    got = convert.cluster_state_to_numpy(mesh.unshard_state(sh._state))
    want = convert.cluster_state_to_numpy(ref._state)
    for part in ("swim", "coords", "events"):
        assert_leaves(want[part], got[part], rtol=0, where=f"{part}.")


# ------------------------------------------------ the 3b-ii refusal

def _probe_passes(params, s):
    """The unsharded probe tick's passes (swim.step_with_obs before its
    gossip), with the bulk flag they set."""
    maps = swim._maps(params, s)
    s, obs, maps = swim._probe_round(params, s, maps)
    s, conv = swim._suspicion_expiry(params, s)
    maps = swim._maps_convert(maps, s, conv)
    s = swim._dense_suspicion_expiry(params, s, obs.shift, maps)
    s = swim._expire(params, swim._refutation(params, s))
    return s.replace(bulk_live=swim._bulk_flag(s.bulk_member))


def test_a_probe_tick_that_fills_the_bulk_channel_raises_on_a_mesh():
    """Dense timers expiring at more subjects than alloc_cap rumors put the
    rest into the bulk channel: the unsharded tick does, and the sharded
    tick raises BulkChannelLive (a NotImplementedError naming ROADMAP
    queue A item 3b-ii, the bulk channel over blocks) carrying the state
    its probe passes left, equal in every leaf to the unsharded passes',
    tick not advanced, bulk_live set; a tick from that state refuses
    before anything runs and carries the state it was given."""
    tp = _port_params(64, "plain", 4, alloc_cap=1)
    s = serf.init_state(tp, device="cpu").swim
    down = torch.arange(64) % 7 == 3
    start = torch.where(down, 0, -1).to(torch.int32)
    s = s.replace(up=~down, sus_start=start,
                  sus_confirm=down.to(torch.int8), tick=200)
    ref = swim.step(tp.swim, s.clone())
    assert ref.bulk_live
    passes = _probe_passes(tp.swim, s.clone())
    sh = mesh.shard_state(s, _cpu_mesh(4))
    with pytest.raises(mesh.BulkChannelLive, match="3b-ii") as err:
        swim.step(tp.swim, sh)
    left = err.value.state
    assert isinstance(err.value, NotImplementedError)
    assert left.bulk_live and left.tick == 200
    assert_leaves(convert.swim_state_to_numpy(passes), _swim_dict(left),
                  rtol=0)
    with pytest.raises(mesh.BulkChannelLive, match="3b-ii") as again:
        swim.step(tp.swim, left)
    assert again.value.state is left
    with pytest.raises(mesh.BulkChannelLive, match="3b-ii"):
        swim.step(tp.swim, dataclasses.replace(sh, bulk_live=True, tick=201))
