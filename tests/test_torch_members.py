"""The port's oracle reads and membership commands against the JAX
package on the CPU (P2), and `serf.run` at `shard_blocks=4` (P3).

States come from one JAX `serf.run` at N=256, U=16 over a sparse pool
(240 of 256 slots joined), converted through numpy: after two kills
committed to death and a leave, after a rejoin of a committed node, a
second leave and a join into a free slot, and in the middle of a mass
kill of 41 nodes (active dead rumors, the bulk channel).  On each, the
port's status vector, counts, page, delta (every output, the padded
`state` rows included, with `n_changed` above and below k and k above
N), per-shard gauges at 4 blocks and `_coord_row` are bit-equal to the
JAX functions; `rtt_order` gives the same order, with distances within
1e-6 relative (the norms sum in another order); `rejoin` and `leave`
leave every int/bool leaf bit-equal.  These are the plain twins of K4,
which the port's CPU path runs.  One SimConfig serves every test, so
the JAX jits compile once.
"""

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
from consul_tpu.oracle import _coord_row as j_coord_row
from consul_tpu_torch import config, convert, kernels
from consul_tpu_torch.models import serf, swim, vivaldi
from consul_tpu_torch.oracle import _coord_row

N, U, N_INITIAL = 256, 16, 240


def _sim(cfg, **kw):
    return cfg.SimConfig(n_nodes=N, rumor_slots=U, n_initial=N_INITIAL,
                         p_loss=0.01, seed=3, **kw)


JP = jserf.make_params(jconfig.GossipConfig.lan(), _sim(jconfig))
TP = serf.make_params(config.GossipConfig.lan(), _sim(config))

_run = jax.jit(jserf.run, static_argnums=(0, 2, 3))
_status = jax.jit(jserf.status_vector, static_argnums=0)
_counts = jax.jit(jserf.membership_counts, static_argnums=0)
_page = jax.jit(jserf.membership_page, static_argnums=0)
_delta = jax.jit(jserf.membership_delta, static_argnums=(0, 4))
_shards = jax.jit(jserf.shard_metrics, static_argnums=(0, 2))
_rtt_order = jax.jit(jserf.rtt_order, static_argnums=0)
_rejoin = jax.jit(jswim.rejoin, static_argnums=0)
_leave = jax.jit(jswim.leave, static_argnums=0)


def _swim(js, fn, *args):
    return js.replace(swim=fn(JP.swim, js.swim, *args))


@functools.lru_cache(maxsize=None)
def _states():
    """{name: JAX ClusterState} along one run, and the provisioned mask of
    each."""
    s = jserf.init_state(JP, n_initial=N_INITIAL)
    s, _ = _run(JP, s, 10)
    s = s.replace(swim=jswim.kill(jswim.kill(s.swim, 9), 77))
    s = _swim(s, _leave, 30)
    s, _ = _run(JP, s, 200)
    prov = np.arange(N) < N_INITIAL
    out = {"committed": (s, prov.copy())}
    s = _swim(s, _rejoin, 9)
    s = _swim(s, _leave, 31)
    s = _swim(s, _rejoin, 245)               # a join into a free slot
    prov[245] = True
    s, _ = _run(JP, s, 5)
    out["rejoined"] = (s, prov.copy())
    for i in range(100, 141):
        s = s.replace(swim=jswim.kill(s.swim, i))
    s, _ = _run(JP, s, 70)
    out["mass"] = (s, prov.copy())
    return out


def _port(js):
    return convert.cluster_state_from_numpy(
        {"swim": jax_dict(js.swim), "coords": jax_dict(js.coords),
         "events": jax_dict(js.events)}, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f"{what}: {b.dtype}{b.shape} vs {a.dtype}{a.shape}"
    np.testing.assert_array_equal(b, a, err_msg=what)


def test_states_hold_what_the_reads_need():
    """The run reaches the cases the reads must handle."""
    st = _states()
    s = st["committed"][0].swim
    assert bool(s.committed_dead[9]) and bool(s.committed_dead[77])
    assert not bool(s.member[30])
    r = st["rejoined"][0].swim
    assert not bool(r.committed_dead[9]) and bool(r.member[245])
    m = st["mass"][0].swim
    dead = np.asarray(m.r_active & (m.r_kind == jswim.DEAD))
    assert dead.any(), "no active dead rumor mid mass kill"
    assert np.asarray(m.bulk_member).any(), "the bulk channel is empty"
    status = np.asarray(_status(JP, st["mass"][0]))
    assert (status == 0).any() and (status == 1).any() and (status == 2).any()


@pytest.mark.parametrize("name", ["committed", "rejoined", "mass"])
def test_status_counts_page_and_shards(name):
    js, prov = _states()[name]
    ts = _port(js)
    _eq(_status(JP, js), serf.status_vector(TP, ts), f"{name} status")
    _eq(_counts(JP, js, jnp.asarray(prov)),
        serf.membership_counts(TP, ts, _t(prov)), f"{name} counts")
    ids = np.array([0, 9, 30, 31, 77, 100, 120, 245, 255, 3, -1, N + 5,
                    -N - 9, 0, 0, 0], np.int32)
    for a, b, what in zip(_page(JP, js, jnp.asarray(ids)),
                          serf.membership_page(TP, ts, _t(ids)),
                          ("status", "incarnation", "up")):
        _eq(a, b, f"{name} page {what}")
    _eq(_shards(JP, js, 4), serf.shard_metrics(TP, ts, 4), f"{name} shards")


DELTAS = {
    # case: (state, checkpoint state or None for the all -1 first call, k)
    "first call, k < n_changed": ("committed", None, 8),
    "first call, k > N": ("committed", None, 512),
    "rejoin, k > n_changed": ("rejoined", "committed", 64),
    "mass kill, k < n_changed": ("mass", "rejoined", 8),
    "mass kill, k = N": ("mass", "rejoined", 256),
    "no change": ("mass", "mass", 16),
}


@pytest.mark.parametrize("case", sorted(DELTAS))
def test_membership_delta(case):
    name, since, k = DELTAS[case]
    js, prov = _states()[name]
    prev = np.full(N, -1, np.int8) if since is None else \
        np.asarray(_status(JP, _states()[since][0]))
    want = _delta(JP, js, jnp.asarray(prev), jnp.asarray(prov), k)
    got = serf.membership_delta(TP, _port(js), _t(prev), _t(prov), k)
    for a, b, what in zip(want, got, ("status", "n_changed", "idx", "state")):
        _eq(a, b, f"{case}: {what}")
    n_changed = int(want[1])
    assert (n_changed > k) == (case in ("first call, k < n_changed",
                                        "mass kill, k < n_changed"))
    if k > n_changed:       # the pad rows: idx -1, state = status[0]
        assert (np.asarray(got[2])[n_changed:] == -1).all()


# ---------------------------------------------------------------------------
# K4's scan and emit (members.cu), transcribed in numpy
# ---------------------------------------------------------------------------

ONES = np.uint32(0x01010101)


def _words(x):
    """A uint8 vector padded with zero bytes to whole words, as uint32."""
    x = np.asarray(x).astype(np.uint8)
    return np.concatenate([x, np.zeros(-len(x) % 4, np.uint8)]).view(np.uint32)


def _bytes(w, n):
    return w.view(np.uint8)[:n]


def _ne4(a, b):
    """__vcmpne4: 0xff in each byte where a's and b's differ."""
    ne = _bytes(a, 4 * len(a)) != _bytes(b, 4 * len(b))
    return _words(np.where(ne, 0xff, 0))


def _popc(w):
    return int(np.unpackbits(w.view(np.uint8)).sum())


def _k4_scan(d, prov, prev, tile, per):
    """members_scan over numpy leaves `d`: a block a tile of `tile` nodes
    (`tile // per` threads of `per` nodes), the tile's dead subjects as a
    bitmap (active dead slots whose subject lies in the tile), statuses
    from the bytes (SWAR on words), counts by popcounts over provisioned
    nodes, each tile's changed count, then the completing block's
    inclusive prefix.  Returns (status int8, counts [5], prefix)."""
    n = len(d["member"])
    dead = np.zeros(n, bool)
    for base in range(0, n, tile):
        bitmap = np.zeros(tile, bool)
        for s in range(len(d["r_active"])):
            subject = int(d["r_subject"][s])
            subject += n if subject < 0 else 0      # [-N, 0) wraps once
            off = subject - base
            if d["r_active"][s] and d["r_kind"][s] == jswim.DEAD \
                    and 0 <= subject < n and 0 <= off < tile:
                bitmap[off] = True
        dead[base:base + tile] = bitmap[:min(tile, n - base)]
    mem, cd, cl = (_words(d[k]) for k in ("member", "committed_dead",
                                          "committed_left"))
    left = (cl | (mem ^ ONES)) & ONES
    failed = (cd | _words(dead)) & ~left & ONES
    st = (left << 1) | failed
    pv, pr = _words(prov), _words(prev.view(np.uint8))
    changed = _ne4(st, pr) & pv & ONES
    counts = [_popc(~(failed | left) & pv & ONES), _popc(failed & pv),
              _popc(left & pv), _popc(pv & ONES), _popc(changed)]
    ch = _bytes(changed, n).astype(np.int64)
    tiles = [int(ch[b:b + tile].sum()) for b in range(0, n, tile)]
    return (_bytes(st, n).view(np.int8).copy(), np.array(counts, np.int32),
            np.cumsum(tiles).astype(np.int32), ch)


def _k4_emit(status, changed, prefix, k, tile, per):
    """members_emit: block b reads prefix[b - 1], prefix[b] and the total,
    writes its share of the pad rows (idx -1, state status[0]) and, when
    its tile holds a changed node and the prefix before it is below k,
    ranks the tile's changed nodes thread by thread (an exclusive scan of
    the threads' counts) and writes those of rank < k."""
    n = len(status)
    idx = np.full(k, 12345, np.int32)
    state = np.full(k, 99, np.int8)
    total = int(prefix[-1])
    idx[total:] = -1
    state[total:] = status[0]
    for b, base in enumerate(range(0, n, tile)):
        before = int(prefix[b - 1]) if b else 0
        if prefix[b] == before or before >= k:
            continue
        mine = [changed[i:min(i + per, n)].sum()
                for i in range(base, base + tile, per)]
        rank = before + np.concatenate([[0], np.cumsum(mine)[:-1]])
        for j, i0 in enumerate(range(base, base + tile, per)):
            r = int(rank[j])
            for i in range(i0, min(i0 + per, n)):
                if changed[i] and r < k:
                    idx[r], state[r] = i, status[i]
                if changed[i]:
                    r += 1
    return idx, state


# dead subjects outside [0, N): JAX's scatter wraps [-N, 0) once (-1 marks
# N - 1, 5 - N marks 5, -N marks 0) and drops the rest (N, N + 1, -N - 1)
OUT_OF_RANGE = [-1, N + 1, 5 - N, -N, N, -N - 1]


def _edged(name, edges=(0, 3, 4, 7, 8, 15, 16, N - 1, 3, N - 1)):
    """A state of _states() with its dead subjects on the tiles' edges of
    the transcription (0, tile - 1, tile, N - 1 for tiles of 4, 8 and
    16), some named twice, beside the run's own rumors; or at `edges`."""
    js, prov = _states()[name]
    d = jax_dict(js.swim)
    edges = list(edges)
    for k in ("r_active", "r_kind", "r_subject"):
        d[k] = d[k].copy()
    d["r_active"][:len(edges)] = True
    d["r_kind"][:len(edges)] = jswim.DEAD
    d["r_subject"][:len(edges)] = edges
    sw = js.swim.replace(**{k: jnp.asarray(d[k]) for k in
                            ("r_active", "r_kind", "r_subject")})
    return js.replace(swim=sw), prov, d


K4_TILES = ((1, 1), (4, 2), (8, 4), (16, 4), (12, 3))


@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("case", ["committed", "rejoined", "mass",
                                  "mass, edges", "rejoined, edges",
                                  "mass, out of range"])
@pytest.mark.parametrize("k", (4, 64, 512))
def test_k4_scan_and_emit_transcription(case, tile, k):
    """The transcription of K4's tile bitmap, the scan's completing-block
    prefix and the emit's ranks (tiles of 1-16 nodes) gives the plain
    twin's and the JAX membership_delta's outputs, with k below and above
    n_changed."""
    name = case.split(",")[0]
    if case.endswith("edges"):
        js, prov, d = _edged(name)
    elif case.endswith("out of range"):
        js, prov, d = _edged(name, OUT_OF_RANGE)
    else:
        js, prov = _states()[name]
        d = jax_dict(js.swim)
    since = {"committed": None, "rejoined": "committed", "mass": "rejoined"}
    prev = np.full(N, -1, np.int8) if since[name] is None else \
        np.asarray(_status(JP, _states()[since[name]][0]))
    want = _delta(JP, js, jnp.asarray(prev), jnp.asarray(prov), k)
    plain = swim.membership_delta_plain(
        TP.swim, _port(js).swim, _t(prev), _t(prov), k)
    st, counts, prefix, changed = _k4_scan(d, prov, prev, *tile)
    idx, state = _k4_emit(st, changed, prefix, k, *tile)
    for a, b, what in ((st, want[0], "status"),
                       (counts[4], want[1], "n_changed"),
                       (idx, want[2], "idx"), (state, want[3], "state")):
        _eq(b, a, f"{case} {tile} k={k}: {what}")
    for a, b, what in zip(want, plain,
                          ("status", "n_changed", "idx", "state")):
        _eq(a, b, f"{case} plain {what}")
    _eq(_counts(JP, js, jnp.asarray(prov)), counts[:4], f"{case} counts")


@pytest.mark.parametrize("name", ["committed", "rejoined", "mass"])
def test_reads_with_dead_subjects_out_of_range(name):
    """Active dead rumors about subjects outside [0, N) (-1, N + 1 and
    the other edges of OUT_OF_RANGE): the status, counts, page and delta
    agree with JAX, which wraps [-N, 0) once and drops the rest."""
    js, prov, _ = _edged(name, OUT_OF_RANGE)
    ts = _port(js)
    status = np.asarray(_status(JP, js))
    assert status[N - 1] == 1 or not np.asarray(js.swim.member)[N - 1] \
        or np.asarray(js.swim.committed_left)[N - 1]
    _eq(status, serf.status_vector(TP, ts), f"{name} status")
    _eq(_counts(JP, js, jnp.asarray(prov)),
        serf.membership_counts(TP, ts, _t(prov)), f"{name} counts")
    ids = np.array([0, 5, N - 1, 1, N + 1, -1], np.int32)
    for a, b, what in zip(_page(JP, js, jnp.asarray(ids)),
                          serf.membership_page(TP, ts, _t(ids)),
                          ("status", "incarnation", "up")):
        _eq(a, b, f"{name} page {what}")
    prev = np.asarray(_status(JP, _states()[name][0]))
    want = _delta(JP, js, jnp.asarray(prev), jnp.asarray(prov), 16)
    got = serf.membership_delta(TP, ts, _t(prev), _t(prov), 16)
    for a, b, what in zip(want, got, ("status", "n_changed", "idx", "state")):
        _eq(a, b, f"{name} delta {what}")


@pytest.mark.parametrize("name", ["committed", "mass"])
def test_rtt_order_estimate_and_coord_row(name):
    js, _ = _states()[name]
    ts = _port(js)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, N, 64).astype(np.int32)
    valid = np.arange(64) < 50
    ids[50:] = 0
    for origin in (0, 17, 200):
        want = np.asarray(_rtt_order(JP, js, jnp.int32(origin),
                                     jnp.asarray(ids), jnp.asarray(valid)))
        got = serf.rtt_order(TP, ts, origin, _t(ids), _t(valid)).numpy()
        _eq(want, got, f"{name} rtt_order from {origin}")
        src = np.full(64, origin, np.int32)
        ref = np.asarray(jvivaldi.estimate_rtt(js.coords, jnp.asarray(src),
                                               jnp.asarray(ids)))
        est = vivaldi.estimate_rtt(ts.coords, _t(src), _t(ids)).numpy()
        np.testing.assert_allclose(est, ref, rtol=1e-6, atol=0)
        raw = np.asarray(jvivaldi.raw_distance(js.coords, jnp.asarray(src),
                                               jnp.asarray(ids)))
        np.testing.assert_allclose(
            vivaldi.raw_distance(ts.coords, _t(src), _t(ids)).numpy(), raw,
            rtol=1e-6, atol=0)
    for i in (0, 9, 123, 255):
        for a, b in zip(j_coord_row(js.coords, jnp.int32(i)),
                        _coord_row(ts.coords, i)):
            _eq(np.asarray(a).view(np.int32), b.numpy().view(np.int32),
                f"{name} coord row {i}")


@pytest.mark.parametrize("command,node", [("rejoin", 9), ("rejoin", 77),
                                          ("rejoin", 250), ("leave", 50),
                                          ("leave", 30)])
def test_rejoin_and_leave(command, node):
    js, _ = _states()["committed"]
    fn = {"rejoin": (_rejoin, swim.rejoin), "leave": (_leave, swim.leave)}
    want = jax_dict(fn[command][0](JP.swim, js.swim, node))
    got = fn[command][1](TP.swim, _port(js).swim, node)
    assert_leaves(want, convert.swim_state_to_numpy(got),
                  only=int_leaves(want), where=f"{command}({node}) ")


def test_serf_run_at_four_shard_blocks_matches_reference():
    """P3 at shard_blocks=4 on one device: every int/bool leaf equal to
    the JAX run at the same config, tick by tick, through a kill and its
    convergence (the JAX run takes its sharded top-k and block rotations,
    which give the same result as one block)."""
    kw = dict(n_nodes=128, rumor_slots=16, p_loss=0.01, seed=5,
              shard_blocks=4)
    jp = jserf.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(**kw))
    tp = serf.make_params(config.GossipConfig.lan(), config.SimConfig(**kw))
    assert tp.swim.shard_blocks == 4
    kernels.reset_launches()    # what other tests' stub launches counted
    js, ts = jserf.init_state(jp), serf.init_state(tp, device="cpu")
    step = jax.jit(jserf.step, static_argnums=0)
    for t in range(120):
        if t == 10:
            js = js.replace(swim=jswim.kill(js.swim, 9))
            ts = ts.replace(swim=swim.kill(ts.swim, 9))
        js = step(jp, js)
        ts = serf.step(tp, ts)
        a = jax_dict(js.swim)
        assert_leaves(a, convert.swim_state_to_numpy(ts.swim),
                      only=int_leaves(a), where=f"tick {ts.swim.tick}: ")
    assert bool(np.asarray(js.swim.committed_dead)[9]) or \
        bool(np.asarray(js.swim.r_active & (js.swim.r_kind == jswim.DEAD)
                        & (js.swim.r_subject == 9)).any())
    assert kernels.LAUNCHES == {k: 0 for k in kernels.KERNELS}
