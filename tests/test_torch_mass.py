"""The port's mass-event helpers and benches against the JAX package on
the CPU.

P2: `kill_mask`, `revive_mask`, `revive` and `inject_suspicion` on a JAX
state some 60 ticks after a mass kill (N=256, U=16: suspect and dead
rumors, dense timers, a bulk channel), every leaf bit-equal.  K5's plain
twin, `mass_detection_stats_plain`, bit-equal (recall's float32 bits,
the int32 count) to JAX `mass_detection_stats` on states built on its
edges: duplicate subjects across slots, a LEFT slot, coverage just below
and exactly at the 0.99 bar, `bulk_cov` at 0.99, zero victims, U = 64.
The port's correlated-failure bench at N=4096 against the JAX tool's
loop (the same recall and false-positive curves and `conv_ticks_99`),
and leave propagation at N=2048 against the JAX tool's steps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_leaves, jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import swim as jswim
from consul_tpu_torch import config, convert, correlated, kernels
from consul_tpu_torch import leave_propagation
from consul_tpu_torch.models import swim

_run = jax.jit(jswim.run, static_argnums=(0, 2, 3))
_mass = jax.jit(jswim.mass_detection_stats, static_argnums=0)


def _params(n=256, u=16, p_loss=0.01, seed=9):
    sim = dict(n_nodes=n, rumor_slots=u, p_loss=p_loss, seed=seed)
    return (jswim.make_params(jconfig.GossipConfig.lan(),
                              jconfig.SimConfig(**sim)),
            swim.make_params(config.GossipConfig.lan(),
                             config.SimConfig(**sim)))


VICTIMS = np.random.default_rng(1).choice(256, 30, replace=False)


@functools.lru_cache(maxsize=None)
def _reference(u=16):
    """(jax params, port params, a JAX state 60 ticks after killing 30 of
    256 nodes, the victim mask)."""
    jp, tp = _params(u=u)
    s = jswim.init_state(jp)
    s, _ = _run(jp, s, 10)
    mask = np.zeros(256, bool)
    mask[VICTIMS] = True
    s = jswim.kill_mask(s, jnp.asarray(mask))
    s, _ = _run(jp, s, 60)
    return jp, tp, s, mask


def _port(s):
    return convert.swim_state_from_numpy(jax_dict(s), device="cpu")


def _assert_state(js, ts, where=""):
    assert_leaves(jax_dict(js), convert.swim_state_to_numpy(ts), where=where,
                  rtol=0)


def test_reference_state_is_mid_event():
    _, _, js, mask = _reference()
    d = jax_dict(js)
    kinds = d["r_kind"][d["r_active"]]
    assert (kinds == jswim.DEAD).any() and (kinds == jswim.SUSPECT).any()
    assert (d["sus_start"] >= 0).any()
    assert not d["up"][mask].any()


def test_kill_mask():
    _, _, js, _ = _reference()
    extra = np.zeros(256, bool)
    extra[[0, 100, 255]] = True
    _assert_state(jswim.kill_mask(js, jnp.asarray(extra)),
                  swim.kill_mask(_port(js), torch.from_numpy(extra)))


@pytest.mark.parametrize("which", ("victims", "half", "none", "all"))
def test_revive_mask(which):
    """Stale suspect/dead slots of revived nodes withdrawn with their
    cells, the incarnation bump (scatter-max of r_inc + 1; masked slots
    write 0 to node 0), timers and bulk entries reset."""
    _, _, js, mask = _reference()
    m = {"victims": mask, "half": mask & (np.arange(256) % 2 == 0),
         "none": np.zeros(256, bool), "all": np.ones(256, bool)}[which]
    ja = jswim.revive_mask(js, jnp.asarray(m))
    ta = swim.revive_mask(_port(js), torch.from_numpy(m))
    _assert_state(ja, ta, where=f"{which}: ")
    if which == "victims":
        assert int(ta.incarnation.sum()) > int(np.asarray(js.incarnation).sum())
        assert ta.r_active.sum() < int(np.asarray(js.r_active).sum())


def test_revive_mask_withdraws_bulk_entries():
    _, _, js, mask = _reference()
    d = jax_dict(js)
    bm = mask & (np.arange(256) % 3 == 0)
    js = js.replace(bulk_member=jnp.asarray(bm),
                    bulk_cov=jnp.asarray(np.where(bm, 0.4, 0.0)
                                         .astype(np.float32)),
                    bulk_heard=jnp.asarray(np.full(256, 2.5, np.float32)))
    ja = jswim.revive_mask(js, jnp.asarray(mask))
    ta = swim.revive_mask(_port(js), torch.from_numpy(mask))
    _assert_state(ja, ta)
    assert not ta.bulk_member.any() and d["up"].sum() < ta.up.sum()


@pytest.mark.parametrize("node", (int(VICTIMS[0]), int(VICTIMS[7]), 0, 5))
def test_revive(node):
    _, _, js, _ = _reference()
    _assert_state(jswim.revive(js, node), swim.revive(_port(js), node))


@pytest.mark.parametrize("subject,origin", ((3, 200), (int(VICTIMS[2]), 4),
                                            (0, 0)))
def test_inject_suspicion(subject, origin):
    jp, tp, js, _ = _reference()
    _assert_state(jswim.inject_suspicion(jp, js, subject, origin),
                  swim.inject_suspicion(tp, _port(js), subject, origin))


# ---------------------------------------------------------------------------
# K5's plain twin on its edges
# ---------------------------------------------------------------------------

def _edge(case, u=16):
    """(jax params, port params, jax state, port state, victim mask) with
    the rumor table rewritten for one edge of mass_detection_stats."""
    jp, tp, js, mask = _reference(u)
    d = jax_dict(js)
    for k in ("r_active", "r_kind", "r_subject", "know", "committed_dead",
              "committed_left", "bulk_member", "bulk_cov", "up"):
        d[k] = d[k].copy()
    live = d["up"] & d["member"]
    n_live = int(live.sum())
    live_ids = np.flatnonzero(live)
    v = [int(x) for x in VICTIMS]

    def rumor(slot, kind, subject, holders):
        d["r_active"][slot] = True
        d["r_kind"][slot] = kind
        d["r_subject"][slot] = subject
        d["know"][:, slot] = False
        d["know"][live_ids[:holders], slot] = True
        d["know"][~live, slot] = True        # dead rows never count

    # the smallest holder count whose float32 coverage reaches the bar
    at_bar = next(h for h in range(n_live + 1)
                  if np.float32(h) / np.float32(n_live) >= np.float32(0.99))
    # nothing detected unless the case adds it
    d["r_active"][:] = False
    d["committed_dead"][:] = False
    d["committed_left"][:] = False
    d["bulk_member"][:] = False
    d["bulk_cov"][:] = 0.0
    if case == "duplicate_subjects":
        rumor(0, jswim.DEAD, v[0], n_live)
        rumor(1, jswim.DEAD, v[0], n_live)
        rumor(2, jswim.LEFT, v[1], at_bar)
        rumor(u - 1, jswim.DEAD, v[1], n_live)
    elif case == "left_slot":
        rumor(3, jswim.LEFT, v[2], n_live)
        rumor(4, jswim.SUSPECT, v[3], n_live)     # suspect never counts
        rumor(5, jswim.ALIVE, v[4], n_live)
    elif case == "just_below_bar":
        rumor(0, jswim.DEAD, v[5], at_bar - 1)
        rumor(1, jswim.DEAD, v[6], at_bar)
    elif case == "live_subject":
        rumor(0, jswim.DEAD, int(live_ids[3]), n_live)  # a false positive
        d["committed_dead"][live_ids[4]] = True
    elif case == "bulk_at_bar":
        for i, cov in zip(v[:4], (0.99, 0.98999995, 1.0, 0.5)):
            d["bulk_member"][i] = True
            d["bulk_cov"][i] = np.float32(cov)
    elif case == "masked_slot_to_node_0":
        rumor(0, jswim.DEAD, 0, n_live)
        d["r_active"][0] = False                  # inactive: names nobody
        d["up"][0] = True
    elif case == "no_victims":
        mask = np.zeros_like(mask)
        rumor(0, jswim.DEAD, v[0], n_live)
    elif case == "committed":
        d["committed_dead"][v[:10]] = True
        d["committed_left"][v[10:12]] = True
        rumor(0, jswim.DEAD, v[0], n_live)        # already counted
    elif case == "out_of_range_subjects":         # JAX wraps [-N, 0) once
        n = len(d["up"])
        rumor(0, jswim.DEAD, v[0] - n, n_live)    # names v[0]
        rumor(1, jswim.DEAD, n + 1, n_live)       # names nobody
        rumor(2, jswim.LEFT, -1, n_live)          # names n - 1
        rumor(3, jswim.DEAD, -n - 1, n_live)      # names nobody
        rumor(4, jswim.DEAD, n, n_live)           # names nobody
    elif case == "no_live_rows":                  # n_live clamps to 1
        rumor(0, jswim.DEAD, v[3], n_live)        # every row knows, none live
        d["up"][:] = False
        d["committed_dead"][v[:3]] = True
    else:
        raise ValueError(case)
    js = js.replace(**{k: jnp.asarray(x) for k, x in d.items() if k != "tick"})
    return jp, tp, js, convert.swim_state_from_numpy(d, device="cpu"), mask


EDGES = ("duplicate_subjects", "left_slot", "just_below_bar", "live_subject",
         "bulk_at_bar", "masked_slot_to_node_0", "no_victims", "committed",
         "no_live_rows", "out_of_range_subjects")


@pytest.mark.parametrize("u", (16, 64))
@pytest.mark.parametrize("case", EDGES)
def test_mass_detection_stats_edges(case, u):
    jp, tp, js, ts, mask = _edge(case, u)
    jr, jf = _mass(jp, js, jnp.asarray(mask))
    kernels.reset_launches()
    tr, tf = swim.mass_detection_stats(tp, ts, torch.from_numpy(mask))
    pr, pf = swim.mass_detection_stats_plain(tp, ts, torch.from_numpy(mask))
    assert kernels.LAUNCHES == {k: 0 for k in kernels.KERNELS}
    for a, b in ((jr, tr), (jr, pr)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.float32
        assert a.view(np.int32) == b.view(np.int32), (case, float(a), float(b))
    for a, b in ((jf, tf), (jf, pf)):
        assert np.asarray(a).dtype == b.numpy().dtype == np.int32
        assert int(a) == int(b)
    expect = {"duplicate_subjects": lambda r, f: r == np.float32(2) / 30,
              "left_slot": lambda r, f: r == np.float32(1) / 30,
              "just_below_bar": lambda r, f: r == np.float32(1) / 30,
              "live_subject": lambda r, f: f == 2,
              "bulk_at_bar": lambda r, f: r == np.float32(2) / 30,
              "masked_slot_to_node_0": lambda r, f: f == 0,
              "no_victims": lambda r, f: r == 0.0 and f == 0,
              "committed": lambda r, f: r == np.float32(12) / 30,
              "no_live_rows": lambda r, f: r == np.float32(3) / 30 and f == 0,
              "out_of_range_subjects": lambda r, f: r == np.float32(1) / 30
              and f == 1,
              }[case]
    assert expect(np.float32(tr), int(tf)), (case, float(tr), int(tf))


def test_mass_detection_stats_out_slots():
    """With `out`, the results land in the given device slots."""
    jp, tp, js, ts, mask = _edge("committed")
    rec = torch.full((4,), -1.0)
    fp = torch.full((4,), -1, dtype=torch.int32)
    got = swim.mass_detection_stats(tp, ts, torch.from_numpy(mask),
                                    out=(rec[2:3], fp[2:3]))
    assert got[0].data_ptr() == rec[2:3].data_ptr()
    want = swim.mass_detection_stats_plain(tp, ts, torch.from_numpy(mask))
    assert rec.tolist() == [-1.0, -1.0, float(want[0]), -1.0]
    assert fp.tolist() == [-1, -1, int(want[1]), -1]


# ---------------------------------------------------------------------------
# K5's tile walk (detect.cu), transcribed in numpy
# ---------------------------------------------------------------------------

def _k5_walk(d, victim, tile, threads, flush):
    """mass_detect's walk over numpy leaves `d` (know [N, U] and the [N]
    and [U] leaves of a state): tiles of `tile` rows, `threads` threads a
    block (a multiple of 32), W-byte chunks (W the widest of 16, 8, 4, 2,
    1 dividing U), byte lanes of uint8 flushed every `flush` rows, the
    warp sums in 16-bit halves where U / W is a power of two, the leaf
    counters with bulk_cov read only at an uncommitted bulk member, then
    the one-warp tail: float32 coverage, __match_any_sync's
    de-duplication in two passes of 32 slots, the subjects' base mask.
    Returns (recall float32, false positives int)."""
    know = d["know"].astype(np.uint8)
    n, u = know.shape
    up, member = d["up"], d["member"]
    cdead, cleft = d["committed_dead"], d["committed_left"]
    bulk, bulk_cov = d["bulk_member"], d["bulk_cov"]
    w = 16
    while w > 1 and u % w:
        w //= 2
    cpr = u // w
    rows_it = threads // cpr
    cnt = np.zeros(4, np.int64)
    cols = np.zeros(64, np.int64)
    for base in range(0, n, tile):
        rows = min(tile, n - base)
        at = slice(base, base + rows)
        live = member[at] & up[at]
        vic = member[at] & victim[at]
        down = cdead[at] | cleft[at]
        cov = np.where(bulk[at] & ~down, bulk_cov[at], np.float32(0))
        down = down | (cov >= np.float32(0.99))
        cnt += [live.sum(), vic.sum(), (down & vic).sum(), (down & live).sum()]
        acc = np.zeros((threads, w), np.uint8)      # byte lanes
        tile_cols = np.zeros(64, np.int64)
        for t in range(rows_it * cpr):
            q, since = t % cpr, 0
            for r in range(t // cpr, rows, rows_it):
                row = know[base + r, q * w:(q + 1) * w]
                lanes = acc[t].astype(np.int64) + row * live[r]
                assert lanes.max() <= 255, "a byte lane overflowed"
                acc[t] = lanes
                since += 1
                if since == flush:
                    tile_cols[q * w:(q + 1) * w] += acc[t]
                    acc[t] = 0
                    since = 0
        if cpr & (cpr - 1) == 0 and cpr <= 32 and w >= 4:
            for warp in range(threads // 32):
                for q in range(cpr):
                    lanes = [32 * warp + l for l in range(q, 32, cpr)]
                    half = acc[lanes].astype(np.int64).sum(0)
                    assert half.max() < 1 << 16, "a 16-bit half overflowed"
                    tile_cols[q * w:(q + 1) * w] += half
        else:
            for t in range(rows_it * cpr):
                q = t % cpr
                tile_cols[q * w:(q + 1) * w] += acc[t]
        cols += tile_cols
    live_f = np.float32(max(cnt[0], 1))
    subj = np.zeros(64, np.int64)
    subj[:u] = d["r_subject"]
    subj = np.where(subj < 0, subj + n, subj)       # [-N, 0) wraps once
    subj = np.where((subj >= 0) & (subj < n), subj, -1)
    det = np.zeros(64, bool)
    for s in range(u):
        kind = d["r_kind"][s]
        det[s] = d["r_active"][s] and kind in (jswim.DEAD, jswim.LEFT) \
            and np.float32(cols[s]) / live_f >= np.float32(0.99)
    keep = np.zeros(64, bool)
    for lane in range(32):                      # pass 0: a match over lanes
        same = [l for l in range(32) if det[l] and subj[l] == subj[lane]]
        keep[lane] = det[lane] and min(same) == lane
    for lane in range(32):                      # pass 1: lanes, then pass 0
        s = 32 + lane
        same = [l for l in range(32)
                if det[32 + l] and subj[32 + l] == subj[s]]
        dup = min(same, default=lane) < lane or any(
            det[l] and subj[l] == subj[s] for l in range(32))
        keep[s] = det[s] and not dup
    found, fp = int(cnt[2]), int(cnt[3])
    for s in np.flatnonzero(keep):
        i = subj[s]
        if not 0 <= i < n:
            continue
        base_down = cdead[i] or cleft[i] or (
            bulk[i] and bulk_cov[i] >= np.float32(0.99))
        found += bool(not base_down and member[i] and victim[i])
        fp += bool(not base_down and member[i] and up[i])
    return np.float32(found) / np.float32(max(int(cnt[1]), 1)), fp


def _random_mass(u, seed, n=300):
    """A seeded random state of [n, u] around the 0.99 bar: subjects from
    8 nodes (duplicates), ~1% bulk members near their own bar, ~5%
    victims; (jax params, port params, jax state, numpy leaves, mask)."""
    jp, tp = _params(n=n, u=u)
    rng = np.random.default_rng(seed)
    js = jswim.init_state(jp)
    d = jax_dict(js)
    bulk = rng.random(n) < 0.05
    d.update(know=rng.random((n, u)) < 0.985 + 0.015 * rng.random(u),
             up=rng.random(n) < 0.97, member=rng.random(n) < 0.99,
             committed_dead=rng.random(n) < 0.01,
             committed_left=rng.random(n) < 0.005, bulk_member=bulk,
             bulk_cov=np.where(bulk, 0.985 + 0.01 * rng.random(n), 0.0)
             .astype(np.float32),
             r_active=rng.random(u) < 0.9,
             r_kind=rng.integers(0, 4, u).astype(np.int8),
             r_subject=rng.choice(n, 8)[rng.integers(0, 8, u)]
             .astype(np.int32))
    js = js.replace(**{k: jnp.asarray(x) for k, x in d.items() if k != "tick"})
    return jp, tp, js, d, rng.random(n) < 0.05


K5_WALKS = ((1, 32, 3), (3, 32, 3), (16, 64, 255), (7, 64, 3))


@pytest.mark.parametrize("walk", K5_WALKS)
@pytest.mark.parametrize("state", [f"{c} U={u}" for c in EDGES
                                   for u in (16, 64)]
                         + [f"random U={u}" for u in (16, 32, 40, 64)])
def test_k5_tile_walk_matches_the_twin_and_jax(state, walk):
    """The transcription of K5's walk (tiles of 1-16 rows, small flush
    intervals, the warp tail's de-duplication) gives the plain twin's and
    the JAX function's recall bits and false positives."""
    case, u = state.split(" U=")
    if case == "random":
        jp, tp, js, d, mask = _random_mass(int(u), seed=int(u))
    else:
        jp, tp, js, _, mask = _edge(case, int(u))
        d = jax_dict(js)
    jr, jf = _mass(jp, js, jnp.asarray(mask))
    pr, pf = swim.mass_detection_stats_plain(
        tp, convert.swim_state_from_numpy(d, device="cpu"),
        torch.from_numpy(mask))
    wr, wf = _k5_walk(d, mask, *walk)
    bits = np.asarray(jr).view(np.int32)
    assert np.float32(wr).view(np.int32) == bits == pr.numpy().view(np.int32)
    assert wf == int(jf) == int(pf)


# ---------------------------------------------------------------------------
# the benches against the JAX tools' loops
# ---------------------------------------------------------------------------

def _jax_correlated(nodes, frac, max_ticks, chunk, seed, slots=32):
    """tools/correlated_failures.py's loop for one row (its scan of step +
    mass_detection_stats per chunk), returning (recall curve, fp curve,
    conv_ticks_99)."""
    params = jswim.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(
        n_nodes=nodes, rumor_slots=slots, p_loss=0.01, seed=seed))

    def run_chunk(s, mask):
        def body(st, _):
            st = jswim.step(params, st)
            return st, jswim.mass_detection_stats(params, st, mask)
        return jax.lax.scan(body, s, None, length=chunk)

    run_chunk = jax.jit(run_chunk)
    s, _ = _run(params, jswim.init_state(params), 25)
    k = max(1, int(nodes * frac))
    victims = np.random.default_rng(seed).choice(nodes, size=k, replace=False)
    mask = np.zeros(nodes, bool)
    mask[victims] = True
    s = jswim.kill_mask(s, jnp.asarray(mask))
    ticks, rec_curve, fp_curve, conv = 0, [], [], None
    while ticks < max_ticks:
        s, (rec, fp) = run_chunk(s, jnp.asarray(mask))
        rec, fp = np.asarray(rec), np.asarray(fp)
        rec_curve.extend(rec.tolist())
        fp_curve.extend(fp.tolist())
        ticks += chunk
        if conv is None and (rec >= 0.99).any():
            conv = ticks - chunk + int(np.argmax(rec >= 0.99)) + 1
        if rec[-1] >= 0.999:
            break
    return rec_curve, fp_curve, conv


def test_correlated_bench_matches_the_jax_tool():
    """N=4096, 1% (40 victims), 32 slots, 128-tick chunks: the port's
    bench gives the JAX tool's recall and fp curves, bit for bit, and
    its conversion tick."""
    rec, fp, conv = _jax_correlated(4096, 0.01, 1024, 128, 7)
    kernels.reset_launches()
    row = correlated.run(nodes=4096, fractions=[0.01], max_ticks=1024,
                         chunk=128, seed=7, device="cpu")[0]
    assert kernels.LAUNCHES["mass_detect"] == 0     # the CPU takes the twin
    assert row["recall_curve"] == rec
    assert row["fp_curve"] == fp
    assert row["conv_ticks_99"] == conv and conv is not None
    assert row["recall_final"] >= 0.999 and row["false_positives_max"] == 0
    assert row["killed"] == 40 and row["ticks_run"] == len(rec)


def test_leave_propagation_matches_the_jax_tool():
    nodes = 2048
    jp = jswim.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(
        n_nodes=nodes, rumor_slots=32, alloc_cap=8, p_loss=0.01, seed=11))
    s, _ = _run(jp, jswim.init_state(jp), 50)
    s = jswim.leave(jp, s, nodes // 3)
    _, frac = _run(jp, s, 200, nodes // 3)
    frac = np.asarray(frac)
    row = leave_propagation.run(nodes=nodes, device="cpu")
    assert row["detail"]["final_fraction"] == float(frac.max())
    idx = int(np.argmax(frac >= 0.9999))
    assert row["value"] == round((idx + 1) * 0.2, 2)
    assert row["value"] is not None and row["value"] <= 3.0
