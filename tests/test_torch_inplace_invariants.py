"""What the in-place designs of K9's updates and K12-K14 rest on, held on
the JAX reference on the CPU, under hypothesis.

On the card K9's map_add and maps_convert, K12's refutation and expire,
K13's ring observation and K14's bulk step write only the cells that can
change (maps.cu, refute.cu, vivaldi.cu, bulk.cu).  Those kernels
are right only if the reference itself changes nothing else, so each
property draws a state with numpy from a seed, converts it with
`convert.py` into the port's state and from there into the JAX one, runs
the JAX pass, and holds the change it made to those cells:

- `_refutation` changes incarnation only at the needing slots' subjects
  and at node 0 (the masked scatter-max's -1), awareness only where a
  bump or the clamp to [0, awareness_max - 1] moves it, the rows only in
  the needing columns (with each needing slot's subject still knowing
  it: the cell the decision reads), and the table only at needing slots;
- `_expire` changes the committed leaves only at the done slots'
  subjects and node 0, know and sends_left only in the done columns, and
  learn_tick nowhere;
- `observe_ring` changes adj_window only in column adj_index % W, and
  only on acked rows;
- `_bulk_commit(_bulk_disseminate(s))` changes bulk_cov only at members
  and where the input is not 0, and bulk_member and committed_dead only
  at the subjects it commits (members whose coverage reached the bar);
- `_map_add` changes its map only at the subjects of its ok pairs and at
  index 0, `_maps_convert` suspect_of and dead_of only at the converting
  slots' subjects and at index 0.

Each also holds the port's twin to the JAX result (int and bool leaves
bit-equal; floats within the tolerances of test_torch_expiry.py and
test_torch_ring_bulk.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import example, given, settings, strategies as st

from torch_parity import assert_leaves, jax_dict

from consul_tpu.models import swim as jswim
from consul_tpu.models import vivaldi as jviv
from consul_tpu import config as jconfig
from consul_tpu_torch import config, convert
from consul_tpu_torch.models import swim, vivaldi

SCALE_RTOL = 1e-5     # test_torch_ring_bulk.py's bound for the ring floats
BULK_RTOL = 1e-5      # and for the bulk channel's


def _swim_dict(seed: int, n: int, u: int, amax: int) -> dict:
    """A swim state as numpy leaves: rumors of every kind about a few
    subjects (duplicates), some of them live subjects that know their own
    suspect or dead rumor at an incarnation that refutes, windows that
    have passed, scores outside [0, amax - 1] and incarnations below -1
    (node 0's masked rule)."""
    rng = np.random.default_rng(seed)
    tick = int(rng.integers(2_000, 70_000))
    subjects = rng.integers(0, n, max(1, min(n, 4)))
    up, member = rng.random(n) < 0.8, rng.random(n) < 0.9
    r_subject = subjects[rng.integers(0, len(subjects), u)].astype(np.int32)
    incarnation = rng.integers(-3, 4, n).astype(np.int32)
    know = rng.random((n, u)) < rng.choice([0.1, 0.6, 0.995, 1.0], u)[None, :]
    know[r_subject, np.arange(u)] |= rng.random(u) < 0.7
    learn = rng.integers(-2 ** 15, 2 ** 15, (n, u)).astype(np.int16)
    return dict(
        tick=np.int32(tick), up=up, member=member, incarnation=incarnation,
        coords=rng.random((n, 2)).astype(np.float32),
        committed_dead=rng.random(n) < 0.1,
        committed_left=rng.random(n) < 0.05,
        committed_inc=rng.integers(-2, 3, n).astype(np.int32),
        r_active=rng.random(u) < 0.8,
        r_kind=rng.integers(0, 4, u).astype(np.int8), r_subject=r_subject,
        r_inc=(incarnation[r_subject] + rng.integers(-1, 2, u)).astype(
            np.int32),
        r_start=(tick - rng.integers(0, 4_000, u)).astype(np.int32),
        r_confirm=rng.integers(0, 65, u).astype(np.int8),
        r_coverage=rng.random(u).astype(np.float32),
        know=know, learn_tick=learn,
        sends_left=rng.integers(0, 20, (n, u)).astype(np.int8),
        sus_start=np.full(n, -1, np.int32),
        sus_confirm=np.zeros(n, np.int8), sus_count=np.zeros(n, np.int32),
        bulk_member=np.zeros(n, bool), bulk_heard=np.zeros(n, np.float32),
        bulk_cov=np.zeros(n, np.float32),
        awareness=rng.integers(-4, max(amax, 1) + 4, n).astype(np.int8),
        chaos_grp=np.zeros(n, np.int16), chaos_ok=np.ones(n, np.float32),
        ctr=np.zeros(swim.CTR_N, np.float32))


def _params(n: int, u: int, amax: int):
    sim = dict(n_nodes=n, rumor_slots=u, alloc_cap=8, p_loss=0.01, seed=3)
    jg = dataclasses.replace(jconfig.GossipConfig.lan(),
                             awareness_max_multiplier=amax)
    tg = dataclasses.replace(config.GossipConfig.lan(),
                             awareness_max_multiplier=amax)
    return (jswim.make_params(jg, jconfig.SimConfig(**sim)),
            swim.make_params(tg, config.SimConfig(**sim)))


def _pair(d: dict):
    """(the JAX state, the port's state) of one numpy state."""
    ts = convert.swim_state_from_numpy(d, device="cpu")
    nd = convert.swim_state_to_numpy(ts)
    js = jswim.SwimState(**{f.name: jnp.asarray(nd[f.name])
                            for f in dataclasses.fields(jswim.SwimState)})
    return js, ts


def _changed(before, after) -> np.ndarray:
    return np.asarray(before) != np.asarray(after)


SHAPES = st.sampled_from(((1, 2), (7, 8), (40, 16), (40, 33)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), shape=SHAPES,
       amax=st.sampled_from((0, 1, 8)))
def test_reference_refutation_changes_only_what_k12_writes(seed, shape,
                                                          amax):
    n, u = shape
    d = _swim_dict(seed, n, u, amax)
    jp, tp = _params(n, u, amax)
    js, ts = _pair(d)
    out = jax_dict(jswim._refutation(jp, js))
    before = jax_dict(js)
    subj = before["r_subject"]
    need = before["r_active"] & np.isin(before["r_kind"],
                                        (swim.SUSPECT, swim.DEAD)) \
        & before["know"][subj, np.arange(u)] & before["up"][subj] \
        & before["member"][subj] \
        & (before["r_inc"] >= before["incarnation"][subj])
    subjects = set(subj[need].tolist())
    masked = not need.all()
    moved = set(np.flatnonzero(_changed(before["incarnation"],
                                        out["incarnation"])).tolist())
    assert moved <= subjects | ({0} if masked else set())
    aw = before["awareness"].astype(np.int64)
    bumps = np.bincount(subj[need], minlength=n)
    could = (bumps > 0) | (aw < 0) | (aw > max(jp.awareness_max - 1, 0))
    aw_moved = _changed(before["awareness"], out["awareness"])
    assert not (aw_moved & ~could).any()
    if jp.awareness_max == 0:
        assert not aw_moved.any()
    for f in ("know", "learn_tick", "sends_left"):
        assert not _changed(before[f], out[f])[:, ~need].any(), f
    # the cell the kernel's decision reads stays set under the rewrite
    assert out["know"][subj[need], np.flatnonzero(need)].all()
    for f in ("r_kind", "r_inc", "r_start"):
        assert not _changed(before[f], out[f])[~need].any(), f
    assert_leaves(out, convert.swim_state_to_numpy(
        swim._refutation(tp, ts)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), shape=SHAPES)
def test_reference_expire_changes_only_what_k12_writes(seed, shape):
    n, u = shape
    d = _swim_dict(seed, n, u, 8)
    jp, tp = _params(n, u, 8)
    js, ts = _pair(d)
    out = jax_dict(jswim._expire(jp, js))
    before = jax_dict(js)
    done = before["r_active"] & ~out["r_active"]
    nodes = set(before["r_subject"][done].tolist()) | {0}
    for f in ("committed_dead", "committed_left", "committed_inc"):
        moved = set(np.flatnonzero(_changed(before[f], out[f])).tolist())
        assert moved <= nodes, f
    for f in ("know", "sends_left"):
        assert not _changed(before[f], out[f])[:, ~done].any(), f
    assert not _changed(before["learn_tick"], out["learn_tick"]).any()
    assert_leaves(out, convert.swim_state_to_numpy(swim._expire(tp, ts)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.sampled_from((1, 15, 64)),
       adj_index=st.integers(0, 200), w=st.sampled_from((1, 7, 20)))
# a one-row pool whose window's 20 values (~1e-4) cancel to a mean of
# ~5e-8: XLA sums them in order, torch pairwise, 1.5e-12 apart
@example(seed=101, n=1, adj_index=0, w=20)
def test_reference_ring_changes_one_window_column_on_acked_rows(
        seed, n, adj_index, w):
    rng = np.random.default_rng(seed)
    d = {"coords": (rng.standard_normal((n, 8)) * 0.02).astype(np.float32),
         "height": (rng.random(n) * 1e-3 + 1e-5).astype(np.float32),
         "error": (rng.random(n) * 1.4 + 0.05).astype(np.float32),
         "adj_window": (rng.standard_normal((n, w)) * 1e-4).astype(
             np.float32),
         "adj_index": np.int32(adj_index),
         "adjustment": (rng.standard_normal(n) * 1e-4).astype(np.float32)}
    shift = int(rng.integers(0, n))
    rtt_ms = (rng.random(n) * 50).astype(np.float32)
    acked = rng.random(n) < 0.7
    ts = convert.vivaldi_state_from_numpy(d, "cpu")
    nd = convert.vivaldi_state_to_numpy(ts)
    jp = jviv.VivaldiParams(n_nodes=n, dims=8, adjustment_window=w, seed=seed)
    tp = vivaldi.VivaldiParams(n_nodes=n, dims=8, adjustment_window=w,
                               seed=seed)
    js = jviv.VivaldiState(**{k: jnp.asarray(v) for k, v in nd.items()})
    out = jviv.observe_ring(jp, js, jnp.int32(shift),
                            jnp.asarray(rtt_ms / np.float32(1000.0)),
                            jnp.asarray(acked))
    moved = _changed(nd["adj_window"], out.adj_window)
    col = adj_index % w
    assert not np.delete(moved, col, axis=1).any()
    assert not moved[~acked, col].any()
    got = vivaldi.observe_ring_plain(
        tp, ts, torch.tensor(shift, dtype=torch.int32),
        torch.from_numpy(rtt_ms), torch.from_numpy(acked))
    for f in ("coords", "height", "error", "adj_window", "adjustment"):
        ref, mine = np.asarray(getattr(out, f)), getattr(got, f).numpy()
        err = np.abs(mine.astype(np.float64) - ref).max()
        # the adjustment is the mean of the window's W values: its rounding
        # follows the order of their sum, so it is held to their scale
        scale = np.abs(np.asarray(out.adj_window) if f == "adjustment"
                       else ref).max()
        assert err <= SCALE_RTOL * max(scale, 1e-30), f


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.sampled_from((1, 7, 40, 300)),
       members=st.sampled_from((0.02, 0.3, 1.0)),
       near_bar=st.sampled_from((0.0, 0.5, 1.0)), chaos=st.booleans())
def test_reference_bulk_step_changes_only_what_k14_writes(seed, n, members,
                                                          near_bar, chaos):
    rng = np.random.default_rng(seed)
    d = _swim_dict(seed, n, 8, 8)
    bm = rng.random(n) < members
    bm[0] |= not bm.any()
    cov = rng.random(n).astype(np.float32)
    close = rng.random(n) < near_bar
    cov[close] = np.float32(0.993) + np.float32(0.007) * rng.random(
        close.sum()).astype(np.float32)
    cov[~bm & (rng.random(n) < 0.5)] = 0.0      # some non-members at 0
    d.update(bulk_member=bm, bulk_cov=cov,
             bulk_heard=(rng.random(n) * bm.sum() * 1.5).astype(np.float32))
    if chaos:
        d.update(chaos_grp=(rng.random(n) < 0.25).astype(np.int16),
                 chaos_ok=np.where(rng.random(n) < 0.1, 0.55, 1.0).astype(
                     np.float32))
    jp, tp = _params(n, 8, 8)
    jp = dataclasses.replace(jp, chaos=chaos)
    tp = dataclasses.replace(tp, chaos=chaos)
    js, ts = _pair(d)
    out = jax_dict(jswim._bulk_commit(jp, jswim._bulk_disseminate(jp, js)))
    before = jax_dict(js)
    member = before["bulk_member"]
    cov_moved = _changed(before["bulk_cov"].view(np.int32),
                         out["bulk_cov"].view(np.int32))
    assert not (cov_moved & ~member & (before["bulk_cov"] == 0)).any()
    done = member & ~out["bulk_member"]
    assert not (_changed(before["bulk_member"], out["bulk_member"])
                & ~done).any()
    assert not (_changed(before["committed_dead"], out["committed_dead"])
                & ~done).any()
    assert (out["committed_dead"][done]).all()
    for f in before:
        if f not in swim.BULK_INPLACE:
            np.testing.assert_array_equal(out[f], before[f], err_msg=f)
    got = convert.swim_state_to_numpy(swim._bulk_step_plain(tp, ts))
    for f in ("bulk_member", "committed_dead"):
        np.testing.assert_array_equal(got[f], out[f], err_msg=f)
    for f in ("bulk_heard", "bulk_cov"):
        err = np.abs(got[f].astype(np.float64) - out[f]).max()
        assert err <= BULK_RTOL * max(np.abs(out[f]).max(), 1e-30), f


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), shape=SHAPES, a=st.integers(1, 64))
def test_reference_map_updates_change_only_what_k9_writes(seed, shape, a):
    n, u = shape
    rng = np.random.default_rng(seed)
    d = _swim_dict(seed, n, u, 8)
    jp, tp = _params(n, u, 8)
    js, ts = _pair(d)
    maps = jswim._maps(jp, js)
    subj = rng.integers(0, n, a).astype(np.int32)
    slots = rng.integers(-1, u, a).astype(np.int32)
    ok = rng.random(a) < rng.choice((0.5, 1.0))
    added = np.asarray(jswim._map_add(maps[2], jnp.asarray(subj),
                                      jnp.asarray(slots), jnp.asarray(ok)))
    moved = set(np.flatnonzero(_changed(maps[2], added)).tolist())
    assert moved <= set(subj[ok].tolist()) | ({0} if not ok.all() else set())
    np.testing.assert_array_equal(added, swim._map_add_plain(
        torch.from_numpy(np.array(maps[2])), torch.from_numpy(subj),
        torch.from_numpy(slots), torch.from_numpy(ok)).numpy())
    conv = rng.random(u) < rng.choice((0.3, 1.0))
    out = jswim._maps_convert(maps, js, jnp.asarray(conv))
    nodes = set(d["r_subject"][conv].tolist()) \
        | ({0} if not conv.all() else set())
    for k in (0, 1):
        moved = set(np.flatnonzero(_changed(maps[k], out[k])).tolist())
        assert moved <= nodes, k
    for k in (2, 3):
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(maps[k]))
    tmaps = tuple(torch.from_numpy(np.array(m)) for m in maps)
    got = swim._maps_convert_plain(tmaps, ts, torch.from_numpy(conv))
    for k in range(4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(out[k]))
