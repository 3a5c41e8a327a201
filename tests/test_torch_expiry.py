"""The rest of the probe tick's detector passes (K9-K12) on the CPU.

Their plain twins, through the wrappers on CPU tensors (`swim._maps`,
`_map_add`, `_maps_convert`, `_suspicion_expiry`,
`_dense_suspicion_expiry`, `_refutation`, `_expire`), against the JAX
package at P2 on states captured from JAX `swim.run`s: a lossy LAN pool
(refutations, converting slots, frees), a mass kill at U = 8 (dense
conversions, the bulk overflow, evictions), and pools of fewer than a
warp (N = 15 at U = 16 and N = 6 at U = 8); chaos (the overflow off),
`awareness_max = 0`, a refuted dead rumor, two refuting slots of one
subject and maps left stale by an eviction are edits of those states.
Int/bool leaves bit-equal, float leaves within rtol 1e-6 (the swim
tests' tolerance).  Then the kernels' decompositions, transcribed in
numpy and held to the twins under hypothesis: K9's block-range build
and its atomic patches in any order, K10's column or then apply, K11's
writes of want[j] from thread i and its overflow count, K12's
refutation and its coverage counted over the refuted columns.  Last,
the ctypes side: argument order parsed from the C signatures, rejected
tensors, no twin on a card-flagged tensor.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from torch_parity import assert_leaves, jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import swim as jswim
from consul_tpu_torch import config, convert, kernels
from consul_tpu_torch.models import swim, vivaldi

_run = jax.jit(jswim.run, static_argnums=(0, 2, 3))
_jmaps = jax.jit(jswim._maps, static_argnums=0)
_jexpiry = jax.jit(jswim._suspicion_expiry, static_argnums=0)
_jdense = jax.jit(jswim._dense_suspicion_expiry, static_argnums=0)
_jrefute = jax.jit(jswim._refutation, static_argnums=0)
_jexpire = jax.jit(jswim._expire, static_argnums=0)
_jconvert = jax.jit(jswim._maps_convert)
_jadd = jax.jit(jswim._map_add)
_jorig = jax.jit(jswim._originate, static_argnums=(0, 3))

# name: (gossip config, n, u, alloc_cap, p_loss, kills)
MODES = {
    "lossy": ("lan", 256, 16, 8, 0.1, (9, 77)),
    "mass": ("lan", 256, 8, 4, 0.01, tuple(range(3, 256, 6))),
    "wan_15x16": ("wan", 15, 16, 8, 0.01, (4,)),
    "wan_6x8": ("wan", 6, 8, 8, 0.01, (2,)),
}
STATES = 24     # probe-tick states a mode captures, one a probe period


def _params(mode, **overrides):
    gossip, n, u, alloc, p_loss = MODES[mode][:5]
    sim = dict(n_nodes=n, rumor_slots=u, alloc_cap=alloc, p_loss=p_loss,
               seed=3)
    jg = getattr(jconfig.GossipConfig, gossip)()
    tg = getattr(config.GossipConfig, gossip)()
    jp = jswim.make_params(jg, jconfig.SimConfig(**sim))
    tp = swim.make_params(tg, config.SimConfig(**sim))
    return dataclasses.replace(jp, **overrides), \
        dataclasses.replace(tp, **overrides)


@functools.lru_cache(maxsize=None)
def _states(mode):
    """(jax params, port params, the JAX probe-tick states of the mode's
    run: kills at tick 10, then every probe tick's state)."""
    jp, tp = _params(mode)
    period = jp.probe_period_ticks
    s = jswim.init_state(jp)
    s, _ = _run(jp, s, 10)
    for v in MODES[mode][5]:
        s = jswim.kill(s, v)
    out = []
    for _ in range(STATES):
        s, _ = _run(jp, s, period)
        out.append(s)
    return jp, tp, tuple(out)


def _port(js):
    return convert.swim_state_from_numpy(jax_dict(js), device="cpu")


def _jax(d: dict):
    return jswim.SwimState(**{f.name: jnp.asarray(d[f.name])
                              for f in dataclasses.fields(jswim.SwimState)})


def _assert_state(js, ts, where=""):
    assert_leaves(jax_dict(js), convert.swim_state_to_numpy(ts), where=where,
                  rtol=1e-6)


def _assert_maps(jm, tm, where=""):
    for a, b, name in zip(jm, tm, ("suspect_of", "dead_of", "left_of",
                                   "alive_val")):
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=where + name)


def _flow(jp, tp, js):
    """The probe tick's detector passes after the probe round, on one
    state in both packages: K10, maps_convert, K11 (at a fixed shift),
    K12's refutation and expire, each held; returns what they did."""
    ts = _port(js)
    jm, tm = _jmaps(jp, js), swim._maps(tp, ts)
    _assert_maps(jm, tm, "maps ")
    ja, jconv = _jexpiry(jp, js)
    ta, tconv = swim._suspicion_expiry(tp, ts)
    _assert_state(ja, ta, "expiry ")
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    jm2, tm2 = _jconvert(jm, ja, jconv), swim._maps_convert(tm, ta, tconv)
    _assert_maps(jm2, tm2, "maps_convert ")
    shift = 1 + int(js.tick) % (jp.n_nodes - 1) if jp.n_nodes > 1 else 0
    jd = _jdense(jp, ja, jnp.int32(shift), jm2)
    td = swim._dense_suspicion_expiry(tp, ta, torch.tensor(shift,
                                                           dtype=torch.int32),
                                      tm2)
    _assert_state(jd, td, "dense ")
    jr, tr = _jrefute(jp, jd), swim._refutation(tp, td)
    _assert_state(jr, tr, "refutation ")
    je, te = _jexpire(jp, jr), swim._expire(tp, tr)
    _assert_state(je, te, "expire ")
    return {"converted": int(tconv.sum()),
            "dense_dead": int((ta.r_active & (ta.r_kind == swim.SUSPECT)
                               & (td.r_kind == swim.DEAD)).sum()),
            "overflow": int((td.bulk_member & ~ta.bulk_member).sum()),
            "refuted": int((tr.r_kind != td.r_kind).sum()),
            "freed": int((tr.r_active & ~te.r_active).sum())}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_detector_passes_match_reference(mode):
    """K10, maps_convert, K11, K12 along the tick on every captured state;
    the modes reach conversions, overflow, refutations and frees."""
    jp, tp, states = _states(mode)
    seen = [_flow(jp, tp, js) for js in states]
    total = {k: sum(x[k] for x in seen) for k in seen[0]}
    if mode == "lossy":
        assert total["converted"] and total["refuted"] and total["freed"]
    if mode == "mass":
        assert total["dense_dead"] and total["overflow"] and total["freed"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_map_updates_match_reference(mode):
    """_map_add of random (subject, slot, ok) pairs and _maps_convert of
    random conversion masks on each state's maps."""
    jp, tp, states = _states(mode)
    rng = np.random.default_rng(len(mode))
    n, u = jp.n_nodes, jp.rumor_slots
    for js in states[::3]:
        ts = _port(js)
        jm, tm = _jmaps(jp, js), swim._maps(tp, ts)
        a = jp.alloc_cap
        subj = rng.integers(0, n, a).astype(np.int32)
        slots = rng.integers(0, u, a).astype(np.int32)
        ok = rng.random(a) < 0.6
        for jmap, tmap in zip(jm, tm):
            got = swim._map_add(tmap, torch.from_numpy(subj),
                                torch.from_numpy(slots), torch.from_numpy(ok))
            np.testing.assert_array_equal(got.numpy(), np.asarray(_jadd(
                jmap, jnp.asarray(subj), jnp.asarray(slots),
                jnp.asarray(ok))))
        conv = rng.random(u) < 0.4
        _assert_maps(_jconvert(jm, js, jnp.asarray(conv)),
                     swim._maps_convert(tm, ts, torch.from_numpy(conv)))


def test_dense_expiry_chaos_turns_the_overflow_off():
    """The mass states under the chaos params: the same passes, no bulk
    member seeded."""
    jp, tp = _params("mass", chaos=True)
    _, _, states = _states("mass")
    seen = [_flow(jp, tp, js) for js in states]
    assert sum(x["dense_dead"] for x in seen) > 0
    assert sum(x["overflow"] for x in seen) == 0


def _covered(js, slots):
    """js with `slots` dead rumors known by every row: an origination that
    wants more slots than are free evicts and commits them."""
    d = {k: np.array(v, copy=True) for k, v in jax_dict(js).items()}
    d["r_active"][slots] = True
    d["r_kind"][slots] = jswim.DEAD
    d["know"][:, slots] = True
    return _jax(d)


def test_dense_expiry_behind_maps_an_eviction_left_stale():
    """The maps of a state, then an origination that evicts covered dead
    slots: the maps still name the freed slots (stale by design), and the
    dense expiry and the rest of the tick run behind them alike."""
    jp, tp, states = _states("mass")
    rng = np.random.default_rng(5)
    hits = 0
    for js in states[4:12]:
        js = _covered(js, [0, 1])
        ts = _port(js)
        jm, tm = _jmaps(jp, js), swim._maps(tp, ts)
        n = jp.n_nodes
        want = np.where(rng.random(n) < 0.2, 1, 0).astype(np.int32)
        rows = np.where(rng.random(n) < 0.3, rng.integers(0, n, n),
                        -1).astype(np.int32)
        jo, jalloc = _jorig(jp, js, jnp.asarray(want), jswim.SUSPECT,
                            js.incarnation, jnp.asarray(rows))
        to, talloc = swim._originate(tp, ts, torch.from_numpy(want),
                                     swim.SUSPECT, ts.incarnation,
                                     torch.from_numpy(rows))
        _assert_state(jo, to, "originate ")
        jm1 = (_jadd(jm[0], *jalloc), *jm[1:])
        tm1 = (swim._map_add(tm[0], *talloc), *tm[1:])
        _assert_maps(jm1, tm1, "map_add ")
        rebuilt = swim._maps(tp, to)
        hits += sum(int((x != y).sum()) for x, y in zip(tm1, rebuilt))
        ja, jconv = _jexpiry(jp, jo)
        ta, tconv = swim._suspicion_expiry(tp, to)
        jm2, tm2 = _jconvert(jm1, ja, jconv), swim._maps_convert(tm1, ta,
                                                                  tconv)
        for shift in (1, n - 1):
            jd = _jdense(jp, ja, jnp.int32(shift), jm2)
            td = swim._dense_suspicion_expiry(tp, ta, torch.tensor(
                shift, dtype=torch.int32), tm2)
            _assert_state(jd, td, f"dense shift {shift} ")
    assert hits > 0


def _refuters(js, kinds=(jswim.SUSPECT, jswim.DEAD)):
    """js with slots 0 and 1 rumors of `kinds` about one live member that
    knows them, at its incarnation and one above."""
    d = {k: np.array(v, copy=True) for k, v in jax_dict(js).items()}
    live = np.flatnonzero(d["up"] & d["member"])
    subj = int(live[len(live) // 2])
    for slot, kind in enumerate(kinds):
        d["r_active"][slot] = True
        d["r_kind"][slot] = kind
        d["r_subject"][slot] = subj
        d["r_inc"][slot] = d["incarnation"][subj] + slot
        d["know"][subj, slot] = True
    d["awareness"][subj] = 1
    return _jax(d), subj


@pytest.mark.parametrize("amax", (None, 0))
@pytest.mark.parametrize("mode", ("lossy", "wan_6x8"))
def test_refutation_of_two_slots_and_a_dead_rumor(mode, amax):
    """A suspect and a dead rumor of one live subject both refute: the
    incarnation takes the larger bump, the score rises by two (or stays
    with awareness_max = 0), both slots turn alive at that incarnation;
    then expire on the refuted state."""
    over = {} if amax is None else {"awareness_max": amax}
    jp, tp = _params(mode, **over)
    _, _, states = _states(mode)
    js, subj = _refuters(states[5])
    ts = _port(js)
    jr, tr = _jrefute(jp, js), swim._refutation(tp, ts)
    _assert_state(jr, tr)
    assert tr.r_kind[:2].tolist() == [swim.ALIVE, swim.ALIVE]
    inc = int(ts.incarnation[subj])
    assert tr.r_inc[:2].tolist() == [inc + 2, inc + 2]
    assert int(tr.incarnation[subj]) == inc + 2
    want = 1 if amax == 0 else min(3, tp.awareness_max - 1)
    assert int(tr.awareness[subj]) == want
    _assert_state(_jexpire(jp, jr), swim._expire(tp, tr))


# ---------------------------------------------------------------------------
# the kernels' decompositions, transcribed in numpy
# ---------------------------------------------------------------------------

def _i32(x) -> int:
    """x as int32 arithmetic wraps it."""
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _random_state(seed: int, n: int, u: int, amax: int = 8):
    """Small port state with every leaf the detector passes read drawn at
    random: rumors of every kind about a few subjects (duplicates), learn
    ticks up to 300 ticks old and 5% whose int16 age wraps, running and
    expired dense timers, committed and bulk nodes."""
    rng = np.random.default_rng(seed)
    tick = int(rng.integers(200, 70_000))
    t16 = swim._t16(tick)
    subjects = rng.integers(0, n, max(1, min(n, 5)))
    age = np.where(rng.random((n, u)) < 0.05, rng.integers(33_000, 60_000,
                                                           (n, u)),
                   rng.integers(0, 300, (n, u)))
    learn = (t16 - age) % 65536
    learn = np.where(learn >= 32768, learn - 65536, learn).astype(np.int16)
    up, member = rng.random(n) < 0.8, rng.random(n) < 0.9
    d = dict(
        up=up, member=member,
        incarnation=rng.integers(0, 4, n).astype(np.int32),
        coords=rng.random((n, 2)).astype(np.float32),
        committed_dead=rng.random(n) < 0.1, committed_left=rng.random(n) < 0.05,
        committed_inc=rng.integers(0, 3, n).astype(np.int32),
        r_active=rng.random(u) < 0.8,
        r_kind=rng.integers(0, 4, u).astype(np.int8),
        r_subject=subjects[rng.integers(0, len(subjects), u)].astype(np.int32),
        r_inc=rng.integers(0, 4, u).astype(np.int32),
        r_start=(tick - rng.integers(0, 1000, u)).astype(np.int32),
        r_confirm=rng.integers(0, 65, u).astype(np.int8),
        r_coverage=rng.random(u).astype(np.float32),
        know=rng.random((n, u)) < rng.choice([0.2, 0.9, 1.0], u)[None, :],
        learn_tick=learn,
        sends_left=rng.integers(0, 20, (n, u)).astype(np.int8),
        sus_start=np.where(rng.random(n) < 0.5, tick - rng.integers(0, 900, n),
                           -1).astype(np.int32),
        sus_confirm=rng.integers(0, 65, n).astype(np.int8),
        bulk_member=rng.random(n) < 0.1,
        bulk_heard=(rng.random(n) * 50).astype(np.float32),
        bulk_cov=rng.random(n).astype(np.float32),
        awareness=rng.integers(0, max(amax, 1), n).astype(np.int8),
        sus_count=rng.integers(0, 3, n).astype(np.int32),
        chaos_grp=np.zeros(n, np.int16), chaos_ok=np.ones(n, np.float32),
        ctr=np.zeros(swim.CTR_N, np.float32), tick=np.int32(tick))
    return convert.swim_state_from_numpy(d, device="cpu")


def _params_for(n, u, amax=8, chaos=False, alloc=8):
    g = dataclasses.replace(config.GossipConfig.lan(),
                            awareness_max_multiplier=amax)
    return swim.make_params(g, config.SimConfig(
        n_nodes=n, rumor_slots=u, alloc_cap=alloc, p_loss=0.01, seed=3,
        chaos=chaos))


def _np(s):
    return {k: np.array(v, copy=True)
            for k, v in convert.swim_state_to_numpy(s).items()}


MAP_RANGE = 1024      # maps.cu's kRange: the nodes a block owns


def maps_transcription(d, n, u, block_range=MAP_RANGE, offsets=(0, 0, 0, 0)):
    """subject_maps_kernel: block b owns the nodes [b * R, (b + 1) * R);
    its warp lists the active entries of kinds 0-3 whose subject falls in
    that range, in lane order (slots 0-31, then 32-63); thread t writes
    the 4 nodes from lo + 4t of each map: -1, or the largest listed value
    of that kind and node.  A map at element offset `offsets[m]` from a
    16-byte boundary (a row of a [4, N] block) takes one int4 store where
    the group is aligned and whole, else one store a node.  Returns the
    maps and the (vector, scalar) store counts."""
    out = np.full((4, n), -1, np.int64)
    stores = [0, 0]
    row_of = {swim.SUSPECT: 0, swim.DEAD: 1, swim.LEFT: 2, swim.ALIVE: 3}
    for lo in range(0, n, block_range):
        listed = []
        for k in range(u):
            kind = int(d["r_kind"][k])
            subj = int(d["r_subject"][k])
            if d["r_active"][k] and kind in row_of \
                    and lo <= subj < lo + block_range:
                v = _i32(int(d["r_inc"][k]) * u + k) if kind == swim.ALIVE \
                    else k
                listed.append((subj, row_of[kind], v))
        for i0 in range(lo, min(lo + block_range, n), 4):
            group = np.full((4, 4), -1, np.int64)
            for subj, row, v in listed:
                if 0 <= subj - i0 < 4:
                    group[row, subj - i0] = max(group[row, subj - i0], v)
            for row in range(4):
                if i0 + 4 <= n and (offsets[row] + i0) % 4 == 0:
                    out[row, i0:i0 + 4] = group[row]
                    stores[0] += 1
                else:
                    for j in range(4):
                        if i0 + j < n:
                            out[row, i0 + j] = group[row, j]
                            stores[1] += 1
    return out.astype(np.int32), stores


def map_add_transcription(m, subj, slots, ok, order):
    """map_add_kernel: atomicMax(&map[subject], slot) for each pair under
    ok, in `order` (the warp's atomics land in any order), and
    atomicMax(&map[0], -1) when a pair is masked."""
    out = m.copy()
    for k in order:
        if ok[k] and 0 <= subj[k] < len(m):
            out[subj[k]] = max(out[subj[k]], slots[k])
    if not ok.all():
        out[0] = max(out[0], -1)
    return out


def maps_convert_transcription(sus, dead, conv, subject, order):
    """maps_convert_kernel: atomicMin(&suspect_of[subject], -1) and
    atomicMax(&dead_of[subject], u) for each converting slot u, in
    `order`; atomicMin(&suspect_of[0], 1 << 30) and atomicMax(&dead_of[0],
    -1) when not every slot converts."""
    s2, d2 = sus.copy(), dead.copy()
    for k in order:
        if conv[k] and 0 <= subject[k] < len(sus):
            s2[subject[k]] = min(s2[subject[k]], -1)
            d2[subject[k]] = max(d2[subject[k]], k)
    if not conv.all():
        s2[0], d2[0] = min(s2[0], 1 << 30), max(d2[0], -1)
    return s2, d2


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 40),
       u=st.sampled_from((1, 3, 8, 16, 33, 64)),
       block_range=st.sampled_from((4, 8, 12, MAP_RANGE)),
       layout=st.sampled_from(("random", "block boundaries", "one block")),
       offset=st.integers(0, 3))
def test_k9_per_node_lookup_matches_the_scatters(seed, n, u, block_range,
                                                 layout, offset):
    """maps.cu's build, block by block, against _maps_plain: block ranges
    (a few nodes, so a small pool spans several), int4 groups and their
    element-wise fallback (a map off a 16-byte boundary, as the rows of
    the [4, N] block are when N % 4 != 0), a ragged tail, subjects on
    either side of a block boundary, every entry in one block, duplicate
    subjects, negative and wrapping alive values."""
    s = _random_state(seed, n, u)
    rng = np.random.default_rng(seed)
    d = _np(s)
    d["r_inc"][0] = -7
    if layout == "block boundaries":
        edges = [x for b in range(block_range, n, block_range)
                 for x in (b - 1, b)] or [0, n - 1]
        d["r_subject"][:] = np.asarray(edges)[rng.integers(0, len(edges), u)]
    elif layout == "one block":
        lo = int(rng.integers(0, n)) // block_range * block_range
        d["r_subject"][:] = rng.integers(lo, min(lo + block_range, n), u)
    s = convert.swim_state_from_numpy(dict(d, tick=np.int32(s.tick)),
                                      device="cpu")
    p = _params_for(n, u)
    offsets = tuple((offset + m * n) % 4 for m in range(4))
    got, stores = maps_transcription(d, n, u, block_range, offsets)
    for row, m in zip(got, swim._maps_plain(p, s)):
        np.testing.assert_array_equal(row, m.numpy())
    if n % 4:
        assert stores[1] > 0      # the ragged tail


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 40),
       u=st.sampled_from((1, 3, 8, 16, 33, 64)), a=st.integers(1, 64))
def test_k9_atomic_patches_match_the_scatters(seed, n, u, a):
    """map_add's and maps_convert's atomics, applied in place in two
    shuffled orders, give the same maps, and those of the scatter twins:
    duplicate subjects, masked pairs and non-converting slots into index
    0."""
    s = _random_state(seed, n, u)
    rng = np.random.default_rng(seed)
    d = _np(s)
    p = _params_for(n, u)
    maps = swim._maps_plain(p, s)
    subj = rng.integers(0, n, a).astype(np.int32)
    subj[rng.random(a) < 0.3] = subj[0]
    slots = rng.integers(-1, u, a).astype(np.int32)
    ok = rng.random(a) < rng.choice((0.5, 1.0))
    ref = swim._map_add_plain(maps[1], torch.from_numpy(subj),
                              torch.from_numpy(slots),
                              torch.from_numpy(ok)).numpy()
    for order in (rng.permutation(a), rng.permutation(a)):
        np.testing.assert_array_equal(
            map_add_transcription(maps[1].numpy(), subj, slots, ok, order),
            ref)
    conv = rng.random(u) < rng.choice((0.5, 1.0))
    ref = swim._maps_convert_plain(maps, s, torch.from_numpy(conv))
    for order in (rng.permutation(u), rng.permutation(u)):
        got_s, got_d = maps_convert_transcription(
            maps[0].numpy(), maps[1].numpy(), conv, d["r_subject"], order)
        np.testing.assert_array_equal(got_s, ref[0].numpy())
        np.testing.assert_array_equal(got_d, ref[1].numpy())


def _expiry_prelude(d, p, n, u):
    """expiry.cu's prelude: the per-slot values every block computes."""
    table = swim.timeout_table(p)
    pre = []
    for k in range(u):
        subj = int(d["r_subject"][k])
        av = -1
        dead = False
        for v in range(u):
            if d["r_subject"][v] != subj or not d["r_active"][v]:
                continue
            if d["r_kind"][v] == swim.ALIVE:
                av = max(av, _i32(int(d["r_inc"][v]) * u + v))
            dead = dead or d["r_kind"][v] == swim.DEAD
        conf = min(max(int(d["r_confirm"][k]), 0), 64)
        pre.append(dict(
            suspect=bool(d["r_active"][k]) and d["r_kind"][k] == swim.SUSPECT,
            a_slot=av % u if av >= 0 else 0,
            refutable=av >= 0 and av // u > d["r_inc"][k],
            stale=d["r_inc"][k] < d["committed_inc"][subj],
            dead=dead, committed=bool(d["committed_dead"][subj]),
            timeout=np.int16(table[conf])))
    return pre


def _expired_bits(d, pre, i, t16, cols):
    bits = set()
    for k in cols:
        if not d["know"][i, k]:
            continue
        age = np.int16((t16 - int(d["learn_tick"][i, k]) + 2 ** 15) % 2 ** 16
                       - 2 ** 15)
        if age < pre[k]["timeout"]:
            continue
        refuted = (pre[k]["refutable"] and d["know"][i, pre[k]["a_slot"]]) \
            or pre[k]["stale"]
        if not refuted:
            bits.add(k)
    return bits


class _InPlace(dict):
    """The leaves a kernel updates in place (copies of d's), written only
    where a value changes."""

    def __init__(self, d, fields):
        super().__init__({f: d[f].copy() for f in fields})

    def write(self, leaf, at, value):
        assert self[leaf][at] != value, (leaf, at)   # only where it changes
        self[leaf][at] = value


def expiry_transcription(d, p, n, u):
    """expiry.cu, one cooperative launch writing in place: the prelude
    reads the [U] table (its only read of it); the scan ors each live
    row's expired bits into the grid's word; after the grid barrier every
    block decides from its own prelude, block 0 writes r_kind / r_start
    at the converted slots, and thread i rewrites the converted columns of
    row i where a value changes.  A prelude run after the table write
    would lose the converted slots' suspect bits, the race the barrier
    closes."""
    st = _InPlace(d, ("know", "learn_tick", "sends_left", "r_kind",
                      "r_start"))
    pre = _expiry_prelude(d, p, n, u)
    t16 = swim._t16(int(d["tick"]))
    suspect = [k for k in range(u) if pre[k]["suspect"]]
    any_exp = set()
    for i in range(n):
        if d["up"][i] and d["member"][i]:
            any_exp |= _expired_bits(st, pre, i, t16, suspect)
    conv = np.array([k in any_exp and not pre[k]["dead"]
                     and not pre[k]["committed"] for k in range(u)])
    cols = [k for k in range(u) if conv[k]]
    for k in cols:
        st.write("r_kind", k, swim.DEAD)
        if st["r_start"][k] != int(d["tick"]):
            st.write("r_start", k, int(d["tick"]))
    late = _expiry_prelude(dict(d, r_kind=st["r_kind"]), p, n, u)
    assert not any(late[k]["suspect"] for k in cols)
    for i in range(n):
        e = _expired_bits(st, pre, i, t16, cols) \
            if d["up"][i] and d["member"][i] else set()
        for k in cols:
            if st["know"][i, k] and k not in e:
                st.write("know", (i, k), False)
            sends = p.retransmit_limit if k in e else 0
            if st["sends_left"][i, k] != sends:
                st.write("sends_left", (i, k), sends)
            if k in e and st["learn_tick"][i, k] != t16:
                st.write("learn_tick", (i, k), t16)
    return (conv, st["know"], st["learn_tick"], st["sends_left"],
            st["r_kind"], st["r_start"])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 40),
       u=st.sampled_from((2, 8, 16, 33)))
def test_k10_column_or_then_apply_matches_the_twin(seed, n, u):
    s = _random_state(seed, n, u)
    p = _params_for(n, u)
    conv, know, learn, sends, kind, start = expiry_transcription(_np(s), p,
                                                                 n, u)
    ref, rconv = swim._suspicion_expiry_plain(p, s)
    np.testing.assert_array_equal(conv, rconv.numpy())
    for a, b in ((know, ref.know), (learn, ref.learn_tick),
                 (sends, ref.sends_left), (kind, ref.r_kind),
                 (start, ref.r_start)):
        np.testing.assert_array_equal(a, b.numpy())


def dense_pre_transcription(d, p, maps, shift):
    """dense.cu's pre launch, in place: exp_u of the suspect slots from the
    table every block reads first, then thread i writes want at j = (i +
    shift) % N and its own row subject, with the maps converted by exp_u
    in place, and stamps the known cells of the exp_u columns of row i
    where they differ; the sums; last, the last block writes the table.
    Returns (exp, want, rows, the in-place leaves, the sums)."""
    n = len(d["up"])
    u = len(d["r_active"])
    tick = int(d["tick"])
    table = swim.timeout_table(p)
    sus_of, dead_of, left_of = (m.numpy() for m in maps[:3])
    st = _InPlace(d, ("learn_tick", "sends_left", "r_kind", "r_start"))

    def expired(j):
        start = int(d["sus_start"][j])
        if start < 0 or not d["member"][j]:
            return False
        age = tick - start
        if d["up"][j] and age >= p.probe_period_ticks:
            return False
        return age >= table[min(max(int(d["sus_confirm"][j]), 0), 64)]

    exp = np.array([bool(d["r_active"][k]) and d["r_kind"][k] == swim.SUSPECT
                    and expired(int(d["r_subject"][k]))
                    and dead_of[d["r_subject"][k]] < 0
                    and not d["committed_dead"][d["r_subject"][k]]
                    for k in range(u)])
    dd = shift % n
    want = np.full(n, -99, np.int32)
    rows = np.full(n, -99, np.int32)
    t16 = swim._t16(tick)
    for i in range(n):
        j = i + dd - n if i + dd >= n else i + dd
        w = False
        if d["up"][i] and d["member"][i] and not d["committed_dead"][j] \
                and not d["bulk_member"][j] and left_of[j] < 0 and expired(j):
            a, b = int(sus_of[j]), int(dead_of[j])
            for k in range(u):
                if exp[k] and d["r_subject"][k] == j:
                    a, b = min(a, -1), max(b, k)
            if j == 0 and not exp.all():
                a, b = min(a, 1 << 30), max(b, -1)
            w = a < 0 and b < 0
        assert want[j] == -99          # one writer a target
        want[j] = int(w)
        rows[i] = j if w else -1
        for k in range(u):
            if exp[k] and d["know"][i, k]:
                if st["learn_tick"][i, k] != t16:
                    st.write("learn_tick", (i, k), t16)
                if st["sends_left"][i, k] != p.retransmit_limit:
                    st.write("sends_left", (i, k), p.retransmit_limit)
    for k in range(u):          # the last block, after every block read it
        if exp[k]:
            st.write("r_kind", k, swim.DEAD)
            if st["r_start"][k] != tick:
                st.write("r_start", k, tick)
    sums = (int(d["bulk_member"].sum()), int((d["up"] & d["member"]).sum()),
            int(want.sum()))
    return exp, want, rows, st, sums


def dense_post_transcription(d, p, want, dead, left_of, shift, v_prev, v_new,
                             n_live):
    """dense.cu's post launch, in place: thread i reads want and the dead
    rumor (dead_after) at i and at (i + shift) % N, and reads and writes
    only index i of the five leaves, where a value changes."""
    n = len(want)
    st = _InPlace(d, ("bulk_member", "bulk_heard", "bulk_cov", "sus_start",
                      "sus_confirm"))
    share = np.float32(1.0) / np.float32(max(n_live, 1))
    dd = shift % n

    def over_at(j):
        return not p.chaos and want[j] > 0 and dead[j] < 0

    for i in range(n):
        was = bool(st["bulk_member"][i])
        over = over_at(i)
        bulk = was or over
        if bulk and not was:
            st.write("bulk_member", i, True)
        seeded = over_at(i + dd - n if i + dd >= n else i + dd)
        heard = st["bulk_heard"][i]
        h = np.minimum(np.minimum(heard, np.float32(v_prev))
                       + np.float32(seeded), np.float32(v_new))
        if h.view(np.uint32) != heard.view(np.uint32):
            st.write("bulk_heard", i, h)
        if over:
            st["bulk_cov"][i] = share
        start = int(st["sus_start"][i])
        refuted = start >= 0 and d["up"][i] and d["member"][i] \
            and int(d["tick"]) - start >= p.probe_period_ticks
        done = refuted or d["committed_dead"][i] or d["committed_left"][i] \
            or dead[i] >= 0 or left_of[i] >= 0 or not d["member"][i] or bulk
        if done and start != -1:
            st.write("sus_start", i, -1)
        if done and st["sus_confirm"][i] != 0:
            st.write("sus_confirm", i, 0)
    return st


def dense_post_dead_transcription(dead_of, exp, r_subject, subjects, slots,
                                  ok):
    """dense.cu's post launch: node j's dead rumor after maps_convert by
    the converted slots and map_add of the origination's ok pairs, the max
    over the entries whose subject is j (-1 into node 0 if any entry of
    either was masked)."""
    out = dead_of.copy()
    for j in range(len(dead_of)):
        v = int(dead_of[j])
        for k in range(len(exp)):
            if exp[k] and r_subject[k] == j:
                v = max(v, k)
        for k in range(len(ok)):
            if ok[k] and subjects[k] == j:
                v = max(v, int(slots[k]))
        if j == 0 and not (exp.all() and ok.all()):
            v = max(v, -1)
        out[j] = v
    return out


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 40),
       u=st.sampled_from((2, 8, 16)), shift=st.integers(-50, 200),
       alloc=st.integers(1, 8), chaos=st.booleans())
def test_k11_writes_at_the_target_and_counts_the_overflow(seed, n, u, shift,
                                                          alloc, chaos):
    """The pre launch's wants, row subjects and stamps, and the post
    launch's per-node dead rumor and bulk step from v_new = v_prev + wants
    - ok pairs, each written in place only where a value changes, against
    _dense_suspicion_expiry_plain (every leaf) and against the overflow it
    seeds."""
    s = _random_state(seed, n, u)
    p = _params_for(n, u, chaos=chaos, alloc=min(alloc, n, u))
    maps = swim._maps_plain(p, s)
    ref = swim._dense_suspicion_expiry_plain(p, s, torch.tensor(shift), maps)
    d = _np(s)
    exp, want, rows, pre, (v_prev, n_live, wants) = \
        dense_pre_transcription(d, p, maps, shift)
    s1 = s.replace(**{f: torch.from_numpy(v) for f, v in pre.items()})
    maps1 = swim._maps_convert_plain(maps, s1, torch.from_numpy(exp))
    s2, alloc_out = swim._originate_plain(p, s1, torch.from_numpy(want),
                                          swim.DEAD, s1.incarnation,
                                          torch.from_numpy(rows))
    dead2 = dense_post_dead_transcription(
        maps[1].numpy(), exp, d["r_subject"], *(x.numpy() for x in alloc_out))
    np.testing.assert_array_equal(
        dead2, swim._map_add_plain(maps1[1], *alloc_out).numpy())
    over = (want > 0) & (dead2 < 0) & (not chaos)
    n_ok = int(alloc_out[2].sum())
    v_new = v_prev + (0 if chaos else wants - n_ok)
    assert v_new == int((d["bulk_member"] | over).sum())
    post = dense_post_transcription(_np(s2), p, want, dead2,
                                    maps1[2].numpy(), shift, v_prev, v_new,
                                    n_live)
    for f, v in post.items():
        np.testing.assert_array_equal(v, getattr(ref, f).numpy())
    for f in ("know", "learn_tick", "r_kind", "r_start"):
        np.testing.assert_array_equal(getattr(s2, f).numpy(),
                                      getattr(ref, f).numpy())


def refutation_transcription(d, p, n, u):
    """refute.cu's refutation: need[u] from <= 64 gathers, then node i's
    incarnation (max of r_inc + 1), score (plus the count, int8, clamped)
    and row."""
    need = np.array([
        bool(d["r_active"][k]) and d["r_kind"][k] in (swim.SUSPECT, swim.DEAD)
        and d["know"][d["r_subject"][k], k] and d["up"][d["r_subject"][k]]
        and d["member"][d["r_subject"][k]]
        and d["r_inc"][k] >= d["incarnation"][d["r_subject"][k]]
        for k in range(u)])
    inc, aw = d["incarnation"].copy(), d["awareness"].copy()
    know, learn, sends = (d["know"].copy(), d["learn_tick"].copy(),
                          d["sends_left"].copy())
    t16 = swim._t16(int(d["tick"]))
    for i in range(n):
        mine = [k for k in range(u) if need[k] and d["r_subject"][k] == i]
        v = int(inc[i])
        for k in mine:
            v = max(v, _i32(int(d["r_inc"][k]) + 1))
        if i == 0 and not need.all():
            v = max(v, -1)
        inc[i] = v
        if p.awareness_max > 0:
            b = np.int8((int(aw[i]) + len(mine) + 128) % 256 - 128)
            aw[i] = min(max(int(b), 0), p.awareness_max - 1)
        for k in range(u):
            if need[k]:
                at = d["r_subject"][k] == i
                know[i, k] = at
                sends[i, k] = p.retransmit_limit if at else 0
                if at:
                    learn[i, k] = t16
    r_inc = np.array([inc[d["r_subject"][k]] if need[k] else d["r_inc"][k]
                      for k in range(u)], np.int32)
    kind = np.where(need, swim.ALIVE, d["r_kind"]).astype(np.int8)
    start = np.where(need, int(d["tick"]), d["r_start"]).astype(np.int32)
    return dict(d, incarnation=inc, awareness=aw, know=know, learn_tick=learn,
                sends_left=sends, r_inc=r_inc, r_kind=kind, r_start=start)


def expire_transcription(d, p, n, u):
    """refute.cu's expire: per-slot live counts of the (refuted) know, the
    done and commit masks every block derives after the grid barrier, the
    column clears and the committed leaves at the committing subjects."""
    live = d["up"] & d["member"]
    n_live = max(int(live.sum()), 1)
    tick = int(d["tick"])
    cov = np.array([np.float32(int((d["know"][:, k] & live).sum()))
                    / np.float32(n_live) for k in range(u)], np.float32)
    life = np.where(d["r_kind"] == swim.SUSPECT, p.expiry_suspect_ticks,
                    p.expiry_gossip_ticks)
    age = tick - d["r_start"].astype(np.int64)
    done = d["r_active"] & (age >= life) & ((cov >= 0.995) | (age >= 4 * life))
    commit = done & (cov >= 0.5)
    cd, cl, ci = (d["committed_dead"].copy(), d["committed_left"].copy(),
                  d["committed_inc"].copy())
    for i in range(n):
        for k in range(u):
            if d["r_subject"][k] != i:
                continue
            cd[i] |= commit[k] and d["r_kind"][k] == swim.DEAD
            cl[i] |= commit[k] and d["r_kind"][k] == swim.LEFT
            if commit[k] and d["r_kind"][k] == swim.ALIVE:
                ci[i] = max(ci[i], d["r_inc"][k])
    alive_commit = commit & (d["r_kind"] == swim.ALIVE)
    if not alive_commit.all():
        ci[0] = max(ci[0], 0)
    keep = ~done
    return dict(know=d["know"] & keep[None, :],
                sends_left=np.where(keep[None, :], d["sends_left"], 0),
                committed_dead=cd, committed_left=cl, committed_inc=ci,
                r_active=d["r_active"] & keep,
                r_coverage=np.where(keep, cov, np.float32(0)))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 40),
       u=st.sampled_from((2, 8, 16, 33)), amax=st.sampled_from((0, 1, 8)))
def test_k12_refutation_then_expire_over_the_refuted_columns(seed, n, u,
                                                             amax):
    """The refutation node by node, then expire's coverage counted over the
    refuted know (the needing columns one-hot at their subjects), against
    _expire_plain(_refutation_plain(s)); a live subject is made to refute
    with a suspect and a dead rumor where the pool has one."""
    s = _random_state(seed, n, u, amax)
    d = _np(s)
    live = np.flatnonzero(d["up"] & d["member"])
    if len(live) and u >= 2:
        subj = int(live[0])
        for k, kind in ((0, swim.SUSPECT), (1, swim.DEAD)):
            d["r_active"][k], d["r_kind"][k], d["r_subject"][k] = True, kind, subj
            d["r_inc"][k] = d["incarnation"][subj] + k
            d["know"][subj, k] = True
        s = convert.swim_state_from_numpy(dict(d, tick=np.int32(s.tick)),
                                          device="cpu")
    p = _params_for(n, u, amax=amax)
    r = refutation_transcription(d, p, n, u)
    ref = swim._refutation_plain(p, s)
    for name in ("incarnation", "awareness", "know", "learn_tick",
                 "sends_left", "r_inc", "r_kind", "r_start"):
        np.testing.assert_array_equal(r[name], getattr(ref, name).numpy(),
                                      err_msg=name)
    e = expire_transcription(r, p, n, u)
    ref_e = swim._expire_plain(p, ref)
    for name, v in e.items():
        np.testing.assert_array_equal(np.asarray(v, getattr(
            ref_e, name).numpy().dtype), getattr(ref_e, name).numpy(),
            err_msg=name)


# ---------------------------------------------------------------------------
# the ctypes side
# ---------------------------------------------------------------------------

CSRC = Path(kernels.__file__).parent / "csrc"
SOURCES = {"originate": "originate.cu", "subject_maps": "maps.cu",
           "map_add": "maps.cu",
           "maps_convert": "maps.cu", "suspicion_expiry": "expiry.cu",
           "dense_expiry": "dense.cu", "dense_expiry_post": "dense.cu",
           "refutation": "refute.cu", "expire": "refute.cu"}


def _c_params(name):
    text = (CSRC / SOURCES[name]).read_text()
    m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', text)
    return [arg.replace("*", " ").split()[-1] for arg in m.group(1).split(",")]


class _Recorder:
    """A stand-in kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def fn(*args):
            self.calls[name] = args
            return 0
        return fn


def _card_state(monkeypatch, n=40, u=16, amax=8, chaos=False):
    """A CPU state flagged as on the card, a recording library in place of
    the kernels, and a twin that fails if it runs."""
    params = _params_for(n, u, amax=amax, chaos=chaos)
    s = _random_state(7, n, u, amax)
    maps = swim._maps_plain(params, s)
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 12345)
    monkeypatch.setattr(type(s.know), "is_cuda", property(lambda t: True))
    for name in ("_maps_plain", "_map_add_plain", "_maps_convert_plain",
                 "_suspicion_expiry_plain", "_dense_suspicion_expiry_plain",
                 "_refutation_plain", "_expire_plain", "_originate_plain"):
        monkeypatch.setattr(swim, name, lambda *a, **k: pytest.fail(
            "a twin ran on a card tensor"))
    return params, s, maps, rec


def _assert_pointers(rec, name, named: dict, scalars: dict, unchecked=()):
    """Each C parameter of `name` got the tensor the wrapper means by that
    name (its data pointer, or NULL) or the stated scalar; the `unchecked`
    ones are the wrapper's temporaries.  The block-form parameters take
    their one-device values (rows [0, N), one block of N rows, mode 0, no
    partials or plan); `tables`, the one-block table array, is checked by
    the card runs."""
    scalars = dict(dict(row0=0, rows=scalars["N"], B=1, L=scalars["N"],
                        mode=0, part=None, plan=None), **scalars)
    unchecked = tuple(unchecked) + ("tables",)
    names = _c_params(name)
    args = rec.calls[name]
    assert len(names) == len(args) == len(kernels.SIGNATURES[name])
    for value, pname in zip(args, names):
        if pname in scalars:
            assert value == scalars[pname], (name, pname)
        elif pname in named:
            t = named[pname]
            assert value == (None if t is None else t.data_ptr()), (name,
                                                                    pname)
    assert set(names) <= set(scalars) | set(named) | {"scratch"} \
        | set(unchecked), set(names) - set(scalars) - set(named)


STATE_LEAVES = ("know", "learn_tick", "sends_left", "up", "member",
                "committed_dead", "committed_left", "committed_inc",
                "r_active", "r_kind", "r_subject", "r_inc", "r_start",
                "r_confirm", "sus_start", "sus_confirm", "bulk_member",
                "bulk_heard", "bulk_cov", "incarnation", "awareness")


def _leaves(s):
    return {k: getattr(s, k) for k in STATE_LEAVES}


def test_k9_ctypes_order(monkeypatch):
    """The build writes the four rows of one [4, N] block; map_add and
    maps_convert update the maps they are given in place and return
    them."""
    params, s, maps, rec = _card_state(monkeypatch)
    out = swim._maps(params, s)
    assert out[0].untyped_storage().data_ptr() == \
        out[3].untyped_storage().data_ptr()
    assert [m.data_ptr() - out[0].data_ptr() for m in out] == \
        [4 * 40 * k for k in range(4)]
    _assert_pointers(rec, "subject_maps", dict(
        _leaves(s), **dict(zip(("suspect_of", "dead_of", "left_of",
                                "alive_val"), out))),
        dict(N=40, U=16, stream=12345))
    pairs = (torch.tensor([3, 9], dtype=torch.int32),
             torch.tensor([1, 2], dtype=torch.int32),
             torch.tensor([True, False]))
    added = swim._map_add(maps[1], *pairs)
    assert added is maps[1]
    _assert_pointers(rec, "map_add", dict(map=maps[1], subjects=pairs[0],
                                          slots=pairs[1], ok=pairs[2]),
                     dict(N=40, A=2, stream=12345))
    conv = torch.zeros(16, dtype=torch.bool)
    got = swim._maps_convert(out, s, conv)
    assert all(g is m for g, m in zip(got, out))   # in place, passed through
    _assert_pointers(rec, "maps_convert", dict(
        suspect_of=out[0], dead_of=out[1], convert=conv,
        r_subject=s.r_subject), dict(N=40, U=16, stream=12345))


def test_k10_ctypes_order(monkeypatch):
    """One launch on the state's own leaves (in place); convert is
    fresh."""
    params, s, _, rec = _card_state(monkeypatch)
    leaves = _leaves(s)
    out, conv = swim._suspicion_expiry(params, s)
    _assert_pointers(rec, "suspicion_expiry", dict(
        leaves, timeouts=swim._table(params, s.device, torch.int16),
        convert_out=conv),
        dict(N=40, U=16, tick=s.tick, tick16=swim._t16(s.tick),
             limit=params.retransmit_limit, stream=12345))
    for f in swim.EXPIRY_INPLACE:
        assert getattr(out, f) is leaves[f], f
    assert conv.data_ptr() not in {v.data_ptr() for v in leaves.values()}


@pytest.mark.parametrize("chaos", (False, True))
def test_k11_ctypes_order(monkeypatch, chaos):
    """The pre launch, K8 and the post launch, in that order, with the
    device shift passed by pointer; the post launch reads the dead map
    the pre launch read, its converted slots and K8's pairs, and no map
    is written between them."""
    params, s, maps, rec = _card_state(monkeypatch, chaos=chaos)
    leaves = _leaves(s)
    order = []
    for name in ("dense_expiry", "maps_convert", "originate", "map_add",
                 "dense_expiry_post"):
        real = getattr(rec, name)
        rec.__dict__[name] = (lambda nm, fn: lambda *a: (order.append(nm),
                                                          fn(*a))[1])(name,
                                                                      real)
    shift = torch.tensor(7, dtype=torch.int32)
    out = swim._dense_suspicion_expiry(params, s, shift, maps)
    assert order == ["dense_expiry", "originate", "dense_expiry_post"]
    pre = rec.calls["dense_expiry"]
    names = _c_params("dense_expiry")
    got = dict(zip(names, pre))
    _assert_pointers(rec, "dense_expiry", dict(
        _leaves(s), suspect_of=maps[0], dead_of=maps[1], left_of=maps[2],
        timeouts=swim._table(params, s.device, torch.int32), shift=shift),
        dict(N=40, U=16, tick=s.tick, tick16=swim._t16(s.tick),
             limit=params.retransmit_limit, period=params.probe_period_ticks,
             scratch_blocks=kernels.SCRATCH_BLOCKS, stream=12345),
        unchecked=("exp_out", "want_out", "row_subject_out", "counts_out"))
    # K8 originates from the rows and table the pre launch updated in
    # place, and from its wants
    orig = dict(zip(_c_params("originate"), rec.calls["originate"]))
    for pre_name, k8_name in (("learn_tick", "learn_tick"),
                              ("sends_left", "sends_left"),
                              ("r_kind", "r_kind"), ("r_start", "r_start"),
                              ("want_out", "want"),
                              ("row_subject_out", "row_subject")):
        assert got[pre_name] == orig[k8_name], pre_name
    assert orig["kind"] == swim.DEAD and orig["know"] == s.know.data_ptr()
    post = dict(zip(_c_params("dense_expiry_post"),
                    rec.calls["dense_expiry_post"]))
    assert post["want"] == got["want_out"] and post["counts"] == \
        got["counts_out"] and post["shift"] == shift.data_ptr()
    assert post["chaos"] == int(chaos) and post["A"] == params.alloc_cap
    assert post["U"] == params.rumor_slots
    assert post["exp"] == got["exp_out"]
    assert post["dead_of"] == maps[1].data_ptr()
    assert post["left_of"] == maps[2].data_ptr()
    # the table's subjects before K8, which rewrites the table in place:
    # a copy, not K8's own r_subject
    assert orig["r_subject"] == s.r_subject.data_ptr()
    assert post["r_subject"] not in (None, orig["r_subject"])
    for k in ("subjects", "slots", "ok"):
        assert post[k] == orig[k + "_out"], k
    # the post launch writes the state's own leaves, which the result holds
    for k in ("bulk_member", "bulk_heard", "bulk_cov", "sus_start",
              "sus_confirm"):
        assert post[k] == leaves[k].data_ptr()
    for f in swim.DENSE_INPLACE + swim.ORIGINATE_INPLACE:
        assert getattr(out, f) is getattr(s, f), f


@pytest.mark.parametrize("amax", (8, 0))
def test_k12_ctypes_order(monkeypatch, amax):
    """K12's entry points get the state's own leaves, which they update in
    place: the states returned hold the input's tensors."""
    params, s, _, rec = _card_state(monkeypatch, amax=amax)
    leaves = dict(_leaves(s), r_coverage=s.r_coverage)
    r = swim._refutation(params, s)
    _assert_pointers(rec, "refutation", leaves,
                     dict(N=40, U=16, amax=amax, tick=s.tick,
                          tick16=swim._t16(s.tick),
                          limit=params.retransmit_limit, stream=12345))
    for f in swim.TENSOR_FIELDS:
        assert getattr(r, f) is getattr(s, f), f
    e = swim._expire(params, s)
    for f in swim.TENSOR_FIELDS:
        assert getattr(e, f) is getattr(s, f), f
    _assert_pointers(rec, "expire", leaves,
                     dict(N=40, U=16, tick=s.tick,
                          life_gossip=params.expiry_gossip_ticks,
                          life_suspect=params.expiry_suspect_ticks,
                          stream=12345))


@pytest.mark.parametrize("call", ("maps", "map_add", "maps_convert",
                                  "suspicion_expiry", "dense",
                                  "refutation", "expire"))
def test_wrappers_on_a_card_tensor_launch_or_raise(monkeypatch, call):
    """On a CUDA tensor each wrapper launches its kernel (never the twin);
    a refused launch raises and is not counted."""
    params, s, maps, rec = _card_state(monkeypatch)
    monkeypatch.setattr(kernels, "library", lambda: _Refusing())
    pairs = (torch.tensor([3], dtype=torch.int32),
             torch.tensor([1], dtype=torch.int32), torch.tensor([True]))
    calls = {
        "maps": lambda: swim._maps(params, s),
        "map_add": lambda: swim._map_add(maps[0], *pairs),
        "maps_convert": lambda: swim._maps_convert(
            maps, s, torch.zeros(16, dtype=torch.bool)),
        "suspicion_expiry": lambda: swim._suspicion_expiry(params, s),
        "dense": lambda: swim._dense_suspicion_expiry(
            params, s, torch.tensor(3, dtype=torch.int32), maps),
        "refutation": lambda: swim._refutation(params, s),
        "expire": lambda: swim._expire(params, s)}
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 1"):
        calls[call]()
    assert kernels.LAUNCHES == before


class _Refusing:
    def __getattr__(self, name):
        return lambda *a: 1


def _args(n=40, u=16, a=8):
    z = lambda *shape, dtype=torch.bool: torch.zeros(shape, dtype=dtype)  # noqa: E731
    i32, i8, i16 = torch.int32, torch.int8, torch.int16
    table = dict(r_active=z(u), r_kind=z(u, dtype=i8), r_subject=z(u, dtype=i32))
    rows = dict(know=z(n, u), learn_tick=z(n, u, dtype=i16),
                sends_left=z(n, u, dtype=i8))
    return {
        "subject_maps": (kernels.launch_subject_maps, dict(
            **table, r_inc=z(u, dtype=i32), suspect_of=z(n, dtype=i32),
            dead_of=z(n, dtype=i32), left_of=z(n, dtype=i32),
            alive_val=z(n, dtype=i32))),
        "map_add": (kernels.launch_map_add, dict(
            map_n=z(n, dtype=i32), subjects=z(a, dtype=i32),
            slots=z(a, dtype=i32), ok=z(a))),
        "maps_convert": (kernels.launch_maps_convert, dict(
            suspect_of=z(n, dtype=i32), dead_of=z(n, dtype=i32), convert=z(u),
            r_subject=z(u, dtype=i32))),
        "suspicion_expiry": (kernels.launch_suspicion_expiry, dict(
            **rows, **table, up=z(n), member=z(n), committed_dead=z(n),
            committed_inc=z(n, dtype=i32), r_inc=z(u, dtype=i32),
            r_start=z(u, dtype=i32), r_confirm=z(u, dtype=i8),
            timeouts=z(65, dtype=i16), tick=100, tick16=100, limit=12,
            convert_out=z(u))),
        "dense_expiry": (kernels.launch_dense_expiry, dict(
            **rows, **table, sus_start=z(n, dtype=i32),
            sus_confirm=z(n, dtype=i8), up=z(n), member=z(n),
            committed_dead=z(n), bulk_member=z(n), suspect_of=z(n, dtype=i32),
            dead_of=z(n, dtype=i32), left_of=z(n, dtype=i32),
            r_start=z(u, dtype=i32), timeouts=z(65, dtype=i32),
            shift=z(1, dtype=i32), tick=100, tick16=100, limit=12, period=5,
            exp_out=z(u), want_out=z(n, dtype=i32),
            row_subject_out=z(n, dtype=i32),
            counts_out=z(3, dtype=torch.int64))),
        "dense_expiry_post": (kernels.launch_dense_expiry_post, dict(
            want=z(n, dtype=i32), dead_of=z(n, dtype=i32),
            left_of=z(n, dtype=i32), exp=z(u), r_subject=z(u, dtype=i32),
            subjects=z(a, dtype=i32), slots=z(a, dtype=i32), ok=z(a),
            up=z(n), member=z(n), committed_dead=z(n), committed_left=z(n),
            counts=z(3, dtype=torch.int64), shift=z(1, dtype=i32), tick=100,
            period=5, chaos=False, bulk_member=z(n),
            bulk_heard=z(n, dtype=torch.float32),
            bulk_cov=z(n, dtype=torch.float32), sus_start=z(n, dtype=i32),
            sus_confirm=z(n, dtype=i8))),
        "refutation": (kernels.launch_refutation, dict(
            **rows, **table, incarnation=z(n, dtype=i32),
            awareness=z(n, dtype=i8), up=z(n), member=z(n),
            r_inc=z(u, dtype=i32), r_start=z(u, dtype=i32), awareness_max=8,
            tick=100, tick16=100, limit=12)),
        "expire": (kernels.launch_expire, dict(
            know=z(n, u), sends_left=z(n, u, dtype=i8), **table, up=z(n),
            member=z(n), committed_dead=z(n), committed_left=z(n),
            committed_inc=z(n, dtype=i32), r_inc=z(u, dtype=i32),
            r_start=z(u, dtype=i32), r_coverage=z(u, dtype=torch.float32),
            tick=100, life_gossip=80, life_suspect=800)),
    }


BAD = {
    # case: (entry point, the arguments' edit, the message it raises with)
    "maps r_inc dtype": ("subject_maps", dict(r_inc=torch.zeros(
        16, dtype=torch.int64)), "r_inc"),
    "maps out shape": ("subject_maps", dict(alive_val=torch.zeros(
        41, dtype=torch.int32)), "alive_val"),
    "maps U > 64": ("subject_maps", dict(
        r_active=torch.zeros(65, dtype=torch.bool),
        r_kind=torch.zeros(65, dtype=torch.int8),
        r_subject=torch.zeros(65, dtype=torch.int32),
        r_inc=torch.zeros(65, dtype=torch.int32)), "slots"),
    "map_add ok dtype": ("map_add", dict(ok=torch.zeros(8, dtype=torch.int8)),
                         "ok"),
    "map_add 65 pairs": ("map_add", dict(
        subjects=torch.zeros(65, dtype=torch.int32)), "pairs"),
    "convert shape": ("maps_convert", dict(
        r_subject=torch.zeros(8, dtype=torch.int32)), "r_subject"),
    "convert dead_of shape": ("maps_convert", dict(
        dead_of=torch.zeros(41, dtype=torch.int32)), "dead_of"),
    "expiry timeouts int32": ("suspicion_expiry", dict(
        timeouts=torch.zeros(65, dtype=torch.int32)), "timeout"),
    "expiry learn shape": ("suspicion_expiry", dict(
        learn_tick=torch.zeros(40, 8, dtype=torch.int16)), "learn_tick"),
    "expiry convert_out dtype": ("suspicion_expiry", dict(
        convert_out=torch.zeros(16, dtype=torch.int8)), "convert_out"),
    "expiry tick16": ("suspicion_expiry", dict(tick16=40_000), "tick16"),
    "dense shift two": ("dense_expiry", dict(
        shift=torch.zeros(2, dtype=torch.int32)), "shift"),
    "dense shift int64": ("dense_expiry", dict(
        shift=torch.zeros(1, dtype=torch.int64)), "shift"),
    "dense timeouts int16": ("dense_expiry", dict(
        timeouts=torch.zeros(65, dtype=torch.int16)), "timeout"),
    "dense counts dtype": ("dense_expiry", dict(
        counts_out=torch.zeros(3, dtype=torch.int32)), "counts_out"),
    "dense period": ("dense_expiry", dict(period=0), "period"),
    "post heard dtype": ("dense_expiry_post", dict(
        bulk_heard=torch.zeros(40, dtype=torch.float64)), "bulk_heard"),
    "post ok 65": ("dense_expiry_post", dict(
        ok=torch.zeros(65, dtype=torch.bool)), "pairs"),
    "post r_subject shape": ("dense_expiry_post", dict(
        r_subject=torch.zeros(8, dtype=torch.int32)), "r_subject"),
    "post slots dtype": ("dense_expiry_post", dict(
        slots=torch.zeros(8, dtype=torch.int64)), "slots"),
    "refutation awareness_max 128": ("refutation", dict(
        awareness_max=128), "awareness_max"),
    "refutation inc dtype": ("refutation", dict(
        incarnation=torch.zeros(40, dtype=torch.int64)), "incarnation"),
    "expire sends shape": ("expire", dict(
        sends_left=torch.zeros(40, 8, dtype=torch.int8)), "sends_left"),
    "expire coverage dtype": ("expire", dict(
        r_coverage=torch.zeros(16, dtype=torch.float64)), "r_coverage"),
    "expire not contiguous": ("expire", dict(
        know=torch.zeros(16, 40, dtype=torch.bool).t()), "know"),
}


# case: (wrapper, the state's edit, what the check names); the in-place
# wrappers refuse a leaf they write that is strided or shares storage
# (K13's edit is of the Vivaldi state it reads)
UNWRITABLE = {
    "K10 sends_left shares know": (
        "suspicion_expiry",
        lambda s: dict(sends_left=s.know.view(torch.int8)), "share storage"),
    "K10 learn_tick strided": (
        "suspicion_expiry",
        lambda s: dict(learn_tick=s.learn_tick.t().contiguous().t()),
        "contiguous"),
    "K11 bulk_cov shares bulk_heard": (
        "dense", lambda s: dict(bulk_cov=s.bulk_heard), "share storage"),
    "K11 sus_start strided": (
        "dense", lambda s: dict(sus_start=torch.stack(
            [s.sus_start, s.sus_start], 1)[:, 0]), "contiguous"),
    "K12 refutation r_start shares r_inc": (
        "refutation", lambda s: dict(r_start=s.r_inc), "share storage"),
    "K12 refutation awareness strided": (
        "refutation", lambda s: dict(awareness=torch.stack(
            [s.awareness, s.awareness], 1)[:, 0]), "contiguous"),
    "K12 expire committed_left shares committed_dead": (
        "expire", lambda s: dict(committed_left=s.committed_dead),
        "share storage"),
    "K12 expire know strided": (
        "expire", lambda s: dict(know=s.know.t().contiguous().t()),
        "contiguous"),
    "K13 adjustment shares adj_window": (
        "ring", lambda c: dict(adjustment=c.adj_window.view(-1)[
            :c.adjustment.numel()]), "share storage"),
    "K13 adj_window strided": (
        "ring", lambda c: dict(adj_window=c.adj_window.t().contiguous().t()),
        "contiguous"),
    # K9's updates write the maps they are given
    "K9 map_add map strided": (
        "map_add", lambda m: (torch.stack([m[0], m[0]], 1)[:, 0], *m[1:]),
        "contiguous"),
    "K9 maps_convert dead_of is suspect_of": (
        "maps_convert", lambda m: (m[0], m[0], *m[2:]), "share storage"),
    "K9 maps_convert dead_of overlaps suspect_of": (
        "maps_convert", lambda m: (lambda b: (b[:40], b[3:43], *m[2:]))(
            torch.zeros(80, dtype=torch.int32)), "share storage"),
    "K9 maps_convert suspect_of strided": (
        "maps_convert", lambda m: (torch.stack([m[0], m[0]], 1)[:, 1],
                                   *m[1:]), "contiguous"),
}


@pytest.mark.parametrize("case", sorted(UNWRITABLE))
def test_inplace_wrappers_reject_unwritable_leaves(monkeypatch, case):
    """On the card K9's updates and K10's, K11's, K12's and K13's wrappers
    check every leaf or map they write before launching: a strided or
    shared one raises, with no launch and no twin."""
    params, s, maps, rec = _card_state(monkeypatch)
    monkeypatch.setattr(vivaldi, "observe_ring_plain", lambda *a, **k:
                        pytest.fail("a twin ran on a card tensor"))
    which, edit, match = UNWRITABLE[case]
    vp = vivaldi.VivaldiParams(n_nodes=40)
    c = vivaldi.init_state(vp, device="cpu")
    if which == "ring":
        c = c.replace(**edit(c))
    elif which in ("map_add", "maps_convert"):
        maps = edit(maps)
    else:
        s = s.replace(**edit(s))
    ones = torch.ones(40)
    calls = {"suspicion_expiry": lambda: swim._suspicion_expiry(params, s),
             "dense": lambda: swim._dense_suspicion_expiry(
                 params, s, torch.tensor(3, dtype=torch.int32), maps),
             "refutation": lambda: swim._refutation(params, s),
             "expire": lambda: swim._expire(params, s),
             "ring": lambda: vivaldi.observe_ring(
                 vp, c, torch.tensor(3, dtype=torch.int32), ones,
                 ones.bool()),
             "map_add": lambda: swim._map_add(
                 maps[0], torch.tensor([3], dtype=torch.int32),
                 torch.tensor([1], dtype=torch.int32), torch.tensor([True])),
             "maps_convert": lambda: swim._maps_convert(
                 maps, s, torch.ones(16, dtype=torch.bool))}
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        calls[which]()
    assert not rec.calls and kernels.LAUNCHES == before


@pytest.mark.parametrize("case", sorted(BAD))
def test_detector_wrappers_reject(monkeypatch, case):
    monkeypatch.setattr(kernels, "library",
                        lambda: pytest.fail("launched a rejected call"))
    name, edit, match = BAD[case]
    fn, args = _args()[name]
    args.update(edit)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        fn(**args)
    assert kernels.LAUNCHES == before


def test_kernel_constants_match_the_sources():
    maps = (CSRC / "maps.cu").read_text()
    assert "kThreads = 256;" in maps and "kRange = 4 * kThreads;" in maps
    assert MAP_RANGE == 4 * 256
    expiry = (CSRC / "expiry.cu").read_text()
    assert "kAny = 0, kRead = 1;" in expiry
    assert kernels.EXPIRY_SCRATCH == 2
    refute = (CSRC / "refute.cu").read_text()
    assert "kDecided = 0;" in refute and kernels.REFUTE_SCRATCH == 1
    assert "kRead = 65;" in refute and kernels.EXPIRE_SCRATCH == 66
    dense = (CSRC / "dense.cu").read_text()
    assert "u64 v[3]" in dense and "grid_sum<3>" in dense
    assert kernels.DENSE_COUNTS == 3
    assert set(kernels.DETECTOR) <= set(kernels.SIGNATURES) <= set(
        kernels.KERNELS) | {"threefry_draws"} | set(kernels.HELPERS)
    for name in kernels.DETECTOR:
        assert len(_c_params(name)) == len(kernels.SIGNATURES[name])
