"""The probe round (K7) and rumor origination (K8) on the CPU.

Their plain twins (`swim._probe_round_plain`, `_probe_pass_plain`,
`_originate_plain`) against the JAX package at P2 in every mode the
params reach: the LAN config, chaos with a partition and a degraded set,
the deterministic degraded set, no LHA and no relays, pools of fewer
than a warp (N = 15 and 6 at U = 16 and 8), evicting states, the three
kinds an origination makes.  Int/bool leaves bit-equal; float leaves
within rtol 1e-6 (the RTT carries the exponential draw's one-ulp log1p
difference).  Then the kernels' own logic where the CPU can reach it: a
numpy transcription of K8's warp-list selection and block merges against
`_top_k`, a transcription of K7's writes at j = (i + d) % N against
`rolls.push`, and the ctypes side (argument order, rejected tensors, no
twin on a card tensor).
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
from consul_tpu_torch.models import swim
from consul_tpu_torch.ops import rolls

_run = jax.jit(jswim.run, static_argnums=(0, 2, 3))

# name: (n, u, gossip overrides, sim overrides, kills, faults, ticks)
MODES = {
    "lan": (256, 16, {}, {}, (9, 77), False, 70),
    "chaos": (256, 16, {}, {"chaos": True}, (9, 77), True, 70),
    "degraded": (256, 16, {}, {"degraded_frac": 0.1, "degraded_loss": 0.3},
                 (9, 77), False, 70),
    "no_lha_no_relays": (256, 16, {"awareness_max_multiplier": 0,
                                   "indirect_checks": 0},
                         {"p_loss": 0.1}, (9, 77), False, 70),
    "one_relay": (256, 16, {"indirect_checks": 1}, {}, (9, 77), False, 70),
    "wan_15x16": (15, 16, "wan", {}, (4,), False, 60),
    "wan_6x8": (6, 8, "wan", {}, (2,), False, 60),
    "small_15x8": (15, 8, {}, {"p_loss": 0.2}, (4, 11), False, 40),
    "lossy": (256, 16, {}, {"p_loss": 0.2}, (9, 77), False, 70),
}


def _gossip(pkg, overrides):
    if overrides == "wan":
        return pkg.GossipConfig.wan()
    return dataclasses.replace(pkg.GossipConfig.lan(), **overrides)


def _params(mode):
    """(jax params, port params) of the mode."""
    n, u, gossip, sim = MODES[mode][:4]
    sim = dict(dict(n_nodes=n, rumor_slots=u, p_loss=0.01, seed=3), **sim)
    return (jswim.make_params(_gossip(jconfig, gossip),
                              jconfig.SimConfig(**sim)),
            swim.make_params(_gossip(config, gossip), config.SimConfig(**sim)))


@functools.lru_cache(maxsize=None)
def _reference(mode):
    """(jax params, port params, the JAX state of the mode at its tick)."""
    n, kills, faults, ticks = (MODES[mode][0], *MODES[mode][4:])
    jp, tp = _params(mode)
    s = jswim.init_state(jp)
    s, _ = _run(jp, s, 10)
    for v in kills:
        s = jswim.kill(s, v)
    s, _ = _run(jp, s, 10)
    if faults:
        grp = (np.random.default_rng(4).random(n) < 0.25).astype(np.int16)
        ok = np.where(np.arange(n) % 10 == 5, np.float32(0.55),
                      np.float32(1.0)).astype(np.float32)
        s = s.replace(chaos_grp=jnp.asarray(grp), chaos_ok=jnp.asarray(ok))
    for _ in range(ticks // 10 - 2):
        s, _ = _run(jp, s, 10)
    return jp, tp, s


def _port(s):
    return convert.swim_state_from_numpy(jax_dict(s), device="cpu")


def _assert_state(js, ts, where=""):
    assert_leaves(jax_dict(js), convert.swim_state_to_numpy(ts), where=where,
                  rtol=1e-6)


def test_params_reach_every_mode():
    """The modes differ where K7 branches: relays, LHA, chaos, the
    degraded set, pools below a warp."""
    both = {m: _params(m) for m in MODES}
    tps = {m: tp for m, (_, tp) in both.items()}
    assert tps["no_lha_no_relays"].indirect_checks == 0
    assert tps["no_lha_no_relays"].awareness_max == 0
    assert tps["one_relay"].indirect_checks == 1
    assert tps["chaos"].chaos and tps["degraded"].degraded_frac > 0
    assert tps["wan_6x8"].n_nodes == 6 and tps["wan_6x8"].rumor_slots == 8
    for jp, tp in both.values():
        assert jconfig.dataclasses.asdict(jp) == \
            config.dataclasses.asdict(tp)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_probe_round_plain_matches_reference(mode):
    jp, tp, js = _reference(mode)
    ts = _port(js)
    ja, jobs, jm = jswim._probe_round(jp, js, jswim._maps(jp, js))
    ta, tobs, tm = swim._probe_round_plain(tp, ts, swim._maps(tp, ts))
    _assert_state(ja, ta, where=f"{mode}: ")
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(tobs.shift) == int(jobs.shift)
    np.testing.assert_array_equal(tobs.acked.numpy(), np.asarray(jobs.acked))
    np.testing.assert_allclose(tobs.rtt_ms.numpy(), np.asarray(jobs.rtt_ms),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_probe_pass_then_originate_is_the_round(mode):
    """The twin's two halves, as the card path calls them (the pass, then
    the origination of its wants), give _probe_round's result: the wants
    are the subjects the round's failed probes name."""
    _, tp, js = _reference(mode)
    ts = _port(js)
    maps = swim._maps(tp, ts)
    s1, want, rows, obs = swim._probe_pass_plain(
        tp, ts, maps, swim._probe_inputs(tp, ts))
    assert want.dtype == rows.dtype == torch.int32
    assert set(want.unique().tolist()) <= {0, 1}
    failed = rows >= 0
    target = (torch.arange(tp.n_nodes) + int(obs.shift)) % tp.n_nodes
    assert torch.equal(rows[failed].long(), target[failed])
    assert not (want > 0)[rolls.push(~failed, obs.shift)].any()
    s2, alloc = swim._originate_plain(tp, s1, want, swim.SUSPECT,
                                      s1.incarnation, rows)
    ref = swim._probe_round(tp, ts, maps)
    for f in swim.TENSOR_FIELDS:
        a, b = getattr(s2, f), getattr(ref[0], f)
        assert torch.equal(a, b), f


def _evicting(jp, js, seed):
    """Wants of 1 and 2 on a tenth of the nodes or, where the pool allows,
    on more nodes than there are free slots; a row subject for ~30% of the
    rows."""
    n = jp.n_nodes
    rng = np.random.default_rng(seed)
    free = int((~np.asarray(js.r_active)).sum())
    want = np.zeros(n, np.int32)
    hit = rng.choice(n, size=min(n, max(n // 10, free + 1)), replace=False)
    want[hit] = rng.integers(1, 3, hit.shape[0])
    rows = np.where(rng.random(n) < 0.3, rng.integers(0, n, n),
                    -1).astype(np.int32)
    return want, rows


@pytest.mark.parametrize("kind", (jswim.ALIVE, jswim.SUSPECT, jswim.DEAD,
                                  jswim.LEFT))
@pytest.mark.parametrize("mode", ("lan", "chaos", "wan_15x16", "wan_6x8",
                                  "lossy"))
def test_originate_plain_matches_reference(mode, kind):
    jp, tp, js = _reference(mode)
    ts = _port(js)
    want, rows = _evicting(jp, js, seed=kind)
    ja, jalloc = jswim._originate(jp, js, jnp.asarray(want), kind,
                                  js.incarnation, jnp.asarray(rows))
    ta, talloc = swim._originate_plain(tp, ts, torch.from_numpy(want), kind,
                                       ts.incarnation, torch.from_numpy(rows))
    _assert_state(ja, ta, where=f"{mode} kind {kind}: ")
    for a, b in zip(jalloc, talloc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _covered(jp, js):
    """js with its first active non-suspect slots, or dead rumors made for
    the purpose, known by every live member: _originate's eviction
    releases them (a dead one commits)."""
    d = jax_dict(js)
    u = jp.rumor_slots
    active, kind = d["r_active"].copy(), d["r_kind"].copy()
    for slot in range(min(4, u)):
        if not active[slot] or kind[slot] == jswim.SUSPECT:
            active[slot], kind[slot] = True, jswim.DEAD
    know = d["know"].copy()
    know[:, :4] = True
    return js.replace(r_active=jnp.asarray(active), r_kind=jnp.asarray(kind),
                      know=jnp.asarray(know))


@pytest.mark.parametrize("mode", ("lan", "wan_15x16", "wan_6x8"))
def test_originate_plain_evicts_like_the_reference(mode):
    """demand > free with covered slots: the release commits and clears
    columns in both packages."""
    jp, tp, js = _reference(mode)
    js = _covered(jp, js)
    ts = _port(js)
    want, rows = _evicting(jp, js, seed=11)
    assert (want > 0).sum() > (~np.asarray(js.r_active)).sum()
    ja, jalloc = jswim._originate(jp, js, jnp.asarray(want), jswim.SUSPECT,
                                  js.incarnation, jnp.asarray(rows))
    ta, talloc = swim._originate_plain(tp, ts, torch.from_numpy(want),
                                       jswim.SUSPECT, ts.incarnation,
                                       torch.from_numpy(rows))
    _assert_state(ja, ta, where=f"{mode}: ")
    for a, b in zip(jalloc, talloc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert not torch.equal(ta.committed_dead, ts.committed_dead)


@pytest.mark.parametrize("mode", ("lan", "chaos", "wan_15x16"))
def test_dense_expiry_and_rejoin_plain_match_reference(mode):
    """K8's other callers on the twin: the dense expiry's dead rumors and
    rejoin's alive rumor."""
    jp, tp, js = _reference(mode)
    ts = _port(js)
    ja, jobs, jm = jswim._probe_round(jp, js, jswim._maps(jp, js))
    ta, tobs, tm = swim._probe_round_plain(tp, ts, swim._maps(tp, ts))
    jd = jswim._dense_suspicion_expiry(jp, ja, jobs.shift, jm)
    td = swim._dense_suspicion_expiry(tp, ta, tobs.shift, tm)
    _assert_state(jd, td, where=f"{mode} dense expiry: ")
    victim = MODES[mode][4][0]
    _assert_state(jswim.rejoin(jp, js, victim), swim.rejoin(tp, ts, victim),
                  where=f"{mode} rejoin: ")


# ---------------------------------------------------------------------------
# K8's selection: a transcription of originate.cu's warp lists and merges
# ---------------------------------------------------------------------------

WARPS = 8     # originate.cu's kWarps (kThreads / 32)


def _key(v, i):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) << 32 | (0xFFFFFFFF - i)


def _offer(lst, keys, a):
    """top_offer: the keys of one warp step above the list's A-th entry
    are inserted in lane order, the rest filtered again against the new
    A-th entry after each insert; top_insert drops a key that no longer
    beats A entries."""
    pending = [k for k in keys if k > lst[a - 1]]
    while pending:
        x = pending.pop(0)
        p = sum(e > x for e in lst)
        if p < a:
            lst[:] = (lst[:p] + [x] + lst[p:])[:a]
        pending = [k for k in pending if k > lst[a - 1]]


def _block_merge(lists, a):
    """block_top: a tree over the warps' lists; at each level warp w takes
    warp w + step's entries, lo half (entries 0-31) then hi half (32-63),
    for w a multiple of 2 step; warp 0's list is the block's."""
    lists = [list(x) for x in lists]
    step = 1
    while step < WARPS:
        for w in range(0, WARPS, 2 * step):
            padded = lists[w + step] + [0] * (64 - a)
            _offer(lists[w], padded[:32], a)
            _offer(lists[w], padded[32:], a)
        step *= 2
    return lists[0]


def select_transcription(want: np.ndarray, a: int, blocks: int):
    """originate_kernel's select for a grid of `blocks` blocks: each warp
    walks rows gwarp * 32 + t * (blocks * WARPS * 32) (kBatches of them
    loaded together, offered in this order); the last block's warps walk
    the [blocks * A] lists in 32-key steps."""
    n = want.shape[0]
    stride = blocks * WARPS * 32
    block_lists = []
    for b in range(blocks):
        lists = []
        for w in range(WARPS):
            lst = [0] * a
            for i0 in range((b * WARPS + w) * 32, n, stride):
                _offer(lst, [_key(want[i], i) for i in range(i0, min(i0 + 32,
                                                                     n))], a)
            lists.append(lst)
        block_lists += _block_merge(lists, a)
    lists = []
    for w in range(WARPS):
        lst = [0] * a
        for c0 in range(w * 32, len(block_lists), WARPS * 32):
            _offer(lst, block_lists[c0:c0 + 32], a)
        lists.append(lst)
    top = _block_merge(lists, a)
    vals = [((k >> 32) ^ 0x80000000) - ((((k >> 32) ^ 0x80000000) >> 31) << 32)
            for k in top]
    idx = [0xFFFFFFFF - (k & 0xFFFFFFFF) for k in top]
    return np.array(vals, np.int32), np.array(idx, np.int32)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 2200), a_req=st.integers(1, 64),
       blocks=st.integers(1, 4), density=st.sampled_from((0.0, 0.002, 0.05,
                                                          0.5, 1.0)),
       low=st.sampled_from((0, -3)), seed=st.integers(0, 2 ** 16))
def test_k8_selection_transcription_matches_top_k(n, a_req, blocks, density,
                                                  low, seed):
    """Ties (wants of 0-2), all-zero wants, fewer wanters than A, N below
    a block, negative wants: the lists and merges give _top_k's values and
    indices, padding rows included."""
    a = min(a_req, n)
    rng = np.random.default_rng(seed)
    want = np.where(rng.random(n) < density, rng.integers(low, 3, n),
                    0).astype(np.int32)
    blocks = min(blocks, -(-n // 256))      # persistent_blocks: <= need
    got_v, got_i = select_transcription(want, a, blocks)
    ref_v, ref_i = swim._top_k(torch.from_numpy(want), a)
    np.testing.assert_array_equal(got_v, ref_v.numpy())
    np.testing.assert_array_equal(got_i, ref_i.numpy())


@pytest.mark.parametrize("u,a", ((8, 8), (16, 8), (32, 8), (64, 40)))
def test_k8_free_slot_order_matches_top_k(u, a):
    """The commit launch's free-slot top A (free slots ascending, then the
    occupied ones) is lax.top_k of (active ? 0 : 1) * (U - slot)."""
    rng = np.random.default_rng(u)
    for _ in range(20):
        active = rng.random(u) < rng.random()
        rank = torch.from_numpy(np.where(active, 0, 1).astype(np.int32)
                                * (u - np.arange(u, dtype=np.int32)))
        score, slots = swim._top_k(rank, a)
        order = [s for s in range(u) if not active[s]] + \
            [s for s in range(u) if active[s]]
        assert slots.tolist() == order[:a]
        assert score.tolist() == [u - s if not active[s] else 0
                                  for s in order[:a]]


def originate_in_place(st: dict, want, kind, inc_of_subject, row_subject,
                       a, tick, tick16, limit):
    """originate.cu's writes, in its order, on the numpy leaves `st`
    (updated in place); returns (subjects, slots, ok).  The deciding
    block: coverage and the done and commit masks (with an eviction),
    r_coverage; thread 0's committed scatters at the committing slots'
    subjects, read from the table before this call; then the table's rows
    for the slots the allocation takes.  The seed phase, row by row: the
    evicted columns' know and sends_left cleared, then the matched cell."""
    u = st["r_active"].shape[0]
    n = want.shape[0]
    keys = sorted(((int(w), -i) for i, w in enumerate(want)), reverse=True)[:a]
    score = np.array([k[0] for k in keys], np.int32)
    subjects = np.array([-k[1] for k in keys], np.int32)
    evicting = int((want > 0).sum()) > u - int(st["r_active"].sum())
    done = np.zeros(u, bool)
    commit = {k: np.zeros(u, bool) for k in ("dead", "left", "alive")}
    if evicting:
        live = st["up"] & st["member"]
        cov = (st["know"][live].sum(0).astype(np.float32)
               / np.float32(max(int(live.sum()), 1)))
        done = st["r_active"] & (cov >= np.float32(0.995)) \
            & (st["r_kind"] != swim.SUSPECT)
        ok50 = done & (cov >= np.float32(0.5))
        for name, k in (("dead", swim.DEAD), ("left", swim.LEFT),
                        ("alive", swim.ALIVE)):
            commit[name] = ok50 & (st["r_kind"] == k)
        st["r_coverage"][:] = np.where(done, np.float32(0.0), cov)
    # thread 0, from the table before this call
    for x in st["r_subject"][commit["dead"]]:
        st["committed_dead"][x] = True
    for x in st["r_subject"][commit["left"]]:
        st["committed_left"][x] = True
    for slot in np.flatnonzero(commit["alive"]):
        x = st["r_subject"][slot]
        st["committed_inc"][x] = max(st["committed_inc"][x],
                                     st["r_inc"][slot])
    if not commit["alive"].all():
        st["committed_inc"][0] = max(st["committed_inc"][0], 0)
    after = st["r_active"] & ~done
    order = [x for x in range(u) if not after[x]] + \
        [x for x in range(u) if after[x]]
    slots = np.array(order[:a], np.int32)
    ok = (score > 0) & ~after[slots]
    st["r_active"][:] = after
    for k in np.flatnonzero(ok):
        t, x = slots[k], subjects[k]
        st["r_active"][t] = True
        st["r_kind"][t] = kind
        st["r_subject"][t] = x
        st["r_inc"][t] = inc_of_subject[x]
        st["r_start"][t] = tick
        st["r_confirm"][t] = 1
    match = np.where(ok, subjects, -2)
    for i in range(n):
        st["know"][i, done] = False
        st["sends_left"][i, done] = 0
        hit = slots[match == row_subject[i]]
        if hit.size:
            st["know"][i, hit.max()] = True
            st["learn_tick"][i, hit.max()] = tick16
            st["sends_left"][i, hit.max()] = limit
    return subjects, slots, ok


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 90), u=st.sampled_from((8, 16)),
       a_req=st.integers(1, 16), seed=st.integers(0, 2 ** 16),
       wanters=st.sampled_from((0.0, 0.05, 0.3, 1.0)),
       kind=st.integers(0, 3))
def test_k8_in_place_order_matches_the_twin(n, u, a_req, seed, wanters, kind):
    """The transcription of K8's in-place writes gives _originate_plain's
    state and allocation on random tables, evicting ones among them: fully
    known dead, left and alive slots (committed at the 0.5 bar, freed at
    0.995), suspect slots (never freed), duplicate subjects, subject 0,
    negative committed incarnations (the scatter-max of 0 into node 0)."""
    a = min(a_req, u, n)
    rng = np.random.default_rng(seed)
    params = dataclasses.replace(swim.make_params(
        config.GossipConfig.lan(), config.SimConfig(n_nodes=n, rumor_slots=u)),
        alloc_cap=a)
    dense = rng.random(u) < 0.5
    st = dict(
        up=rng.random(n) < 0.9, member=rng.random(n) < 0.95,
        incarnation=rng.integers(0, 5, n).astype(np.int32),
        committed_dead=rng.random(n) < 0.1,
        committed_left=rng.random(n) < 0.1,
        committed_inc=rng.integers(-2, 4, n).astype(np.int32),
        r_active=rng.random(u) < 0.85,
        r_kind=rng.integers(0, 4, u).astype(np.int8),
        r_subject=rng.integers(0, min(n, 6), u).astype(np.int32),
        r_inc=rng.integers(0, 6, u).astype(np.int32),
        r_start=rng.integers(0, 100, u).astype(np.int32),
        r_confirm=rng.integers(0, 9, u).astype(np.int8),
        r_coverage=rng.random(u).astype(np.float32),
        know=(rng.random((n, u)) < np.where(dense, 1.0, 0.4)[None, :]),
        learn_tick=rng.integers(-50, 50, (n, u)).astype(np.int16),
        sends_left=rng.integers(0, 12, (n, u)).astype(np.int8))
    want = np.where(rng.random(n) < wanters, rng.integers(1, 3, n),
                    0).astype(np.int32)
    row_subject = np.where(rng.random(n) < 0.4, rng.integers(0, n, n),
                           -1).astype(np.int32)
    s = swim.init_state(params, device="cpu").replace(
        tick=123, **{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    ref, alloc = swim._originate_plain(
        params, s, torch.from_numpy(want), kind, s.incarnation,
        torch.from_numpy(row_subject))
    got = originate_in_place(st, want, kind, st["incarnation"], row_subject,
                             a, 123, swim._t16(123), params.retransmit_limit)
    for name, v in st.items():
        np.testing.assert_array_equal(v, getattr(ref, name).numpy(),
                                      err_msg=name)
    for x, y in zip(got, alloc):
        np.testing.assert_array_equal(x, y.numpy())


# ---------------------------------------------------------------------------
# K7's per-subject writes: thread i writes at j = (i + d) % N
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (1, 6, 15, 32, 33, 1000))
def test_k7_writes_at_the_target_are_rolls_push(n):
    """probe.cu: offs[0] taken mod N into [0, N), j = i + d (- N); a value
    thread i computes and stores at j is rolls.push of it, and what it
    reads at j is rolls.pull — for every shift, d = 0 mod N and d = N
    included."""
    rng = np.random.default_rng(n)
    f = rng.integers(-100, 100, n).astype(np.int32)
    for d in sorted({0, 1, n - 1, n, n + 1, 2 * n, 3 * n + 2, -1}):
        dd = d % n
        out = np.empty(n, np.int32)
        read = np.empty(n, np.int32)
        for i in range(n):
            j = i + dd - n if i + dd >= n else i + dd
            out[j] = f[i]
            read[i] = f[j]
        ft = torch.from_numpy(f)
        np.testing.assert_array_equal(out, rolls.push(ft, d).numpy())
        np.testing.assert_array_equal(read, rolls.pull(ft, d).numpy())


# ---------------------------------------------------------------------------
# the ctypes side
# ---------------------------------------------------------------------------

CSRC = Path(kernels.__file__).parent / "csrc"


def _c_params(source, name):
    text = (CSRC / source).read_text()
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


def _probe_args(n=40, u=16, k=3, amax=8, chaos=True):
    gen = torch.Generator().manual_seed(1)
    z = lambda *shape, dtype=torch.bool: torch.zeros(shape, dtype=dtype)  # noqa: E731
    f = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    i32 = torch.int32
    return dict(
        up=z(n), member=z(n), awareness=z(n, dtype=torch.int8),
        coords=f(n, 2), committed_dead=z(n), committed_left=z(n),
        committed_inc=z(n, dtype=i32), bulk_member=z(n), know=z(n, u),
        learn_tick=z(n, u, dtype=torch.int16),
        sends_left=z(n, u, dtype=torch.int8), sus_start=z(n, dtype=i32),
        sus_confirm=z(n, dtype=torch.int8), sus_count=z(n, dtype=i32),
        chaos_grp=z(n, dtype=torch.int16) if chaos else None,
        chaos_ok=f(n) if chaos else None, r_active=z(u),
        r_kind=z(u, dtype=torch.int8), r_subject=z(u, dtype=i32),
        r_inc=z(u, dtype=i32), r_confirm=z(u, dtype=torch.int8),
        timeouts=z(65, dtype=torch.int16), suspect_of=z(n, dtype=i32),
        dead_of=z(n, dtype=i32), left_of=z(n, dtype=i32),
        alive_val=z(n, dtype=i32), ctr=f(7),
        offs=torch.arange(1, k + 2, dtype=i32), rtt_draw=f(n), direct=f(n),
        lha=f(n) if amax else None, leg_a=f(n, k) if k else None,
        leg_b=f(n, k) if k else None, leg_c=f(n, k) if k else None,
        awareness_max=amax, degraded=True, seed=2 ** 40 + 7, ok_good=0.99,
        ok_bad=0.7, degraded_frac=0.1, probe_timeout_ms=500.0,
        rtt_base_ms=0.5, tick=41, tick16=41, limit=12,
        want_out=z(n, dtype=i32), row_subject_out=z(n, dtype=i32),
        rtt_out=z(n, dtype=torch.float32), acked_out=z(n))


def _originate_args(n=40, u=16, a=8):
    z = lambda *shape, dtype=torch.bool: torch.zeros(shape, dtype=dtype)  # noqa: E731
    i32 = torch.int32
    return dict(
        want=z(n, dtype=i32), row_subject=z(n, dtype=i32),
        inc_of_subject=z(n, dtype=i32), up=z(n), member=z(n), know=z(n, u),
        learn_tick=z(n, u, dtype=torch.int16),
        sends_left=z(n, u, dtype=torch.int8), committed_dead=z(n),
        committed_left=z(n), committed_inc=z(n, dtype=i32), r_active=z(u),
        r_kind=z(u, dtype=torch.int8), r_subject=z(u, dtype=i32),
        r_inc=z(u, dtype=i32), r_start=z(u, dtype=i32),
        r_confirm=z(u, dtype=torch.int8), r_coverage=z(u, dtype=torch.float32),
        alloc=a, kind=swim.SUSPECT, tick=70000, tick16=swim._t16(70000),
        limit=12, subjects_out=z(a, dtype=i32), slots_out=z(a, dtype=i32),
        ok_out=z(a))


def _one_device(n):
    """The block-form parameters of a one-device launch: rows [0, N), one
    block of N rows, mode 0, no partials or plan (`tables`, the one-block
    table array, is checked by the card runs)."""
    return dict(row0=0, rows=n, B=1, L=n, mode=0, part=None, plan=None,
                part_b=0)


def _check_call(args, names, kwargs, scalars):
    """Each C parameter got the wrapper's tensor of the same name (or
    NULL for an absent one) or the stated scalar."""
    assert len(args) == len(names)
    for value, name in zip(args, names):
        if name in scalars:
            want = scalars[name]
            if isinstance(want, float):
                assert np.float32(value) == np.float32(want), name
            else:
                assert value == want, name
        elif name in kwargs:
            t = kwargs[name]
            assert value == (None if t is None else t.data_ptr()), name


@pytest.mark.parametrize("amax,k,chaos", ((8, 3, True), (0, 0, False),
                                          (8, 1, False)))
def test_probe_round_ctypes_order(monkeypatch, amax, k, chaos):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 12345)
    before = kernels.LAUNCHES["probe_round"]
    args = _probe_args(amax=amax, k=k, chaos=chaos)
    kernels.launch_probe_round(**args)
    assert kernels.LAUNCHES["probe_round"] == before + 1
    names = _c_params("probe.cu", "probe_round")
    assert len(names) == len(kernels.SIGNATURES["probe_round"])
    scalars = dict(N=40, U=16, k=k, amax=amax, chaos=int(chaos),
                   degraded=1, C=7, seed32=7, ok_good=0.99, ok_bad=0.7,
                   degraded_frac=0.1, probe_timeout_ms=500.0, rtt_base_ms=0.5,
                   tick=41, tick16=41, limit=12,
                   scratch_blocks=kernels.SCRATCH_BLOCKS, stream=12345,
                   **_one_device(40))
    _check_call(rec.calls["probe_round"], names, args, scalars)
    assert set(names) - set(scalars) - {"scratch", "tables"} <= set(args)


def test_originate_ctypes_order(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 12345)
    args = _originate_args()
    kernels.launch_originate(**args)
    names = _c_params("originate.cu", "originate")
    assert len(names) == len(kernels.SIGNATURES["originate"])
    scalars = dict(N=40, U=16, A=8, kind=swim.SUSPECT, tick=70000,
                   tick16=swim._t16(70000), limit=12,
                   list_blocks=kernels.ORIGINATE_LIST_BLOCKS, stream=12345,
                   **_one_device(40))
    _check_call(rec.calls["originate"], names, args, scalars)
    assert set(names) - set(scalars) - {"scratch", "tables"} <= set(args)


def test_kernel_constants_match_the_sources():
    probe = (CSRC / "probe.cu").read_text()
    assert f"kCounters = {kernels.PROBE_COUNTERS};" in probe
    assert f"kMaxRelays = {kernels.PROBE_MAX_RELAYS};" in probe
    orig = (CSRC / "originate.cu").read_text()
    assert f"kLists = {kernels.ORIGINATE_PLAN};" in orig
    assert set(kernels.PROBE) <= set(kernels.SIGNATURES)


PROBE_BAD = {
    "know dtype": (dict(know=torch.zeros(40, 16, dtype=torch.uint8)), "know"),
    "learn shape": (dict(learn_tick=torch.zeros(40, 8, dtype=torch.int16)),
                    "learn_tick"),
    "U > 64": (dict(know=torch.zeros(40, 65, dtype=torch.bool)), "U=65"),
    "coords 3-d": (dict(coords=torch.zeros(40, 3)), "coords"),
    "up dtype": (dict(up=torch.zeros(40, dtype=torch.int8)), "up"),
    "maps dtype": (dict(suspect_of=torch.zeros(40, dtype=torch.int64)),
                   "suspect_of"),
    "ctr short": (dict(ctr=torch.zeros(3)), "ctr"),
    "relays > 16": (dict(offs=torch.zeros(18, dtype=torch.int32)), "relays"),
    "legs missing": (dict(leg_b=None), "relay legs"),
    "lha without LHA": (dict(awareness_max=0), "lha"),
    "chaos half": (dict(chaos_ok=None), "chaos_grp"),
    "table shorter than know": (dict(r_active=torch.zeros(8, dtype=torch.bool),
                                     r_kind=torch.zeros(8, dtype=torch.int8),
                                     r_subject=torch.zeros(8, dtype=torch.int32)),
                                "slots"),
    "timeouts dtype": (dict(timeouts=torch.zeros(65, dtype=torch.int32)),
                       "timeout"),
    "rtt_out dtype": (dict(rtt_out=torch.zeros(40, dtype=torch.float64)),
                      "rtt_out"),
    "limit": (dict(limit=200), "limit"),
    "know not contiguous": (dict(know=torch.zeros(16, 40,
                                                  dtype=torch.bool).t()),
                            "know"),
}


@pytest.mark.parametrize("case", sorted(PROBE_BAD))
def test_probe_round_wrapper_rejects(monkeypatch, case):
    monkeypatch.setattr(kernels, "library",
                        lambda: pytest.fail("launched a rejected call"))
    edit, match = PROBE_BAD[case]
    args = _probe_args()
    args.update(edit)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernels.launch_probe_round(**args)
    assert kernels.LAUNCHES == before


ORIGINATE_BAD = {
    "want dtype": (dict(want=torch.zeros(40, dtype=torch.int64)), "want"),
    "row_subject shape": (dict(row_subject=torch.zeros(41, dtype=torch.int32)),
                          "row_subject"),
    "alloc 0": (dict(alloc=0), "alloc"),
    "alloc > U": (dict(alloc=17), "alloc"),
    "kind": (dict(kind=4), "kind"),
    "r_coverage dtype": (dict(r_coverage=torch.zeros(16, dtype=torch.int32)),
                         "r_coverage"),
    "ok_out dtype": (dict(ok_out=torch.zeros(8, dtype=torch.int8)), "ok_out"),
    "sends_left shape": (dict(sends_left=torch.zeros(40, 8, dtype=torch.int8)),
                         "sends_left"),
    "committed_inc dtype": (dict(committed_inc=torch.zeros(
        40, dtype=torch.int64)), "committed_inc"),
}


@pytest.mark.parametrize("case", sorted(ORIGINATE_BAD))
def test_originate_wrapper_rejects(monkeypatch, case):
    monkeypatch.setattr(kernels, "library",
                        lambda: pytest.fail("launched a rejected call"))
    edit, match = ORIGINATE_BAD[case]
    args = _originate_args()
    args.update(edit)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernels.launch_originate(**args)
    assert kernels.LAUNCHES == before


def _card_flagged(monkeypatch):
    params = swim.make_params(config.GossipConfig.lan(),
                              config.SimConfig(n_nodes=64, rumor_slots=8))
    s = swim.init_state(params, device="cpu")
    maps = swim._maps(params, s)
    drawn = swim._probe_inputs(params, s)
    monkeypatch.setattr(type(s.know), "is_cuda", property(lambda t: True))
    return params, s, maps, drawn


def test_probe_pass_on_a_card_tensor_launches_k7(monkeypatch):
    """On a CUDA tensor _probe_pass goes to K7, never the twin, with the
    state's own leaves to update in place and fresh tensors for want,
    row_subject and the observation; a refused launch raises."""
    params, s, maps, drawn = _card_flagged(monkeypatch)
    seen = {}

    def refuse(**kw):
        seen.update(kw)
        raise RuntimeError("probe_round launch failed: CUDA error 1")

    monkeypatch.setattr(kernels, "launch_probe_round", refuse)
    monkeypatch.setattr(swim, "_probe_pass_plain",
                        lambda *a: pytest.fail("took the plain twin"))
    with pytest.raises(RuntimeError, match="launch failed"):
        swim._probe_round(params, s, maps)
    assert seen["know"] is s.know and seen["offs"].shape == (4,)
    for name in swim.PROBE_INPLACE:
        assert seen[name] is getattr(s, name), name
    assert not any(name.endswith("_out") and name[:-4] in swim.PROBE_INPLACE
                   for name in seen)
    for name in ("want_out", "row_subject_out", "rtt_out", "acked_out"):
        assert seen[name].data_ptr() not in {
            getattr(s, f).untyped_storage().data_ptr()
            for f in swim.TENSOR_FIELDS}, name
    assert seen["chaos_grp"] is None
    assert torch.equal(seen["lha"], drawn["lha"])     # the same K1 batch


@pytest.mark.parametrize("caller", ("probe_round", "rejoin", "leave",
                                    "inject_suspicion"))
def test_originate_on_a_card_tensor_launches_k8(monkeypatch, caller):
    """Every origination on a CUDA tensor goes to K8, never the twin."""
    params, s, maps, drawn = _card_flagged(monkeypatch)
    seen = {}

    def refuse(**kw):
        seen.update(kw)
        raise RuntimeError("originate launch failed: CUDA error 1")

    monkeypatch.setattr(kernels, "launch_originate", refuse)
    monkeypatch.setattr(swim, "_originate_plain",
                        lambda *a: pytest.fail("took the plain twin"))
    if caller == "probe_round":
        monkeypatch.setattr(swim, "_probe_pass", swim._probe_pass_plain)
        call = lambda: swim._probe_round(params, s, maps)  # noqa: E731
    elif caller == "inject_suspicion":
        call = lambda: swim.inject_suspicion(params, s, 3, 5)  # noqa: E731
    else:
        call = lambda: getattr(swim, caller)(params, s, 3)  # noqa: E731
    with pytest.raises(RuntimeError, match="launch failed"):
        call()
    assert seen["alloc"] == params.alloc_cap and seen["want"].dtype == \
        torch.int32
    assert "know_out" not in seen and seen["know"].shape == s.know.shape
    if caller in ("leave", "inject_suspicion"):
        for name in swim.ORIGINATE_INPLACE:   # s itself, updated in place
            assert seen[name] is getattr(s, name), name
