"""The plain twins of K13 (`vivaldi.observe_ring_plain`) and K14
(`swim._bulk_step_plain`) against the JAX package on the CPU, and their
wrappers' dispatch.

P2 for the Vivaldi ring observation: numpy-seeded states at N = 64 and
1000 with masked rows, colocated rows (the normal-draw branch), a wrapping
window column (adj_index >= W) and a nonzero ring shift, and a fresh pool
whose rows are all colocated; every float leaf within 1e-5 of its scale
(max|port - ref| <= 1e-5 * max|ref|: the norms, the mean and the normal
draw's erf_inv round a few ulp apart in XLA and PyTorch, the bound of
tests/test_torch_serf.py).  The port takes the probe round's RTTs in
milliseconds, JAX the seconds serf.step divides out.

P2 for the bulk death channel: JAX's `_bulk_commit(_bulk_disseminate(s))`
(or `s` itself when no bulk member is left: step_with_obs' lax.cond) on
states with no member, heard counts above V (the revive clamp), commits
near the 0.995 bar and the nemesis build's gated views, plus a
hypothesis property over random states.  Bool leaves are equal; float
leaves within BULK_RTOL of their scale: the commit subtracts the float
sum `removed`, summed in XLA's and torch's own orders, from every heard
count, so an ulp of that sum is an absolute error on a heard count near
0.

K14's decomposition, transcribed in numpy and held to the twin under
hypothesis: its ring offsets drawn from the randint spec its wrapper
passes (rolls.offsets' draw, element by element), and its one launch's
phase order (count, supply, advance, commit): every peer's old
bulk_heard read before any leaf is written, only changed values written,
and nothing written on an empty channel.

On the CPU both wrappers take their twins (`serf.step` included); on a
CUDA tensor they launch or raise, and raise when the kernel library
cannot be loaded.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from torch_parity import jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import swim as jswim
from consul_tpu.models import vivaldi as jviv
from consul_tpu_torch import config, convert, kernels
from consul_tpu_torch.models import serf, swim, vivaldi
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.utils import prng

SCALE_RTOL = 1e-5
BULK_RTOL = 1e-5
CSRC = Path(kernels.__file__).parent / "csrc"


def _close(ref, got, what, rtol=SCALE_RTOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, what
    err = np.abs(got.astype(np.float64) - ref).max() if ref.size else 0.0
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), \
        f"{what}: {err} vs scale {np.abs(ref).max()}"


# ---------------------------------------------------------------------------
# K13's twin: observe_ring_plain
# ---------------------------------------------------------------------------

def _ring_inputs(n, seed, adj_index, zero=False, dims=8, w=20):
    """A state dict, the shift, rtt_ms [N] float32 and the ack mask: coords
    of tens of ms (all zero for a fresh pool), ~10% of the rows colocated
    with their ring peer, some RTTs 0 (floored at 1e-6 s), ~20% unacked."""
    rng = np.random.default_rng(seed)
    coords = (rng.standard_normal((n, dims)) * 0.02).astype(np.float32)
    if zero:
        coords[:] = 0.0
    shift = int(rng.integers(1, n))
    rows = np.nonzero(rng.random(n) < 0.1)[0]
    coords[(rows + shift) % n] = coords[rows]
    d = {"coords": coords,
         "height": (rng.random(n) * 1e-3 + 1e-5).astype(np.float32),
         "error": (rng.random(n) * 1.4 + 0.05).astype(np.float32),
         "adj_window": (rng.standard_normal((n, w)) * 1e-4).astype(np.float32),
         "adj_index": np.int32(adj_index),
         "adjustment": (rng.standard_normal(n) * 1e-4).astype(np.float32)}
    if zero:
        d["height"][:] = np.float32(1e-5)
        d["error"][:] = np.float32(1.5)
        d["adj_window"][:] = 0.0
        d["adjustment"][:] = 0.0
    rtt_ms = (rng.random(n) * 50).astype(np.float32)
    rtt_ms[::13] = 0.0
    acked = rng.random(n) < 0.8
    return d, shift, rtt_ms, acked


def _ring_pair(n, seed, adj_index, zero=False):
    d, shift, rtt_ms, acked = _ring_inputs(n, seed, adj_index, zero)
    jp = jviv.VivaldiParams(n_nodes=n, dims=8, seed=seed)
    tp = vivaldi.VivaldiParams(n_nodes=n, dims=8, seed=seed)
    js = jviv.observe_ring(jp, jviv.VivaldiState(
        **{k: jnp.asarray(v) for k, v in d.items()}), jnp.int32(shift),
        jnp.asarray(rtt_ms / np.float32(1000.0)), jnp.asarray(acked))
    ts = vivaldi.observe_ring_plain(
        tp, convert.vivaldi_state_from_numpy(d, "cpu"),
        torch.tensor(shift, dtype=torch.int32), torch.from_numpy(rtt_ms),
        torch.from_numpy(acked))
    return d, shift, js, ts


@pytest.mark.parametrize("n,seed,adj_index", [(64, 1, 3), (64, 2, 47),
                                              (1000, 3, 11), (1000, 4, 65)])
def test_observe_ring_plain_matches_reference(n, seed, adj_index):
    d, shift, js, ts = _ring_pair(n, seed, adj_index)
    coloc = np.abs(d["coords"] - np.roll(d["coords"], -shift, 0)).max(1) == 0
    assert 0 < coloc.sum() < n
    ref = jax_dict(js)
    got = convert.vivaldi_state_to_numpy(ts)
    assert int(got["adj_index"]) == int(ref["adj_index"]) == adj_index + 1
    for name in ("coords", "height", "error", "adj_window", "adjustment"):
        _close(ref[name], got[name], name)
    # the wrapped column moved, and only it
    col = adj_index % 20
    others = np.arange(20) != col
    np.testing.assert_array_equal(got["adj_window"][:, others],
                                  d["adj_window"][:, others])
    assert (got["adj_window"][:, col] != d["adj_window"][:, col]).any()


def test_observe_ring_plain_fresh_pool_is_all_colocated():
    """A fresh pool's first probe tick: every row takes the normal draw."""
    d, _, js, ts = _ring_pair(256, 5, 0, zero=True)
    ref = jax_dict(js)
    got = convert.vivaldi_state_to_numpy(ts)
    for name in ("coords", "height", "error", "adj_window", "adjustment"):
        _close(ref[name], got[name], name)
    assert (np.abs(got["coords"]).sum(1) > 0).mean() > 0.7


def test_serf_step_takes_the_twin_on_the_cpu():
    """serf.step's coordinates are observe_ring_plain of the tick's probe
    observations, from the RTTs in milliseconds, bit for bit."""
    params = serf.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=128, rumor_slots=16, p_loss=0.01, seed=5))
    s = serf.init_state(params, device="cpu")
    for _ in range(12):
        sw, obs = swim.step_with_obs(params.swim, s.swim)
        nxt = serf.step(params, s)
        if obs is not None:
            want = vivaldi.observe_ring_plain(params.vivaldi, s.coords,
                                              obs.shift, obs.rtt_ms,
                                              obs.acked)
            for f in ("coords", "height", "error", "adj_window",
                      "adjustment"):
                assert torch.equal(getattr(nxt.coords, f), getattr(want, f))
            assert nxt.coords.adj_index == want.adj_index
        s = nxt
    assert s.coords.adj_index >= 2


# ---------------------------------------------------------------------------
# K14's twin: _bulk_step_plain
# ---------------------------------------------------------------------------

def _bulk_params(n, p_loss=0.01, chaos=False, seed=3):
    sim = dict(n_nodes=n, rumor_slots=16, p_loss=p_loss, seed=seed,
               chaos=chaos)
    return (jswim.make_params(jconfig.GossipConfig.lan(),
                              jconfig.SimConfig(**sim)),
            swim.make_params(config.GossipConfig.lan(),
                             config.SimConfig(**sim)))


def _bulk_leaves(n, seed, members=0.2, heard_over=1.0, near_bar=0.3,
                 chaos=False):
    """[N] leaves of a bulk channel mid-flight: `members` of the nodes in
    it (down, as overflowed victims mostly are), heard counts up to
    heard_over * V, coverage in [0, 1) with `near_bar` of the members just
    under the 0.995 commit bar; the nemesis build's groups and rates."""
    rng = np.random.default_rng(seed)
    bm = rng.random(n) < members
    v = max(int(bm.sum()), 1)
    cov = rng.random(n).astype(np.float32)
    close = rng.random(n) < near_bar
    cov[close] = (np.float32(0.99) + rng.random(close.sum()).astype(np.float32)
                  * np.float32(0.0049)).astype(np.float32)
    d = {"up": (rng.random(n) < 0.9) & ~(bm & (rng.random(n) < 0.8)),
         "member": rng.random(n) < 0.97,
         "committed_dead": rng.random(n) < 0.01,
         "bulk_member": bm,
         "bulk_heard": (rng.random(n) * v * heard_over).astype(np.float32),
         "bulk_cov": np.where(bm, cov, np.float32(0)).astype(np.float32),
         "tick": np.int32(rng.integers(0, 5000))}
    if chaos:
        d["chaos_grp"] = (rng.random(n) < 0.25).astype(np.int16)
        d["chaos_ok"] = np.where(rng.random(n) < 0.1, np.float32(0.55),
                                 np.float32(1.0)).astype(np.float32)
    return d


def _bulk_pair(jp, tp, leaves):
    js = jswim.init_state(jp).replace(
        **{k: jnp.asarray(v) for k, v in leaves.items()})
    ts = convert.swim_state_from_numpy(jax_dict(js), device="cpu")
    if bool(np.asarray(js.bulk_member).any()):
        ref = jswim._bulk_commit(jp, jswim._bulk_disseminate(jp, js))
    else:
        ref = js                          # step_with_obs' lax.cond
    return js, ref, swim._bulk_step_plain(tp, ts)


def _assert_bulk(ref, got, where=""):
    a = jax_dict(ref)
    b = convert.swim_state_to_numpy(got)
    for name in ("committed_dead", "bulk_member"):
        np.testing.assert_array_equal(b[name], a[name],
                                      err_msg=where + name)
    for name in ("bulk_heard", "bulk_cov"):
        _close(a[name], b[name], where + name, rtol=BULK_RTOL)
    for name in b:                        # nothing else moves
        if name not in ("committed_dead", "bulk_member", "bulk_heard",
                        "bulk_cov"):
            np.testing.assert_array_equal(b[name], a[name],
                                          err_msg=where + name)


BULK_CASES = {
    "no member": dict(members=0.0),
    "revive clamp": dict(heard_over=1.6),
    "commits": dict(near_bar=0.6),
    "chaos": dict(chaos=True, near_bar=0.5),
    "chaos revive clamp": dict(chaos=True, heard_over=1.4),
}


@pytest.mark.parametrize("case", sorted(BULK_CASES))
@pytest.mark.parametrize("n", [64, 1000])
def test_bulk_step_plain_matches_reference(case, n):
    kw = BULK_CASES[case]
    jp, tp = _bulk_params(n, chaos=kw.get("chaos", False))
    js, ref, got = _bulk_pair(jp, tp, _bulk_leaves(n, n + len(case), **kw))
    _assert_bulk(ref, got, f"{case}: ")
    before = np.asarray(js.bulk_member)
    after = got.bulk_member.numpy()
    if case == "no member":
        assert not before.any()
    else:
        assert before.any()
    if case in ("commits", "chaos"):
        assert (before & ~after).any()          # at least one commit
    if "revive" in case:
        assert (np.asarray(js.bulk_heard) > before.sum()).any()


def test_bulk_step_plain_chaos_gates_the_views():
    """The same state with and without the nemesis build's gates differs:
    the twin applies the groups and rates."""
    leaves = _bulk_leaves(1000, 7, chaos=True)
    _, tp = _bulk_params(1000, chaos=True)
    ts = convert.swim_state_from_numpy(
        jax_dict(jswim.init_state(_bulk_params(1000)[0]).replace(
            **{k: jnp.asarray(v) for k, v in leaves.items()})), device="cpu")
    gated = swim._bulk_step_plain(tp, ts)
    plain = swim._bulk_step_plain(dataclasses.replace(tp, chaos=False), ts)
    assert not torch.equal(gated.bulk_heard, plain.bulk_heard)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(5, 300), seed=st.integers(0, 2 ** 16),
       members=st.sampled_from([0.0, 0.02, 0.3, 0.9]),
       heard_over=st.sampled_from([0.0, 0.5, 1.0, 2.0]),
       near_bar=st.sampled_from([0.0, 0.5, 1.0]), chaos=st.booleans(),
       p_loss=st.sampled_from([0.0, 0.01, 0.3]))
def test_bulk_step_plain_property(n, seed, members, heard_over, near_bar,
                                  chaos, p_loss):
    jp, tp = _bulk_params(n, p_loss=p_loss, chaos=chaos, seed=seed % 97)
    _, ref, got = _bulk_pair(jp, tp, _bulk_leaves(
        n, seed, members, heard_over, near_bar, chaos))
    _assert_bulk(ref, got)


# ---------------------------------------------------------------------------
# K14's decomposition: its offsets draw and its phase order
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
ROUNDS = ((13, 15, 26, 6), (17, 29, 16, 24))


def randint_transcription(spec, i: int) -> int:
    """common.cuh:randint_lanes for element i of a randint DrawSpec: the
    threefry2x32 rounds of threefry_lanes from each key schedule, folded
    with the spec's range, multiplier and minval (int32)."""
    def bits(k):
        x0, x1 = (i >> 32) + k[0] & M32, (i & M32) + k[1] & M32
        inject = ((k[1], k[3]), (k[2], k[4]), (k[0], k[5]), (k[1], k[6]),
                  (k[2], k[7]))
        for group, (a, b) in enumerate(inject):
            for r in ROUNDS[group % 2]:
                x0 = (x0 + x1) & M32
                x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
            x0, x1 = (x0 + a) & M32, (x1 + b) & M32
        return x0 ^ x1
    sched = list(spec.sched)
    b1, b2 = bits(sched[:8]), bits(sched[8:])
    span = spec.range
    v = (((b1 % span) * spec.mult + b2 % span) % span + spec.minval) & M32
    return v - (1 << 32) if v >= 1 << 31 else v


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(-2 ** 31, 2 ** 31 - 1), tick=st.integers(0, 2 ** 20),
       n=st.sampled_from((2, 3, 15, 1000, 65_537, 1_000_000, 2 ** 31 - 1)),
       g=st.integers(1, 16))
def test_k14_draws_the_ring_offsets_of_rolls_offsets(seed, tick, n, g):
    """The spec _bulk_step hands K14 (stream 4 of the tick, as the twin's
    rolls.offsets) gives, element by element through the kernel's randint
    steps, the offsets rolls.offsets draws."""
    key = prng.tick_key(seed, tick, 4)
    spec = prng.randint_spec(rolls.offsets_draw(key, n, g))
    assert spec.n == g and spec.mode == kernels.DRAW_MODES.index("randint")
    assert not spec.out
    want = rolls.offsets(key, n, g, "cpu").tolist()
    assert [randint_transcription(spec, i) for i in range(g)] == want


def _grown(cov, sel, p_ok, g):
    """bulk.cu:grown, each float32 step rounded (integer_pow's square and
    multiply from the low bit)."""
    f = np.float32
    x = min(max(f(f(cov * sel) * p_ok), f(0)), f(1))
    q, acc, y = f(1) - x, None, g
    while y > 0:
        if y & 1:
            acc = q if acc is None else f(acc * q)
        y >>= 1
        if y > 0:
            q = f(q * q)
    p_learn = f(1) - acc
    return min(max(f(cov + f(f(1) - cov) * p_learn), f(0)), f(1))


def bulk_transcription(leaves, offs, cap, p_ok, chaos, threads):
    """bulk.cu's launch on numpy leaves, `threads` grid threads taking
    rows i, i + threads, ...: the count; with V = 0 nothing more.  Phases
    1-3 read the leaves it updates as read-only arrays (a write raises),
    so every peer's bulk_heard is read old; phase 4 writes a row's leaves
    only where a value's bits change.  Sums in float64, each thread's in
    its row order.  Returns (the four leaves after it, {leaf: rows
    written})."""
    f = np.float32
    names = ("bulk_member", "bulk_heard", "bulk_cov", "committed_dead")
    out = {k: leaves[k].copy() for k in names}
    for a in out.values():
        a.setflags(write=False)
    bm, heard_in, cov_in, cd = (out[k] for k in names)
    up, member = leaves["up"], leaves["member"]
    n = len(bm)
    rows = [range(t, n, threads) for t in range(threads)]
    written = {k: set() for k in names}

    def total(fn):
        return sum(sum(fn(i) for i in r) for r in rows)

    V = total(lambda i: float(bool(bm[i])))
    if V == 0.0:
        return out, written
    vf = max(f(V), f(1))
    carry = np.empty(n, np.float32)
    for r in rows:                                  # 2. supply, heard'
        for i in r:
            heard = min(heard_in[i], vf)
            if up[i] and member[i]:
                for d in offs:
                    j = (i + d) % n
                    view = min(heard_in[j], vf) if up[j] else f(0)
                    if chaos:
                        view = f(f(view * leaves["chaos_ok"][j])
                                 * leaves["chaos_ok"][i]) \
                            if leaves["chaos_grp"][j] == \
                            leaves["chaos_grp"][i] else f(0)
                    supply = min(view, f(cap))
                    novelty = f(1) - f(heard / vf)
                    heard = min(f(heard + f(f(supply * novelty) * p_ok)), vf)
            carry[i] = heard
    n_up = max(f(total(lambda i: float(bool(up[i])))), f(1))
    supply = f(total(lambda i: float(min(heard_in[i], vf)) if up[i]
                     else 0.0))
    sel = min(f(f(f(1) / max(f(supply / n_up), f(1))) * f(cap)), f(1))
    g = len(offs)

    def cov_of(i):                                  # 3. advance
        return _grown(cov_in[i], sel, f(p_ok), g)

    removed = f(total(lambda i: float(cov_of(i)) if bm[i]
                      and cov_of(i) >= f(0.995) else 0.0))
    v_new = f(total(lambda i: 1.0 if bm[i] and cov_of(i) < f(0.995)
                    else 0.0))
    for a in out.values():                          # 4. commit
        a.setflags(write=True)

    def put(name, i, v):
        if out[name][i].tobytes() != np.asarray(
                v, out[name].dtype).tobytes():
            out[name][i] = v
            written[name].add(i)

    for r in rows:
        for i in r:
            put("bulk_heard", i, min(max(f(carry[i] - removed), f(0)), v_new))
            cov = f(0)
            if bm[i]:
                cov = cov_of(i)
                if cov >= f(0.995):
                    cov = f(0)
                    put("bulk_member", i, False)
                    put("committed_dead", i, True)
            put("bulk_cov", i, cov)
    return out, written


@settings(max_examples=40, deadline=None)
@given(n=st.integers(5, 200), seed=st.integers(0, 2 ** 16),
       members=st.sampled_from([0.0, 0.02, 0.3, 0.9]),
       heard_over=st.sampled_from([0.0, 0.5, 1.0, 2.0]),
       near_bar=st.sampled_from([0.0, 0.5, 1.0]), chaos=st.booleans(),
       p_loss=st.sampled_from([0.0, 0.01, 0.3]),
       threads=st.sampled_from([1, 7, 64]))
def test_k14_phase_order_matches_the_twin(n, seed, members, heard_over,
                                          near_bar, chaos, p_loss, threads):
    """bulk.cu's one launch, phase by phase, against _bulk_step_plain:
    bools equal, floats within BULK_RTOL of scale.  It writes bulk_member
    and committed_dead only at the subjects the twin commits, bulk_cov
    only at members and where a non-member's input is not +0, bulk_heard
    only where the value changes, and nothing on an empty channel."""
    jp, tp = _bulk_params(n, p_loss=p_loss, chaos=chaos, seed=seed % 97)
    d = _bulk_leaves(n, seed, members, heard_over, near_bar, chaos)
    ts = convert.swim_state_from_numpy(jax_dict(jswim.init_state(jp).replace(
        **{k: jnp.asarray(v) for k, v in d.items()})), device="cpu")
    leaves = convert.swim_state_to_numpy(ts)
    offs = rolls.offsets(prng.tick_key(tp.seed, ts.tick, 4), n,
                         tp.gossip_nodes, "cpu").tolist()
    got, written = bulk_transcription(
        leaves, offs, np.float32(tp.packet_msgs), np.float32(1 - tp.p_loss),
        chaos, threads)
    ref = convert.swim_state_to_numpy(swim._bulk_step_plain(tp, ts))
    for name in ("bulk_member", "committed_dead"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in ("bulk_heard", "bulk_cov"):
        _close(ref[name], got[name], name, rtol=BULK_RTOL)
    bm = leaves["bulk_member"]
    if not bm.any():
        assert not any(written.values())
        return
    done = set(np.flatnonzero(bm & ~ref["bulk_member"]).tolist())
    assert written["bulk_member"] == done
    assert written["committed_dead"] <= done
    cov_bits = leaves["bulk_cov"].view(np.int32)
    assert written["bulk_cov"] <= set(np.flatnonzero(bm | (cov_bits != 0))
                                      .tolist())
    assert written["bulk_heard"] == set(np.flatnonzero(
        got["bulk_heard"].view(np.int32)
        != leaves["bulk_heard"].view(np.int32)).tolist())


# ---------------------------------------------------------------------------
# the wrappers: the twin on the CPU only; on a card the kernel or a raise
# ---------------------------------------------------------------------------

def _on_card(monkeypatch, twins=True):
    """Every tensor reads as a CUDA tensor; the twins fail the test."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    if twins:
        monkeypatch.setattr(vivaldi, "observe_ring_plain", lambda *a, **k:
                            pytest.fail("observe_ring took its twin"))
        monkeypatch.setattr(swim, "_bulk_step_plain", lambda *a, **k:
                            pytest.fail("_bulk_step took its twin"))


def _ring_call():
    d, shift, rtt_ms, acked = _ring_inputs(64, 1, 3)
    return (vivaldi.VivaldiParams(n_nodes=64, dims=8, seed=1),
            convert.vivaldi_state_from_numpy(d, "cpu"),
            torch.tensor(shift, dtype=torch.int32), torch.from_numpy(rtt_ms),
            torch.from_numpy(acked))


def _bulk_call(chaos=False):
    jp, tp = _bulk_params(64, chaos=chaos)
    js = jswim.init_state(jp).replace(**{
        k: jnp.asarray(v) for k, v in _bulk_leaves(64, 2, chaos=chaos).items()})
    return tp, convert.swim_state_from_numpy(jax_dict(js), device="cpu")


@pytest.mark.parametrize("chaos", [False, True])
def test_wrappers_raise_on_a_card_when_the_library_fails_to_load(
        monkeypatch, chaos):
    def unavailable():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed")

    monkeypatch.setattr(kernels, "library", unavailable)
    p, s, shift, rtt_ms, acked = _ring_call()
    tp, ts = _bulk_call(chaos)
    _on_card(monkeypatch)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        vivaldi.observe_ring(p, s, shift, rtt_ms, acked)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        swim._bulk_step(tp, ts)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("chaos", [False, True])
def test_wrappers_hand_the_kernels_the_state(monkeypatch, chaos):
    """On a card tensor the wrappers call K13 and K14 with the state's
    leaves (the nemesis build's groups and rates only under chaos), both
    writing in place; the bulk step hands K14 the randint spec of stream
    4 of the tick and draws no offsets itself."""
    seen = {}

    def record(name):
        def launch(**kw):
            seen[name] = kw
            raise RuntimeError(f"{name} launch failed: CUDA error 1")
        return launch

    monkeypatch.setattr(kernels, "launch_vivaldi_ring", record("vivaldi_ring"))
    monkeypatch.setattr(kernels, "launch_bulk_step", record("bulk_step"))
    p, s, shift, rtt_ms, acked = _ring_call()
    tp, ts = _bulk_call(chaos)
    spec = prng.randint_spec(rolls.offsets_draw(
        prng.tick_key(tp.seed, ts.tick, 4), tp.n_nodes, tp.gossip_nodes))
    monkeypatch.setattr(swim.rolls, "offsets", lambda *a: pytest.fail(
        "the bulk step drew its offsets with K1"))
    _on_card(monkeypatch)
    with pytest.raises(RuntimeError, match="vivaldi_ring launch failed"):
        vivaldi.observe_ring(p, s, shift, rtt_ms, acked)
    with pytest.raises(RuntimeError, match="bulk_step launch failed"):
        swim._bulk_step(tp, ts)
    ring = seen["vivaldi_ring"]
    assert ring["coords"] is s.coords and ring["rtt_ms"] is rtt_ms
    # the window's column and the adjustment are written in place
    assert ring["window"] is s.adj_window
    assert ring["adjustment"] is s.adjustment
    assert ring["col"] == 3 and ring["key"] == vivaldi._ring_key(p, s)
    assert ring["mean_factor"] == np.float32(1 / 20)
    assert ring["inv_rho"] == np.float32(1) / np.float32(150)
    bulk = seen["bulk_step"]
    for f in swim.BULK_INPLACE + ("up", "member"):
        assert bulk[f] is getattr(ts, f), f
    assert not any(k.endswith("_out") for k in bulk)
    assert bytes(bulk["offsets"]) == bytes(spec)
    assert (bulk["group"] is ts.chaos_grp) == chaos
    assert (bulk["node_ok"] is None) != chaos
    assert bulk["cap"] == np.float32(tp.packet_msgs)
    assert bulk["p_ok"] == np.float32(1 - tp.p_loss)


def _ring_args(n=16, d=8, w=20):
    f = lambda *shape: torch.zeros(shape)  # noqa: E731
    return dict(coords=f(n, d), height=f(n), error=f(n), window=f(n, w),
                rtt_ms=f(n), acked=torch.zeros(n, dtype=torch.bool),
                shift=torch.tensor(3, dtype=torch.int32), col=0, key=(1, 2),
                normal_lo=-1.0, normal_span=2.0, ce=0.25, cc=0.25,
                error_max=1.5, height_min=1e-5, inv_rho=0.0066, mean_factor=0.05,
                coords_out=f(n, d), height_out=f(n), error_out=f(n),
                adjustment=f(n))


def _spec(g=3, mode="randint", range_=15):
    spec = kernels.randint_spec(((1, 2), (3, 4)), 1, 1, range_, 0)
    spec.n, spec.mode = g, kernels.DRAW_MODES.index(mode)
    return spec


def _bulk_args(n=16, g=3):
    b = lambda: torch.zeros(n, dtype=torch.bool)  # noqa: E731
    f = lambda: torch.zeros(n)  # noqa: E731
    return dict(bulk_member=b(), bulk_heard=f(), bulk_cov=f(), up=b(),
                member=b(), committed_dead=b(), offsets=_spec(g), cap=30.0,
                p_ok=0.99)


BAD = {
    "ring D > 16": ("ring", dict(coords=torch.zeros(16, 17),
                                 coords_out=torch.zeros(16, 17)), "D=17"),
    "ring W > 32": ("ring", dict(window=torch.zeros(16, 33)), "W=33"),
    "ring column": ("ring", dict(col=20), "column 20"),
    "ring coords dtype": ("ring", dict(coords=torch.zeros(16, 8,
                                                          dtype=torch.float64)),
                          "coords"),
    "ring acked dtype": ("ring", dict(acked=torch.zeros(16)), "acked"),
    "ring rtt shape": ("ring", dict(rtt_ms=torch.zeros(17)), "rtt_ms"),
    "ring shift int64": ("ring", dict(shift=torch.tensor(3)), "shift"),
    "ring window not contiguous": ("ring", dict(
        window=torch.zeros(20, 16).t()), "window"),
    "bulk no offsets": ("bulk", dict(offsets=_spec(0)), "ring offsets"),
    "bulk 17 offsets": ("bulk", dict(offsets=_spec(17)), "ring offsets"),
    "bulk offsets not randint": ("bulk", dict(offsets=_spec(3, "bits")),
                                 "ring offsets"),
    "bulk offsets a tensor": ("bulk", dict(offsets=torch.arange(
        1, 4, dtype=torch.int32)), "ring offsets"),
    "bulk heard dtype": ("bulk", dict(bulk_heard=torch.zeros(16,
                                                             dtype=torch.float64)),
                         "bulk_heard"),
    "bulk member shape": ("bulk", dict(member=torch.zeros(17,
                                                          dtype=torch.bool)),
                          "member"),
    "bulk group alone": ("bulk", dict(group=torch.zeros(16,
                                                        dtype=torch.int16)),
                         "together"),
    "bulk node_ok dtype": ("bulk", dict(group=torch.zeros(16, dtype=torch.int16),
                                        node_ok=torch.zeros(16,
                                                            dtype=torch.float64)),
                           "node_ok"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrappers_reject_bad_tensors_before_launching(case):
    which, edit, match = BAD[case]
    args = _ring_args() if which == "ring" else _bulk_args()
    args.update(edit)
    launch = kernels.launch_vivaldi_ring if which == "ring" \
        else kernels.launch_bulk_step
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        launch(**args)
    assert kernels.LAUNCHES == before


def test_kernel_limits_match_the_sources():
    viv = (CSRC / "vivaldi.cu").read_text()
    bulk = (CSRC / "bulk.cu").read_text()
    assert f"kMaxD = {kernels.VIVALDI_MAX_DIMS};" in viv
    assert f"kMaxW = {kernels.VIVALDI_MAX_WINDOW};" in viv
    assert f"kMaxViews = {kernels.BULK_MAX_VIEWS};" in bulk
    assert re.search(rf"kResults = {kernels.BULK_RESULTS} }}", bulk)
    assert set(kernels.VIVALDI_BULK) <= set(kernels.SIGNATURES)
