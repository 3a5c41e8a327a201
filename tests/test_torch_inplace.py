"""The in-place contract of K7-K14, held on the CPU.

On the card `swim._probe_pass` (K7), `swim._originate` (K8),
`swim._suspicion_expiry` (K10), `swim._dense_suspicion_expiry` (K11
around K8), `swim._refutation` and `swim._expire` (K12) and
`swim._bulk_step` (K14) update the swim state they are given in place,
`vivaldi.observe_ring` (K13) the window and adjustment of its Vivaldi
state, and `swim._map_add` and `swim._maps_convert` (K9) the subject
maps they are given, so every step or command that reaches them consumes
its state (a tick with the bulk channel live, gossip-only or not,
included).  A node-sharded pool's passes (models/swim_blocks.py: their
block forms on the card) consume their blocks the same way.  The CPU
runs their pure twins, which cannot show a caller that reads a state or
a map again after passing it on.  The `consuming` fixture makes the CPU
behave as the card's worst case: after each call of the ten wrappers, or
of the sharded passes, it overwrites the input's in-place leaves or maps
(every block and copy) with a sentinel, except one the output still
holds.  Each caller the
port ships must give the same results under it as without it; a
caller that reads a consumed state again (as `GossipOracle.warmup` did
when it ran its commands on the live pool) gives other results.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)

from consul_tpu_torch import (bench, chaos, config, correlated, f1,
                              leave_propagation, scenarios)
from consul_tpu_torch.models import serf, swim, swim_blocks, vivaldi
from consul_tpu_torch.oracle import GossipOracle
from consul_tpu_torch.parallel import mesh

SENTINEL = {torch.bool: True, torch.int8: -77, torch.int16: -7777,
            torch.int32: -777777, torch.float32: float("nan")}


def _pieces(v) -> tuple:
    """A leaf's tensors: its blocks, its copies, or itself (none for a
    host field)."""
    if isinstance(v, (mesh.Blocks, mesh.Replicated)):
        return swim._pieces(v)
    return (v,) if isinstance(v, torch.Tensor) else ()


def _storages(state) -> set:
    return {t.untyped_storage().data_ptr()
            for f in dataclasses.fields(state)
            for t in _pieces(getattr(state, f.name))}


def _consume(before, after, fields) -> None:
    """What the card leaves of `before` once a kernel has written `after`
    in place: every leaf in `fields` (each block or copy) that `after`
    does not hold becomes garbage."""
    kept = _storages(after)
    for f in fields:
        for t in _pieces(getattr(before, f)):
            if t.untyped_storage().data_ptr() not in kept:
                t.fill_(SENTINEL[t.dtype])


# each in-place wrapper: (its module, the leaves it writes, where its
# output state is)
CONSUMERS = {
    "_probe_pass": (swim, swim.PROBE_INPLACE, lambda out: out[0]),
    "_originate": (swim, swim.ORIGINATE_INPLACE, lambda out: out[0]),
    "_suspicion_expiry": (swim, swim.EXPIRY_INPLACE, lambda out: out[0]),
    "_dense_suspicion_expiry": (swim, swim.DENSE_INPLACE
                                + swim.ORIGINATE_INPLACE, lambda out: out),
    "_refutation": (swim, swim.REFUTE_INPLACE, lambda out: out),
    "_expire": (swim, swim.FREE_INPLACE, lambda out: out),
    "observe_ring": (vivaldi, vivaldi.RING_INPLACE, lambda out: out),
    "_bulk_step": (swim, swim.BULK_INPLACE, lambda out: out),
}
# the sharded passes that consume their state as the wrappers above do,
# counted under the wrapper's name
BLOCK_CONSUMERS = {
    "probe_pass": "_probe_pass", "originate": "_originate",
    "suspicion_expiry": "_suspicion_expiry",
    "dense_expiry": "_dense_suspicion_expiry", "refutation": "_refutation",
    "expire": "_expire", "map_add": "_map_add",
    "maps_convert": "_maps_convert",
}
# K9's updates: (the maps a call consumes of its arguments, the maps its
# output holds)
MAP_CONSUMERS = {
    "_map_add": (lambda args: [args[0]], lambda out: [out]),
    "_maps_convert": (lambda args: list(args[0][:2]),
                      lambda out: list(out[:2])),
}


@pytest.fixture
def consuming(monkeypatch):
    calls = {name: 0 for name in (*CONSUMERS, *MAP_CONSUMERS)}

    def wrap(name, real, fields, state_of):
        def fn(params, s, *args):
            out = real(params, s, *args)
            _consume(s, state_of(out), fields)
            calls[name] += 1
            return out
        return fn

    def wrap_maps(name, real, taken, kept):
        def fn(*args):
            out = real(*args)
            held = {t.untyped_storage().data_ptr() for m in kept(out)
                    for t in _pieces(m)}
            for m in taken(args):
                for t in _pieces(m):
                    if t.untyped_storage().data_ptr() not in held:
                        t.fill_(SENTINEL[t.dtype])
            calls[name] += 1
            return out
        return fn

    for name, (module, fields, state_of) in CONSUMERS.items():
        monkeypatch.setattr(module, name, wrap(name, getattr(module, name),
                                               fields, state_of))
    for name, (taken, kept) in MAP_CONSUMERS.items():
        monkeypatch.setattr(swim, name, wrap_maps(name, getattr(swim, name),
                                                  taken, kept))
    for block, name in BLOCK_CONSUMERS.items():
        real = getattr(swim_blocks, block)
        if name in MAP_CONSUMERS:
            fn = wrap_maps(name, real, *MAP_CONSUMERS[name])
        else:
            fn = wrap(name, real, *CONSUMERS[name][1:])
        monkeypatch.setattr(swim_blocks, block, fn)
    return calls


def _leaves(state) -> dict:
    """Every tensor leaf and host mirror of a swim or serf state (a
    sharded one gathered), as numpy and plain values."""
    state = mesh.unshard_state(state)
    parts = ({"swim": state} if isinstance(state, swim.SwimState) else
             {"swim": state.swim, "coords": state.coords,
              "events": state.events})
    out = {}
    for part, x in parts.items():
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            out[f"{part}.{f.name}"] = v.numpy().copy() \
                if isinstance(v, torch.Tensor) else v
    return out


def _same(a, b) -> None:
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def _convergence():
    r = bench.run_convergence(n_nodes=1024, victim=341, device="cpu")
    keep = ("ticks", "frac", "converged", "f1", "false_commits",
            "sim_counters", "fracs", "timed_ticks_run")
    return dict({k: r[k] for k in keep}, state=_leaves(r["state"]))


def _convergence_sharded():
    r = bench.run_convergence(n_nodes=1024, victim=341,
                              mesh=mesh.make_mesh(["cpu"] * 4))
    keep = ("ticks", "frac", "converged", "f1", "false_commits",
            "sim_counters", "fracs", "timed_ticks_run")
    return dict({k: r[k] for k in keep}, state=_leaves(r["state"]))


def _correlated():
    row = correlated.run(nodes=4096, fractions=[0.01], max_ticks=512,
                         chunk=128, seed=7, device="cpu")[0]
    return {k: v for k, v in row.items() if k != "wall_seconds"}


def _correlated_bulk():
    """A row whose kills overflow 8 rumor slots into the bulk channel."""
    row = correlated.run(nodes=2048, fractions=[0.03], rumor_slots=[8],
                         max_ticks=256, chunk=128, seed=7, device="cpu")[0]
    assert row["bulk_ticks"] > 0
    return {k: v for k, v in row.items() if k != "wall_seconds"}


def _scenario(name):
    def run():
        violations, detail = chaos.SCENARIOS[name](7, n=128, device="cpu")
        return violations, detail
    return run


def _wan():
    params, s, row = scenarios.wan_point(2, 128, 3, "cpu")
    row = {k: v for k, v in row.items() if k != "converge_wall_s"}
    return row, [_leaves(c) for c in (*s.lan, s.wan)]


def _leave():
    return leave_propagation.run(nodes=2048, device="cpu")


def _f1():
    return f1.run_one(n=512, kills=4, ticks=300, p_loss=0.02, seed=5,
                      device="cpu")


def _oracle_sim():
    return config.SimConfig(n_nodes=256, n_initial=240, rumor_slots=16,
                            p_loss=0.01, seed=31)


def _oracle():
    o = GossipOracle(config.GossipConfig.lan(), _oracle_sim(), device="cpu")
    o.warmup()
    o.advance(12)
    o.kill("node7")
    o.leave("node9")
    o.advance(40)
    o.revive("node7")
    o.spawn()
    o.advance(30)
    return {"summary": o.members_summary(), "members": o.members(limit=300),
            "delta": o.members_delta(), "status": [o.status(f"node{i}")
                                                   for i in (3, 7, 9, 240)],
            "state": _leaves(o._state)}


def _oracle_sharded():
    """The sharded oracle's commands (parallel/mesh.py: 4 blocks)."""
    o = GossipOracle(config.GossipConfig.lan(), _oracle_sim(), device="cpu",
                     mesh=mesh.make_mesh(["cpu"] * 4))
    o.warmup()
    o.advance(12)
    o.kill("node7")
    o.advance(40)
    o.revive("node7")
    o.advance(30)
    return {"summary": o.members_summary(), "members": o.members(limit=300),
            "delta": o.members_delta(), "status": [o.status(f"node{i}")
                                                   for i in (3, 7, 9, 239)],
            "metrics": o.sim_metrics(), "state": _leaves(o._state)}


CALLERS = {
    "bench.run_convergence": _convergence,
    "bench.run_convergence (mesh)": _convergence_sharded,
    "GossipOracle (mesh)": _oracle_sharded,
    "correlated.run": _correlated,
    "correlated.run (bulk channel)": _correlated_bulk,
    **{f"chaos {name}": _scenario(name) for name in sorted(chaos.SCENARIOS)},
    "wan.run": _wan,
    "leave_propagation": _leave,
    "f1": _f1,
    "GossipOracle": _oracle,
}
# the callers that step the serf pool, whose probe ticks run K13
SERF_CALLERS = {"bench.run_convergence", "wan.run", "GossipOracle",
                "bench.run_convergence (mesh)", "GossipOracle (mesh)"}
# the callers whose runs fill the bulk channel (K14)
BULK_CALLERS = {"correlated.run (bulk channel)"}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_caller_never_reads_a_consumed_state(caller, request):
    """The caller gives the same results whether or not the states it
    passes to K7, K8 and K10-K14 and the maps it passes to K9's updates
    are consumed; the fixture was exercised, a probe tick's K9-K12 among
    it, K13 by every caller that runs the serf pool and K14 by every
    caller that fills the bulk channel."""
    ref = CALLERS[caller]()
    calls = request.getfixturevalue("consuming")
    got = CALLERS[caller]()
    assert calls["_originate"] > 0
    assert calls["_suspicion_expiry"] > 0
    assert calls["_dense_suspicion_expiry"] > 0
    assert calls["_refutation"] > 0
    assert calls["_expire"] > 0
    assert calls["_map_add"] > 0 and calls["_maps_convert"] > 0
    if caller in BULK_CALLERS:
        assert calls["_bulk_step"] > 0
    if caller != "GossipOracle":
        assert calls["_probe_pass"] > 0
    if caller in SERF_CALLERS:
        assert calls["observe_ring"] > 0
    _same(got, ref)


def _oracle_bulk_overflow():
    """A sharded oracle (4 blocks) whose kills fill the bulk channel at a
    probe tick (13 of 64 nodes, alloc_cap 1): the advance that fills it
    and the next raise; then its reads."""
    sim = config.SimConfig(n_nodes=64, rumor_slots=8, alloc_cap=1,
                           p_loss=0.01, seed=3)
    o = GossipOracle(config.GossipConfig.lan(), sim, device="cpu",
                     mesh=mesh.make_mesh(["cpu"] * 4))
    o.advance(5)
    for i in range(3, 64, 5):
        o.kill(f"node{i}")
    refused = []
    for _ in range(100):
        try:
            o.advance(1)
        except mesh.BulkChannelLive as e:
            refused.append((o.tick, str(e)))
            if len(refused) == 2:
                break
    return {"refused": refused, "summary": o.members_summary(),
            "members": o.members(limit=100), "metrics": o.sim_metrics(),
            "state": _leaves(o._state)}


def test_sharded_oracle_keeps_the_pool_its_bulk_refusal_leaves(request):
    """The sharded oracle's advance that fills the bulk channel raises and
    keeps the pool the probe passes left, so its reads answer the same
    whether or not the passes consume the state they are given, and the
    next advance refuses at the same tick with nothing run."""
    ref = _oracle_bulk_overflow()
    calls = request.getfixturevalue("consuming")
    got = _oracle_bulk_overflow()
    assert calls["_dense_suspicion_expiry"] > 0
    (tick, first), (tick2, second) = ref["refused"]
    assert tick == tick2 and "dense expiry" in first \
        and "is live" in second
    assert ref["state"]["swim.bulk_live"]
    _same(got, ref)


def test_the_fixture_sees_a_caller_that_rereads_its_state(consuming):
    """The warmup as it stood before it cloned (the commands and the tick
    run on the live pool, their results dropped) leaves the oracle's pool
    changed under the fixture; the warmup as it stands leaves it as it
    was."""
    o = GossipOracle(config.GossipConfig.lan(), _oracle_sim(), device="cpu")
    o.advance(5)
    kept = _leaves(o._state)
    o.warmup()
    _same(_leaves(o._state), kept)
    s = o._state
    try:
        swim.rejoin(o.params.swim, s.swim, 0)
        swim.leave(o.params.swim, s.swim, 0)   # reads what rejoin consumed
        swim.kill(s.swim, 0)
        serf.step(o.params, s)
    except IndexError:
        pass    # a sentinel subject indexed out of the pool: seen too
    changed = [k for k, v in _leaves(o._state).items()
               if isinstance(v, np.ndarray) and not np.array_equal(
                   v, kept[k], equal_nan=v.dtype.kind == "f")]
    assert changed, "the fixture left a reread state intact"
    assert set(changed) <= {f"swim.{f}" for f in
                            swim.ORIGINATE_INPLACE + swim.PROBE_INPLACE
                            + swim.EXPIRY_INPLACE + swim.DENSE_INPLACE
                            + swim.REFUTE_INPLACE + swim.FREE_INPLACE
                            + swim.BULK_INPLACE} \
        | {f"coords.{f}" for f in vivaldi.RING_INPLACE}


def test_writable_rejects_shared_or_strided_leaves():
    """The wrappers' check before an in-place launch: every leaf a kernel
    writes is contiguous and has a storage of its own."""
    params = swim.make_params(config.GossipConfig.lan(),
                              config.SimConfig(n_nodes=40, rumor_slots=8))
    s = swim.init_state(params, device="cpu")
    swim._writable(s, swim.PROBE_INPLACE, "K7")
    swim._writable(s, swim.ORIGINATE_INPLACE, "K8")
    swim._writable(s, swim.EXPIRY_INPLACE, "K10")
    swim._writable(s, swim.DENSE_INPLACE, "K11")
    swim._writable(s, swim.REFUTE_INPLACE, "K12")
    swim._writable(s, swim.FREE_INPLACE, "K12 expire")
    swim._writable(s, swim.BULK_INPLACE, "K14")
    c = vivaldi.init_state(vivaldi.VivaldiParams(n_nodes=40), device="cpu")
    swim._writable(c, vivaldi.RING_INPLACE, "K13")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(r_start=s.r_inc), swim.REFUTE_INPLACE, "K12")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(committed_left=s.committed_dead),
                       swim.FREE_INPLACE, "K12 expire")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(c.replace(adjustment=c.adj_window.view(-1)[:40]),
                       vivaldi.RING_INPLACE, "K13")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(sends_left=s.know.view(torch.int8)),
                       swim.PROBE_INPLACE, "K7")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(r_inc=s.r_subject), swim.ORIGINATE_INPLACE,
                       "K8")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(r_kind=s.know.view(torch.int8)[0]),
                       swim.EXPIRY_INPLACE, "K10")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(bulk_cov=s.bulk_heard), swim.DENSE_INPLACE,
                       "K11")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable(s.replace(committed_dead=s.bulk_member),
                       swim.BULK_INPLACE, "K14")
    with pytest.raises(ValueError, match="contiguous"):
        swim._writable(s.replace(bulk_heard=torch.stack(
            [s.bulk_heard, s.bulk_heard], 1)[:, 0]), swim.BULK_INPLACE,
            "K14")
    with pytest.raises(ValueError, match="contiguous"):
        swim._writable(s.replace(know=s.know.t().contiguous().t()),
                       swim.ORIGINATE_INPLACE, "K8")
    # a leaf K7 only reads may share storage with another
    swim._writable(s.replace(committed_left=s.committed_dead),
                   swim.PROBE_INPLACE, "K7")


def test_clone_owns_every_tensor():
    params = serf.make_params(config.GossipConfig.lan(),
                              config.SimConfig(n_nodes=32, rumor_slots=8))
    s = serf.init_state(params, device="cpu")
    c = s.clone()
    assert _storages(c.swim).isdisjoint(_storages(s.swim))
    for part in ("coords", "events"):
        for f in dataclasses.fields(getattr(s, part)):
            v = getattr(getattr(s, part), f.name)
            w = getattr(getattr(c, part), f.name)
            if isinstance(v, torch.Tensor):
                assert w.data_ptr() != v.data_ptr() and torch.equal(v, w)
            else:
                assert w == v
    _same(_leaves(c), _leaves(s))
    v = s.coords.clone()      # what observe_ring's caller keeps (K13)
    assert _storages(v).isdisjoint(_storages(s.coords))
    for f in dataclasses.fields(v):
        a, b = getattr(v, f.name), getattr(s.coords, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_writable_maps_takes_the_rows_of_one_block():
    """K9's check before an update in place: the rows of _maps' [4, N]
    block share a storage but no bytes, so they pass; a map written twice
    or overlapping another, or a strided one, raises."""
    block = torch.zeros((4, 40), dtype=torch.int32)
    swim._writable_maps({"suspect_of": block[0], "dead_of": block[1]}, "K9")
    swim._writable_maps({"map": block[3]}, "K9")
    with pytest.raises(ValueError, match="share storage"):
        swim._writable_maps({"suspect_of": block[0], "dead_of": block[0]},
                            "K9")
    flat = block.view(-1)
    with pytest.raises(ValueError, match="share storage"):
        swim._writable_maps({"suspect_of": flat[:40], "dead_of": flat[39:79]},
                            "K9")
    with pytest.raises(ValueError, match="contiguous"):
        swim._writable_maps({"map": block[:, 0]}, "K9")
