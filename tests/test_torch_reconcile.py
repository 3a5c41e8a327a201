"""K6's plain twins against the JAX package on the CPU, bit for bit.

`diff_sorted` and `apply_push` (P2) against consul_tpu/ops/reconcile.py,
and `merge` in step's form against antientropy.step's drop compaction
followed by `_merge_push`, on tables made from a seed with numpy and on
hypothesis-generated sorted unique tables: M != K, every row pushed and
none, all INVALID, every pushed id already in the catalog, more valid
rows than K (the merge overflows), the INVALID tail's payloads included.
Every output leaf and every row is compared, no tolerance (int32 and
bool only).  The twins' precondition checks close the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from consul_tpu.models import antientropy as jae
from consul_tpu.ops import reconcile as jrec
from consul_tpu_torch.ops import reconcile

INV = reconcile.INVALID_ID
assert INV == int(jrec.INVALID_ID)


def _table(rng, rows, valid, universe, ids=None):
    """rows int32 ids: `valid` unique ascending ids from [0, universe)
    (or the given ones), then INVALID; versions and nodes random in every
    row, the tail included."""
    if ids is None:
        ids = np.sort(rng.choice(universe, size=valid, replace=False))
    out = np.full(rows, INV, np.int32)
    out[:len(ids)] = ids
    ver = rng.integers(0, 4, rows).astype(np.int32)
    node = rng.integers(0, 1000, rows).astype(np.int32)
    return out, ver, node


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


@jax.jit
def _jax_step_merge(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push, drop):
    """antientropy.step's lines 136-138 then _merge_push, as step runs
    them."""
    a_ids = jnp.where(drop, jrec.INVALID_ID, a_ids)
    order = jnp.argsort(jnp.where(a_ids == jrec.INVALID_ID, 1, 0), stable=True)
    a_ids, a_node, a_ver = a_ids[order], a_node[order], a_ver[order]
    return jae._merge_push(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push)


def _hold_merge(d, a, push, drop):
    ref = _jax_step_merge(*map(_j, d), *map(_j, a), _j(push), _j(drop))
    got = reconcile.merge(*map(_t, d), *map(_t, a), _t(push), _t(drop))
    for name, r, g in zip(("ids", "ver", "node"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"merge {name}")
        assert g.dtype == torch.int32
    return got


def _hold_apply_push(d, a, push):
    ref = jax.jit(jrec.apply_push)(_j(d[0]), _j(d[1]), _j(a[0]), _j(a[1]),
                                   _j(push))
    got = reconcile.apply_push(_t(d[0]), _t(d[1]), _t(a[0]), _t(a[1]),
                               _t(push))
    for name, r, g in zip(("ids", "ver"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"apply_push {name}")


def _hold_diff(d, a):
    ref = jax.jit(jrec.diff_sorted)(_j(d[0]), _j(d[1]), _j(a[0]), _j(a[1]))
    got = reconcile.diff_sorted(_t(d[0]), _t(d[1]), _t(a[0]), _t(a[1]))
    np.testing.assert_array_equal(got.push.numpy(), np.asarray(ref.push))
    np.testing.assert_array_equal(got.drop.numpy(), np.asarray(ref.drop))
    assert got.push.dtype == got.drop.dtype == torch.bool
    return got


# (M, K, valid desired, valid catalog, universe, push rate, drop rate)
SEEDED = {
    "equal sizes": (512, 512, 300, 280, 1000, 0.5, 0.3),
    "M > K": (700, 300, 500, 200, 900, 0.6, 0.2),
    "M < K": (100, 900, 80, 600, 2000, 0.5, 0.5),
    "every row pushed": (256, 256, 256, 100, 600, 1.0, 0.0),
    "none pushed": (256, 256, 200, 200, 400, 0.0, 0.4),
    "all INVALID": (64, 96, 0, 0, 10, 0.5, 0.5),
    "overflow": (400, 200, 390, 180, 5000, 1.0, 0.0),
    "full catalog": (300, 300, 250, 300, 700, 0.7, 0.1),
    "one row": (1, 1, 1, 1, 2, 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_diff_merge_and_apply_push_match_reference(case):
    m, k, vd, va, universe, p_push, p_drop = SEEDED[case]
    rng = np.random.default_rng(len(case) * 7919 + m)
    d = _table(rng, m, vd, universe)
    a = _table(rng, k, va, universe)
    _hold_diff(d[:2], a[:2])
    push = (rng.random(m) < p_push)
    drop = (rng.random(k) < p_drop)
    _hold_merge(d, a, push, drop)
    _hold_apply_push(d, a, push)
    # as step uses them: the diff's masks
    diff = reconcile.diff_sorted(*map(_t, d[:2]), *map(_t, a[:2]))
    _hold_merge(d, a, diff.push.numpy(), diff.drop.numpy())


def test_every_pushed_id_already_in_the_catalog():
    rng = np.random.default_rng(3)
    ids = np.sort(rng.choice(1000, 200, replace=False)).astype(np.int32)
    d = _table(rng, 256, 0, 0, ids=ids)
    a = _table(rng, 300, 0, 0, ids=ids)
    push = np.zeros(256, bool)
    push[:200] = True
    got = _hold_merge(d, a, push, np.zeros(300, bool))
    assert int((got.ids != INV).sum()) == 200
    # the catalog copies follow the merged rows as INVALID rows
    np.testing.assert_array_equal(got.ver[:200].numpy(), d[1][:200])
    np.testing.assert_array_equal(got.ver[200:300].numpy(), a[1][:100])
    _hold_apply_push(d, a, push)


@st.composite
def _tables(draw):
    m = draw(st.integers(1, 48))
    k = draw(st.integers(1, 48))
    universe = draw(st.integers(1, 96))
    shared = draw(st.floats(0.0, 1.0))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    vd = draw(st.integers(0, min(m, universe)))
    va = draw(st.integers(0, min(k, universe)))
    d = _table(rng, m, vd, universe)
    # the catalog takes a `shared` part of its ids from the desired table
    pool = d[0][:vd]
    n_shared = min(int(round(shared * min(vd, va))), va)
    own = np.setdiff1d(np.arange(universe), pool)
    take = rng.choice(pool, n_shared, replace=False) if n_shared else []
    rest = rng.choice(own, min(va - n_shared, len(own)), replace=False) \
        if va - n_shared > 0 and len(own) else []
    a_ids = np.sort(np.concatenate([np.asarray(take, np.int64),
                                    np.asarray(rest, np.int64)])).astype(
        np.int32)
    a = _table(rng, k, 0, 0, ids=a_ids)
    mode = draw(st.sampled_from(["random", "all", "none", "diff"]))
    push = {"random": rng.random(m) < 0.5, "all": np.ones(m, bool),
            "none": np.zeros(m, bool), "diff": None}[mode]
    drop = rng.random(k) < draw(st.sampled_from([0.0, 0.3, 1.0]))
    return d, a, push, drop


@settings(max_examples=60, deadline=None)
@given(_tables())
def test_merge_twin_matches_reference_on_generated_tables(tables):
    d, a, push, drop = tables
    diff = _hold_diff(d[:2], a[:2])
    if push is None:                 # step's masks: the diff's own
        push, drop = diff.push.numpy(), diff.drop.numpy()
    _hold_merge(d, a, push, drop)
    _hold_apply_push(d, a, push)


def test_twins_refuse_unsorted_tables():
    good = torch.tensor([1, 4, INV], dtype=torch.int32)
    ver = torch.zeros(3, dtype=torch.int32)
    for bad, what in ((torch.tensor([4, 1, INV], dtype=torch.int32),
                       "ascending"),
                      (torch.tensor([1, 1, INV], dtype=torch.int32),
                       "ascending"),
                      (torch.tensor([1, INV, 4], dtype=torch.int32), "follows")):
        with pytest.raises(ValueError, match=what):
            reconcile.diff_sorted(bad, ver, good, ver)
        with pytest.raises(ValueError, match=what):
            reconcile.apply_push(good, ver, bad, ver,
                                 torch.ones(3, dtype=torch.bool))
