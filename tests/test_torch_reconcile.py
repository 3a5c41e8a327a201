"""K6's plain twins against the JAX package on the CPU, bit for bit.

`diff_sorted` and `apply_push` (P2) against consul_tpu/ops/reconcile.py,
and `merge` in step's form against antientropy.step's drop compaction
followed by `_merge_push`, on tables made from a seed with numpy and on
hypothesis-generated sorted unique tables: M != K, every row pushed and
none, all INVALID, every pushed id already in the catalog, more valid
rows than K (the merge overflows), the INVALID tail's payloads included,
and tables whose equal ids fall at every split a merge-path tile can
make (one id set in both tables, alternating ids, a sparse desired
table over a dense catalog, one row on either side, odd sizes).  The
diff's step form (masked by random due agents at the rows' owners) is
held against the masks JAX's antientropy.step takes.  Numpy
transcriptions of K6's merge-path decomposition (tile splits, the halo
rows, the diff's walk, the merge's per-tile ranks and class bases) are
held to the twins at small tiles.  Every output leaf and every row is
compared, no tolerance (int32 and bool only).  The twins' precondition
checks close the file.
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


@jax.jit
def _jax_step_masks(d_ids, d_ver, d_node, a_ids, a_ver, a_node, due):
    """antientropy.step's masks of the diff (antientropy.py:132-134)."""
    diff = jrec.diff_sorted(d_ids, d_ver, a_ids, a_ver)
    return diff.push & due[d_node], diff.drop & due[a_node]


def _hold_step_diff(d, a, due):
    """The diff's step form against JAX step's masks, due [agents] bool at
    the rows' owners (nodes in [0, agents))."""
    ref = _jax_step_masks(*map(_j, d), *map(_j, a), _j(due))
    got = reconcile.diff_sorted(_t(d[0]), _t(d[1]), _t(a[0]), _t(a[1]),
                                _t(due), _t(d[2]), _t(a[2]))
    np.testing.assert_array_equal(got.push.numpy(), np.asarray(ref[0]),
                                  err_msg="step push")
    np.testing.assert_array_equal(got.drop.numpy(), np.asarray(ref[1]),
                                  err_msg="step drop")
    return got


# (M, K, valid desired, valid catalog, universe, push rate, drop rate,
# layout); layouts other than "random" fix the ids: "same" puts one id set
# in both tables (the merge alternates rows of equal ids), "alternating"
# interleaves distinct ids one to one, "sparse" puts every third id of a
# dense catalog in the desired table
SEEDED = {
    "equal sizes": (512, 512, 300, 280, 1000, 0.5, 0.3, "random"),
    "M > K": (700, 300, 500, 200, 900, 0.6, 0.2, "random"),
    "M < K": (100, 900, 80, 600, 2000, 0.5, 0.5, "random"),
    "every row pushed": (256, 256, 256, 100, 600, 1.0, 0.0, "random"),
    "none pushed": (256, 256, 200, 200, 400, 0.0, 0.4, "random"),
    "all INVALID": (64, 96, 0, 0, 10, 0.5, 0.5, "random"),
    "overflow": (400, 200, 390, 180, 5000, 1.0, 0.0, "random"),
    "full catalog": (300, 300, 250, 300, 700, 0.7, 0.1, "random"),
    "one row": (1, 1, 1, 1, 2, 1.0, 1.0, "random"),
    "interleaved equal ids": (300, 300, 280, 280, 0, 0.5, 0.3, "same"),
    "alternating ids": (301, 299, 290, 290, 0, 0.5, 0.3, "alternating"),
    "sparse desired over a dense catalog": (200, 400, 130, 400, 0, 0.7,
                                            0.2, "sparse"),
    "M = 1": (1, 257, 1, 250, 600, 1.0, 0.3, "random"),
    "K = 1": (257, 1, 250, 1, 600, 0.5, 0.0, "random"),
    "odd M and K": (1003, 997, 900, 950, 4000, 0.5, 0.2, "random"),
}


def _seeded_tables(rng, m, k, vd, va, universe, layout):
    if layout == "random":
        return _table(rng, m, vd, universe), _table(rng, k, va, universe)
    if layout == "same":
        ids = np.sort(rng.choice(10 * vd, vd, replace=False))
        return _table(rng, m, 0, 0, ids=ids), _table(rng, k, 0, 0, ids=ids)
    if layout == "alternating":
        ids = np.sort(rng.choice(10 * (vd + va), vd + va, replace=False))
        return (_table(rng, m, 0, 0, ids=ids[0::2][:vd]),
                _table(rng, k, 0, 0, ids=ids[1::2][:va]))
    ids = np.sort(rng.choice(10 * va, va, replace=False))      # "sparse"
    return _table(rng, m, 0, 0, ids=ids[0::3][:vd]), _table(rng, k, 0, 0,
                                                            ids=ids)


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_diff_merge_and_apply_push_match_reference(case):
    m, k, vd, va, universe, p_push, p_drop, layout = SEEDED[case]
    rng = np.random.default_rng(len(case) * 7919 + m)
    d, a = _seeded_tables(rng, m, k, vd, va, universe, layout)
    _hold_diff(d[:2], a[:2])
    push = (rng.random(m) < p_push)
    drop = (rng.random(k) < p_drop)
    _hold_merge(d, a, push, drop)
    _hold_apply_push(d, a, push)
    # as step uses them: the diff's masks, plain and masked by due agents
    diff = reconcile.diff_sorted(*map(_t, d[:2]), *map(_t, a[:2]))
    _hold_merge(d, a, diff.push.numpy(), diff.drop.numpy())
    due = rng.random(1000) < 0.6
    step = _hold_step_diff(d, a, due)
    _hold_merge(d, a, step.push.numpy(), step.drop.numpy())


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
    layout = draw(st.sampled_from(["random", "same", "alternating"]))
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
    if layout == "same":             # one id set in both tables
        a = _table(rng, k, 0, 0, ids=pool[:k])
    elif layout == "alternating":    # distinct ids, one to one
        ids = np.sort(rng.choice(4 * (m + k), m + k, replace=False))
        d = _table(rng, m, 0, 0, ids=ids[0::2][:vd])
        a = _table(rng, k, 0, 0, ids=ids[1::2][:va])
    mode = draw(st.sampled_from(["random", "all", "none", "diff"]))
    push = {"random": rng.random(m) < 0.5, "all": np.ones(m, bool),
            "none": np.zeros(m, bool), "diff": None}[mode]
    drop = rng.random(k) < draw(st.sampled_from([0.0, 0.3, 1.0]))
    due = rng.random(1000) < draw(st.sampled_from([0.0, 0.5, 1.0]))
    return d, a, push, drop, due


@settings(max_examples=60, deadline=None)
@given(_tables())
def test_merge_twin_matches_reference_on_generated_tables(tables):
    d, a, push, drop, due = tables
    diff = _hold_diff(d[:2], a[:2])
    _hold_step_diff(d, a, due)
    if push is None:                 # step's masks: the diff's own
        push, drop = diff.push.numpy(), diff.drop.numpy()
    _hold_merge(d, a, push, drop)
    _hold_apply_push(d, a, push)


# ---------------------------------------------------------------------------
# K6's merge-path decomposition (kernels/csrc/reconcile.cu) in numpy
# ---------------------------------------------------------------------------

def _split(a, b, d):
    """split(d) of the merge of the sorted a and b, ties a first: the rows
    of a among its first d rows (warp_split)."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - mid - 1]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _tiles(a, b, tile):
    """(i0, i1, j0, j1) of each tile of `tile` merged rows."""
    n = len(a) + len(b)
    for d0 in range(0, n, tile):
        d1 = min(n, d0 + tile)
        i0, i1 = _split(a, b, d0), _split(a, b, d1)
        yield i0, i1, d0 - i0, d1 - i1


def _diff_model(src, src_ver, dst, dst_ver, tile, items):
    """diff_kernel: per tile, each thread's `items` merged rows from its
    own split walked in order; a valid src row matches the dst row after
    it in the merge (the halo row after the run at its end), which is
    then a hit, and the run's first dst row is a hit when the halo src
    row before the run holds its id."""
    k = len(dst)
    part = np.full(len(src), -1)
    hit = np.zeros(k, bool)
    for i0, i1, j0, j1 in _tiles(src, dst, tile):
        after = dst[j1] if j1 < k else INV
        if i0 > 0 and j1 > j0 and dst[j0] != INV and src[i0 - 1] == dst[j0]:
            hit[j0] = True
        sa, sb = src[i0:i1], dst[j0:j1]
        for p0 in range(0, len(sa) + len(sb), items):
            x = _split(sa, sb, p0)
            y = p0 - x
            for _ in range(min(items, len(sa) + len(sb) - p0)):
                if y >= len(sb) or (x < len(sa) and sa[x] <= sb[y]):
                    nxt = sb[y] if y < len(sb) else after
                    if sa[x] != INV and sa[x] == nxt:
                        part[i0 + x] = j0 + y
                        if y < len(sb):
                            hit[j0 + y] = True
                    x += 1
                else:
                    y += 1
    valid_s, valid_d = src != INV, dst != INV
    push = valid_s & ((part < 0) | (src_ver != dst_ver[np.maximum(part, 0)]))
    return push, valid_d & ~hit


def _merge_model(d, a, push, drop, tile):
    """merge_kernel: per tile, a desired row's class (union when pushed
    and valid, else unpushed) and a catalog row's (not kept, a duplicate
    of the pushed desired row of its id, else union), each row's place
    among the tile's rows of its class (a pushed row's union rank adds
    the union catalog rows below its id, a union catalog row's the pushed
    rows below it), the blocks' counts and the classes' bases, cut at K."""
    d_ids, a_ids = d[0], a[0]
    m, k = len(d_ids), len(a_ids)
    pushed = push & (d_ids != INV)
    kept = (a_ids != INV) & ~(drop if drop is not None else np.zeros(k, bool))
    rows = []                 # (tile, class, rank, side, row)
    counts = []
    for t, (i0, i1, j0, j1) in enumerate(_tiles(d_ids, a_ids, tile)):
        sb = a_ids[j0:j1]
        dup = np.zeros(len(sb), bool)
        lbs = []
        for x in range(i0, i1):
            if pushed[x]:
                lb = int(np.searchsorted(sb, d_ids[x], "left"))
                lbs.append(lb)
                if lb < len(sb) and sb[lb] == d_ids[x] and kept[j0 + lb]:
                    dup[lb] = True
        if i0 > 0 and j1 > j0 and pushed[i0 - 1] and d_ids[i0 - 1] == sb[0] \
                and kept[j0]:
            dup[0] = True
        kb = kept[j0:j1]
        union_b = np.concatenate([[0], np.cumsum(kb & ~dup)])
        kept_before = np.concatenate([[0], np.cumsum(kb)])
        dup_before = np.concatenate([[0], np.cumsum(dup)])
        lbs = np.asarray(lbs, np.int64)
        n_pushed = 0
        for x in range(i0, i1):
            if pushed[x]:
                rows.append((t, 0, n_pushed + union_b[lbs[n_pushed]], 0, x))
                n_pushed += 1
            else:
                rows.append((t, 2, x - i0 - n_pushed, 0, x))
        for y in range(j1 - j0):
            if not kb[y]:
                rows.append((t, 3, y - kept_before[y], 1, j0 + y))
            elif dup[y]:
                rows.append((t, 1, dup_before[y], 1, j0 + y))
            else:
                rows.append((t, 0, union_b[y] + int((lbs <= y).sum()), 1,
                             j0 + y))
        counts.append([n_pushed + kb.sum() - dup.sum(), dup.sum(),
                       (i1 - i0) - n_pushed, (j1 - j0) - kb.sum()])
    counts = np.asarray(counts, np.int64).reshape(-1, 4)
    totals = counts.sum(0)
    base = np.concatenate([[0], np.cumsum(totals)[:-1]])
    before = np.cumsum(counts, 0) - counts
    ids = np.full(k, -5, np.int64)
    ver = np.full(k, -5, np.int64)
    node = np.full(k, -5, np.int64)
    for t, c, rank, side, row in rows:
        slot = base[c] + before[t, c] + rank
        if slot >= k:
            continue
        src = a if side else d
        ids[slot] = src[0][row] if c == 0 else INV
        ver[slot], node[slot] = src[1][row], src[2][row]
    return ids, ver, node


@settings(max_examples=60, deadline=None)
@given(_tables(), st.integers(1, 16), st.sampled_from([1, 3, 15]))
def test_merge_path_decomposition_matches_twins(tables, tile, items):
    """The kernels' decomposition at small tiles (every split position of
    a table of up to 48 rows) gives the twins' results bit for bit."""
    d, a, push, drop, due = tables
    diff = reconcile.diff_sorted(*map(_t, d[:2]), *map(_t, a[:2]))
    got_push, got_drop = _diff_model(d[0], d[1], a[0], a[1], tile, items)
    np.testing.assert_array_equal(got_push, diff.push.numpy())
    np.testing.assert_array_equal(got_drop, diff.drop.numpy())
    if push is None:
        push, drop = diff.push.numpy(), diff.drop.numpy()
    for dn, an, dr in ((d[2], a[2], drop), (None, None, None)):
        ref = reconcile.merge(*map(_t, d[:2]), None if dn is None else _t(dn),
                              *map(_t, a[:2]), None if an is None else _t(an),
                              _t(push), None if dr is None else _t(dr))
        got = _merge_model(d, a, push, dr, tile)
        np.testing.assert_array_equal(got[0], ref.ids.numpy())
        np.testing.assert_array_equal(got[1], ref.ver.numpy())
        if dn is not None:
            np.testing.assert_array_equal(got[2], ref.node.numpy())


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
