"""Set reconciliation of two id-sorted keyed tables (kernel K6): the
anti-entropy diff of the desired table against the catalog, and the merge
of the pushed rows into the catalog (the port of consul_tpu/ops/
reconcile.py and of consul_tpu/models/antientropy.py's drop compaction
and `_merge_push`).

The reference's per-entry map walk (agent/local/state.go:880-1051
updateSyncState) becomes columnar tables: int32 ids, versions and owning
nodes, invalid rows carrying INVALID_ID (INT32_MAX) so they sort to the
tail and never match.

Preconditions of every function here: in each table the valid ids are
unique and ascending and the INVALID_ID rows form the tail.  The models
keep them; the plain twins check them and raise, the card path does not
pay for the check.

Each public function launches K6 (kernels/csrc/reconcile.cu) on CUDA
tensors and runs its plain twin (`*_plain`, the JAX code transcribed:
searchsorted joins, a lexsort as two stable sorts, stable partitions) on
CPU tensors.  On the card the diff is one launch, in the step's form
masked by the due agents too, and the merge one cooperative launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from consul_tpu_torch import kernels

INVALID_ID = 2 ** 31 - 1
I32 = torch.int32


class DiffResult(NamedTuple):
    push: torch.Tensor   # [M] bool: src rows missing or stale in dst
    drop: torch.Tensor   # [K] bool: dst rows absent from src


class Merged(NamedTuple):
    ids: torch.Tensor
    ver: torch.Tensor
    node: Optional[torch.Tensor]


def check_sorted(ids: torch.Tensor, name: str) -> None:
    """Raise unless ids' valid rows are unique and ascending and its
    INVALID_ID rows form the tail."""
    valid = ids != INVALID_ID
    if bool((~valid[:-1] & valid[1:]).any()):
        raise ValueError(f"{name}: a valid id follows an INVALID_ID row")
    if bool((valid[1:] & (ids[1:] <= ids[:-1])).any()):
        raise ValueError(f"{name}: valid ids are not unique and ascending")


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def lexsort(prio: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """jnp.lexsort((prio, ids)): by ids, ties by prio, then by index."""
    order = _stable_order(prio)
    return order[_stable_order(ids[order])]


def invalid_last(ids: torch.Tensor) -> torch.Tensor:
    """Stable partition order: valid rows, then INVALID_ID rows."""
    return _stable_order((ids == INVALID_ID).to(torch.int8))


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def diff_sorted_plain(src_ids, src_ver, dst_ids, dst_ver, due=None,
                      d_node=None, a_node=None) -> DiffResult:
    """reconcile.py:28-47 in torch ops (left-sided searchsorted, clipped);
    with `due` (the step's form), the masks as antientropy.step takes
    them (antientropy.py:133-134): push & due[d_node], drop & due[a_node]."""
    check_sorted(src_ids, "src_ids")
    check_sorted(dst_ids, "dst_ids")
    k, m = dst_ids.shape[0], src_ids.shape[0]
    pos = torch.searchsorted(dst_ids, src_ids).clamp(0, k - 1)
    hit = (dst_ids[pos] == src_ids) & (src_ids != INVALID_ID)
    stale = hit & (dst_ver[pos] != src_ver)
    push = (src_ids != INVALID_ID) & (~hit | stale)
    rpos = torch.searchsorted(src_ids, dst_ids).clamp(0, m - 1)
    rhit = (src_ids[rpos] == dst_ids) & (dst_ids != INVALID_ID)
    drop = (dst_ids != INVALID_ID) & ~rhit
    if due is not None:
        push = push & due[d_node.to(torch.int64)]
        drop = drop & due[a_node.to(torch.int64)]
    return DiffResult(push=push, drop=drop)


def merge_plain(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push,
                drop=None) -> Merged:
    """antientropy.py:136-138 then :157-171 (reconcile.py:49-71 when drop
    and the node columns are None): the catalog's rows under `drop` made
    INVALID and moved to the tail, then the pushed desired rows merged in
    by a lexsort on (id, source), the catalog copy of each pushed id made
    INVALID, the INVALID rows moved to the tail and the result cut at K."""
    check_sorted(d_ids, "d_ids")
    check_sorted(a_ids, "a_ids")
    k = a_ids.shape[0]
    if drop is not None:
        a_ids = torch.where(drop, INVALID_ID, a_ids)
        order = invalid_last(a_ids)
        a_ids, a_ver = a_ids[order], a_ver[order]
        a_node = a_node[order] if a_node is not None else None
    cand = torch.where(push, d_ids, INVALID_ID)
    ids = torch.cat([cand, a_ids])
    ver = torch.cat([d_ver, a_ver])
    node = torch.cat([d_node, a_node]) if d_node is not None else None
    prio = torch.cat([torch.zeros_like(cand), torch.ones_like(a_ids)])
    order = lexsort(prio, ids)
    ids, ver = ids[order], ver[order]
    node = node[order] if node is not None else None
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    ids = torch.where(first, ids, INVALID_ID)
    last = invalid_last(ids)[:k]
    return Merged(ids=ids[last], ver=ver[last],
                  node=node[last] if node is not None else None)


# ---------------------------------------------------------------------------
# the card path
# ---------------------------------------------------------------------------

def diff_sorted_kernel(src_ids, src_ver, dst_ids, dst_ver, due=None,
                       d_node=None, a_node=None) -> DiffResult:
    push = torch.empty(src_ids.shape, dtype=torch.bool, device=src_ids.device)
    drop = torch.empty(dst_ids.shape, dtype=torch.bool, device=dst_ids.device)
    kernels.launch_reconcile_diff(src_ids, src_ver, dst_ids, dst_ver, push,
                                  drop, due, d_node, a_node)
    return DiffResult(push=push, drop=drop)


def merge_kernel(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push,
                 drop=None) -> Merged:
    out_ids, out_ver = torch.empty_like(a_ids), torch.empty_like(a_ver)
    out_node = torch.empty_like(a_node) if a_node is not None else None
    kernels.launch_reconcile_merge(d_ids, d_ver, d_node, push, a_ids, a_ver,
                                   a_node, drop, out_ids, out_ver, out_node)
    return Merged(ids=out_ids, ver=out_ver, node=out_node)


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------

def diff_sorted(src_ids: torch.Tensor, src_ver: torch.Tensor,
                dst_ids: torch.Tensor, dst_ver: torch.Tensor, due=None,
                d_node=None, a_node=None) -> DiffResult:
    """Reconcile desired (src, [M]) against actual (dst, [K]), both int32
    and id-ascending with INVALID_ID tails: a src row is pushed when its
    id is absent from dst or present at another version (versions stand
    in for content hashes); a dst row is dropped when its id left src.
    The step's form also takes due ([N] bool) and the rows' owning agents
    d_node [M] and a_node [K] (int32 in [0, N)), which come together, and
    keeps only the rows whose owner is due."""
    fn = diff_sorted_kernel if src_ids.is_cuda else diff_sorted_plain
    return fn(src_ids, src_ver, dst_ids, dst_ver, due, d_node, a_node)


def merge(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push,
          drop=None) -> Merged:
    """The catalog (a_*, [K]) with its `drop` rows compacted out, merged
    with the pushed desired rows (d_*, [M]): the pushed copy wins over
    the catalog's, the result keeps K rows, id-sorted with an INVALID_ID
    tail (rows beyond K are cut; callers size K >= the live set).  Both
    tables obey the module's preconditions.  The node columns come
    together or are both None; `drop` may be None."""
    fn = merge_kernel if d_ids.is_cuda else merge_plain
    return fn(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push, drop)


def apply_push(src_ids, src_ver, dst_ids, dst_ver, push: torch.Tensor):
    """Merge the pushed src rows into dst, keeping dst id-sorted with its
    capacity K (reconcile.py:49-71): (dst_ids, dst_ver)."""
    out = merge(src_ids, src_ver, None, dst_ids, dst_ver, None, push)
    return out.ids, out.ver
