"""Anti-entropy: paced full and partial sync of agent state into the
catalog (the port of consul_tpu/models/antientropy.py).

Reference behavior (agent/ae/ae.go + agent/local/state.go): every agent
periodically diffs its desired services against the server catalog
(`SyncFull`, staggered and interval-scaled by cluster size) and pushes
edge-triggered deltas (`SyncChanges`) in between.  The full-sync
interval doubles for every doubling of cluster size past 128 nodes
(`scale_factor`, ae.go:27-40).

Desired and actual are id-sorted columnar tables (service id -> owning
agent, version; ops/reconcile.py's preconditions hold for both).  One
`step` syncs every due agent's rows at once: the diff, masked by the due
agents, is one K6 launch (`reconcile_diff` in its step's form) and the
drop compaction and the merge of the pushed rows another
(`reconcile_merge`, one cooperative launch) on the card; the timer
jitter is one K1 randint.  `register_desired` and `deregister_desired` are host commands
whose ids arrive unsorted, so they stay plain torch on either device.
The tick is a host mirror of the int32 tick.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from consul_tpu_torch.ops import reconcile
from consul_tpu_torch.utils import devices, prng

I32 = torch.int32
INVALID_ID = reconcile.INVALID_ID


def scale_factor(n_nodes: int) -> int:
    """agent/ae/ae.go:27-40: 1 for <= 128 nodes, then
    ceil(log2(n) - log2(128)) + 1."""
    if n_nodes <= 128:
        return 1
    return int(math.ceil(math.log2(n_nodes) - math.log2(128.0))) + 1


@dataclasses.dataclass(frozen=True)
class AEParams:
    n_agents: int
    capacity: int               # S: service-instance table capacity
    sync_interval_ticks: int    # base full-sync interval (reference: 1m)
    stagger_frac: float = 0.1   # randomized stagger (lib/rand.go RandomStagger)
    seed: int = 0

    @property
    def scaled_interval(self) -> int:
        return self.sync_interval_ticks * scale_factor(self.n_agents)


@dataclasses.dataclass(frozen=True)
class AEState:
    tick: int                  # host mirror of the int32 tick
    # desired (agent-local) table, id-sorted
    d_ids: torch.Tensor        # [S] int32 (INVALID_ID = empty)
    d_node: torch.Tensor       # [S] int32 owning agent
    d_ver: torch.Tensor        # [S] int32 content version
    d_dirty: torch.Tensor      # [S] bool: changed since last sync
    # actual (catalog) table, id-sorted
    a_ids: torch.Tensor        # [S] int32
    a_node: torch.Tensor       # [S] int32
    a_ver: torch.Tensor        # [S] int32
    # per-agent timers
    next_full: torch.Tensor    # [N] int32 next full-sync tick
    n_dirty: torch.Tensor      # [N] bool: pending deletes/changes
    syncs_done: torch.Tensor   # 0-d int32 counter (telemetry)

    def replace(self, **kw) -> "AEState":
        return dataclasses.replace(self, **kw)


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(AEState)
                      if f.name != "tick")


def init_state(params: AEParams, device=None) -> AEState:
    """Empty tables and staggered timers on `device` (the card unless the
    caller names one)."""
    device = devices.resolve(device)
    s_cap, n = params.capacity, params.n_agents
    stagger = prng.randint(prng.tick_key(params.seed, 0, 11), (n,), 0,
                           max(1, params.scaled_interval), device)
    empty = torch.full((s_cap,), INVALID_ID, dtype=I32, device=device)
    zeros = torch.zeros((s_cap,), dtype=I32, device=device)
    return AEState(
        tick=0, d_ids=empty, d_node=zeros, d_ver=zeros,
        d_dirty=torch.zeros((s_cap,), dtype=torch.bool, device=device),
        a_ids=empty.clone(), a_node=zeros.clone(), a_ver=zeros.clone(),
        next_full=stagger,
        n_dirty=torch.zeros((n,), dtype=torch.bool, device=device),
        syncs_done=torch.zeros((), dtype=I32, device=device))


def _mark(n: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """jnp.zeros(n, bool).at[where(mask, idx, 0)].max(mask): True at the
    rows `idx` names under `mask`.  An integer max, so duplicate indices
    agree on any device."""
    out = torch.zeros(n, dtype=I32, device=mask.device)
    at = torch.where(mask, idx, 0).to(torch.int64)
    return out.scatter_reduce(0, at, mask.to(I32), "amax").bool()


def register_desired(s: AEState, ids, nodes, vers) -> AEState:
    """Host command: add or update desired service instances ([B] int32
    ids, owning agents and versions, any order); the new rows win over the
    table's and are dirty; the table keeps id order and its capacity."""
    dev = s.d_ids.device
    ids, nodes, vers = (torch.as_tensor(x, dtype=I32, device=dev)
                        for x in (ids, nodes, vers))
    d_ids = torch.cat([s.d_ids, ids])
    d_node = torch.cat([s.d_node, nodes])
    d_ver = torch.cat([s.d_ver, vers])
    d_dirty = torch.cat([s.d_dirty, torch.ones(ids.shape, dtype=torch.bool,
                                               device=dev)])
    prio = torch.cat([torch.ones_like(s.d_ids), torch.zeros_like(ids)])
    order = reconcile.lexsort(prio, d_ids)
    d_ids, d_node, d_ver, d_dirty = (x[order] for x in (d_ids, d_node, d_ver,
                                                        d_dirty))
    first = torch.ones_like(d_ids, dtype=torch.bool)
    first[1:] = d_ids[1:] != d_ids[:-1]
    d_ids = torch.where(first, d_ids, INVALID_ID)
    cap = s.d_ids.shape[0]
    order2 = reconcile.invalid_last(d_ids)[:cap]
    return s.replace(d_ids=d_ids[order2], d_node=d_node[order2],
                     d_ver=d_ver[order2], d_dirty=d_dirty[order2])


def deregister_desired(s: AEState, ids) -> AEState:
    """Host command: remove desired rows by id (absent ids are ignored);
    their owners are flagged so the deletion syncs on the next tick
    (the SyncChanges edge trigger)."""
    dev = s.d_ids.device
    ids = torch.as_tensor(ids, dtype=I32, device=dev)
    cap = s.d_ids.shape[0]
    pos = torch.searchsorted(s.d_ids, ids).clamp(0, cap - 1)
    hit = s.d_ids[pos] == ids
    gone = _mark(cap, pos, hit)
    n_dirty = s.n_dirty | _mark(s.n_dirty.shape[0], s.d_node, gone)
    d_ids = torch.where(gone, INVALID_ID, s.d_ids)
    order = reconcile.invalid_last(d_ids)
    return s.replace(d_ids=d_ids[order], d_node=s.d_node[order],
                     d_ver=s.d_ver[order], d_dirty=s.d_dirty[order],
                     n_dirty=n_dirty)


def sync_masks(params: AEParams, s: AEState, up: torch.Tensor):
    """What `step` syncs: (due_full [N], due [N], push [S], drop [S]) —
    the live agents whose full-sync timer fired, those plus the live
    agents with dirty rows or pending deletes (the edge triggers), and
    the diff's pushed and dropped rows of the due agents (one K6 diff in
    its step's form on the card, the masks inside it)."""
    due_full = (s.next_full <= s.tick) & up
    due = (due_full | s.n_dirty | _mark(params.n_agents, s.d_node, s.d_dirty)) \
        & up
    diff = reconcile.diff_sorted(s.d_ids, s.d_ver, s.a_ids, s.a_ver, due,
                                 s.d_node, s.a_node)
    return due_full, due, diff.push, diff.drop


def step(params: AEParams, s: AEState, up: torch.Tensor) -> AEState:
    """One tick: agents whose full-sync timer fired, or that hold dirty
    rows or pending deletes, sync.  `up` ([N] bool, from the membership
    model): down agents do not sync, their rows go stale until they
    return (reference leader.go:1332 handleFailedMember)."""
    n = params.n_agents
    tick = s.tick
    due_full, due, push, drop = sync_masks(params, s, up)
    merged = reconcile.merge(s.d_ids, s.d_ver, s.d_node, s.a_ids, s.a_ver,
                             s.a_node, push, drop)

    # timers of the agents that full-synced restart with a fresh stagger
    jitter = prng.randint(prng.tick_key(params.seed, tick, 12), (n,), 0,
                          max(1, int(params.scaled_interval
                                     * params.stagger_frac)) + 1,
                          up.device)
    next_full = torch.where(due_full, tick + params.scaled_interval + jitter,
                            s.next_full)
    return s.replace(tick=tick + 1, a_ids=merged.ids, a_node=merged.node,
                     a_ver=merged.ver, next_full=next_full,
                     d_dirty=s.d_dirty & ~due[s.d_node.to(torch.int64)],
                     n_dirty=s.n_dirty & ~due,
                     syncs_done=s.syncs_done + due_full.sum().to(I32))


def in_sync_fraction(s: AEState) -> torch.Tensor:
    """Fraction of live desired rows present and current in the catalog
    (0-d float32 on the device; one K6 diff on the card)."""
    diff = reconcile.diff_sorted(s.d_ids, s.d_ver, s.a_ids, s.a_ver)
    live = s.d_ids != INVALID_ID
    stale = (diff.push & live).sum().to(torch.float32)
    return 1.0 - stale / live.sum().clamp_min(1).to(torch.float32)
