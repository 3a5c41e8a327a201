"""SWIM failure detection + infection-style dissemination on PyTorch.

The port of consul_tpu/models/swim.py's main path: the rumor-centric state
(O(N) ground truth, a U-slot rumor table, the [N, U] knowledge matrix),
the probe-tick detector pipeline (probe round, slot and dense suspicion
expiry, refutation, coverage-guarded expiry), per-tick dissemination,
the bulk death channel, the convergence monitor, the metrics vectors,
the oracle's membership reads, the commands `kill`, `rejoin` and `leave`,
the nemesis build (`params.chaos`: per-node partition groups `chaos_grp`
and delivery rates `chaos_ok` gate every probe leg, gossip contact and
bulk-channel view, and the bulk overflow is off) and the mass-event
helpers (`kill_mask`, `revive_mask`, `revive`, `inject_suspicion`,
`mass_detection_stats`).  Each function computes what its JAX
counterpart computes, with the same dtypes (wrapping int16 learn ticks,
int8 budgets/kinds), so a converted JAX state advanced here and there
stays bit-equal on its int and bool leaves.

Control flow that JAX expresses inside `lax.scan`:

  * the probe-tick `lax.cond` is decided on the host from the tick,
    which the state mirrors as a host integer — no sync;
  * `_originate`'s `lax.cond(demand > free, evict)` runs the eviction
    masked by the device-side condition (an evicted-nothing release is
    the identity), so no sync;
  * `jnp.any(bulk_member)` is read back once per probe tick into the
    `bulk_live` host flag (the bulk channel only gains members on probe
    ticks); gossip-only ticks never sync.

`believed_down_fraction` launches kernel K3 on CUDA tensors, the
membership reads (`status_vector`, `membership_counts`/`page`/`delta`)
kernel K4, `mass_detection_stats` kernel K5, the probe round kernel K7,
every rumor origination (probe round, dense expiry, rejoin, leave,
inject_suspicion) kernel K8, the subject maps and their updates (`_maps`,
`_map_add`, `_maps_convert`) kernel K9, `_suspicion_expiry` kernel K10,
`_dense_suspicion_expiry` kernel K11 around its K8 call,
`_refutation` and `_expire` kernel K12, and the bulk channel's tick
(`_bulk_step`) kernel K14, each beside its plain twin
(`_probe_pass_plain`, `_originate_plain`, `_maps_plain`, ...,
`_expire_plain`, `_bulk_step_plain`); the gossip pass (with its
learn-tick stamp, counter update and loss draw, and under chaos its
partition gate and per-contact rate) goes through ops/gossip.py (K2) and
every other random draw through utils/prng.py (K1).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.ops import gossip as gossip_ops
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.parallel import mesh as meshlib
from consul_tpu_torch.parallel.mesh import Blocks, Replicated
from consul_tpu_torch.utils import devices, prng

ALIVE = 0
SUSPECT = 1
DEAD = 2
LEFT = 3

CTR_PROBES_SENT = 0
CTR_PROBE_ACKS = 1
CTR_PROBE_FAILS = 2
CTR_SUSPICIONS = 3
CTR_GOSSIP_DELIVERED = 4
CTR_GOSSIP_SERVED = 5
CTR_GOSSIP_LOST = 6   # the gossip counters close the vector: K2 adds them
CTR_N = 7

I8, I16, I32, I64 = torch.int8, torch.int16, torch.int32, torch.int64
F32 = torch.float32

# host syncs taken by the tick (the probe-tick bulk-channel flag); the
# bench reports them per tick
host_syncs = 0
# ticks that ran the bulk channel's step (_bulk_step)
bulk_steps = 0


@dataclasses.dataclass(frozen=True)
class SwimParams:
    """Static parameters of the detector (consul_tpu SwimParams)."""

    n_nodes: int
    rumor_slots: int
    gossip_nodes: int
    indirect_checks: int
    probe_period_ticks: int
    probe_timeout_ms: float
    retransmit_limit: int
    suspicion_min_ticks: int
    suspicion_max_ticks: int
    declare_lag_ticks: int
    confirm_k: int
    alloc_cap: int
    expiry_gossip_ticks: int
    expiry_suspect_ticks: int
    p_loss: float
    rtt_base_ms: float
    packet_msgs: int
    awareness_max: int
    degraded_frac: float
    degraded_loss: float
    seed: int
    chaos: bool = False
    shard_blocks: int = 1


def make_params(gossip: GossipConfig, sim: SimConfig) -> SwimParams:
    n = sim.n_nodes
    if sim.shard_blocks > 1 and n % sim.shard_blocks:
        raise ValueError(f"shard_blocks={sim.shard_blocks} must divide "
                         f"n_nodes={n}")
    limit = min(gossip.retransmit_limit(n), 127)
    spread = max(8, 4 * math.ceil(math.log2(n + 1)))
    return SwimParams(
        n_nodes=n,
        rumor_slots=sim.rumor_slots,
        gossip_nodes=gossip.gossip_nodes,
        indirect_checks=gossip.indirect_checks,
        probe_period_ticks=gossip.probe_period_ticks,
        probe_timeout_ms=gossip.probe_timeout * 1000.0,
        retransmit_limit=limit,
        suspicion_min_ticks=gossip.suspicion_min_ticks(n),
        suspicion_max_ticks=gossip.suspicion_max_ticks(n),
        # memberlist declares suspect only after the full probe cycle
        declare_lag_ticks=math.ceil(2 * gossip.probe_timeout
                                    / gossip.gossip_interval),
        confirm_k=gossip.confirm_k(),
        alloc_cap=min(sim.alloc_cap, sim.n_nodes, sim.rumor_slots),
        expiry_gossip_ticks=spread,
        expiry_suspect_ticks=gossip.suspicion_max_ticks(n) + spread,
        p_loss=sim.p_loss,
        rtt_base_ms=sim.rtt_base_ms,
        packet_msgs=gossip.packet_msgs(),
        awareness_max=gossip.awareness_max_multiplier,
        degraded_frac=sim.degraded_frac,
        degraded_loss=sim.degraded_loss,
        seed=sim.seed,
        chaos=sim.chaos,
        shard_blocks=sim.shard_blocks,
    )


@dataclasses.dataclass(frozen=True)
class SwimState:
    """Simulator state: tensors on one device, plus host mirrors of the
    tick and of whether the bulk channel holds members."""

    tick: int                      # host mirror of the int32 tick
    up: torch.Tensor               # [N] bool
    member: torch.Tensor           # [N] bool (a buffer distinct from up)
    incarnation: torch.Tensor      # [N] int32
    coords: torch.Tensor           # [N, 2] float32 latent coords (ms)
    committed_dead: torch.Tensor   # [N] bool
    committed_left: torch.Tensor   # [N] bool
    committed_inc: torch.Tensor    # [N] int32
    r_active: torch.Tensor         # [U] bool
    r_kind: torch.Tensor           # [U] int8
    r_subject: torch.Tensor        # [U] int32
    r_inc: torch.Tensor            # [U] int32
    r_start: torch.Tensor          # [U] int32
    r_confirm: torch.Tensor        # [U] int8
    r_coverage: torch.Tensor       # [U] float32
    know: torch.Tensor             # [N, U] bool
    learn_tick: torch.Tensor       # [N, U] int16 (wrapping; see _age)
    sends_left: torch.Tensor       # [N, U] int8
    sus_start: torch.Tensor        # [N] int32, -1 = none
    sus_confirm: torch.Tensor      # [N] int8
    bulk_member: torch.Tensor      # [N] bool
    bulk_heard: torch.Tensor       # [N] float32
    bulk_cov: torch.Tensor         # [N] float32
    awareness: torch.Tensor        # [N] int8
    sus_count: torch.Tensor        # [N] int32
    chaos_grp: torch.Tensor        # [N] int16 partition group (chaos only)
    chaos_ok: torch.Tensor         # [N] float32 delivery rate (chaos only)
    ctr: torch.Tensor              # [CTR_N] float32
    bulk_live: bool = False        # host mirror of any(bulk_member)

    def replace(self, **kw) -> "SwimState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "SwimState":
        """A copy whose every tensor is its own: what a caller keeps of a
        state it passes on to a step or a command on the card, which
        consume it (see step_with_obs)."""
        return self.replace(**{f: getattr(self, f).clone()
                               for f in TENSOR_FIELDS})

    @property
    def device(self) -> torch.device:
        """The state's device; for a node-sharded state the mesh's first
        device, where its counters, pages and monitor vectors land."""
        return self.up.device

    @property
    def mesh(self) -> Optional[meshlib.Mesh]:
        """The mesh of a node-sharded state (parallel/mesh.py), else None."""
        return meshlib.mesh_of(self.up) if isinstance(self.up, Blocks) \
            else None


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(SwimState)
                      if f.name not in ("tick", "bulk_live"))

# the leaves K7, K8, K10, K11, K12 and K14 update in place on the card (K7
# writes awareness only with Lifeguard's awareness_max > 0; the dense
# expiry's K8 call writes ORIGINATE_INPLACE besides K11's own leaves)
PROBE_INPLACE = ("know", "learn_tick", "sends_left", "awareness", "sus_start",
                 "sus_confirm", "sus_count", "r_confirm", "ctr")
ORIGINATE_INPLACE = ("know", "learn_tick", "sends_left", "committed_dead",
                     "committed_left", "committed_inc", "r_active", "r_kind",
                     "r_subject", "r_inc", "r_start", "r_confirm",
                     "r_coverage")
EXPIRY_INPLACE = ("know", "learn_tick", "sends_left", "r_kind", "r_start")
DENSE_INPLACE = ("learn_tick", "sends_left", "r_kind", "r_start",
                 "bulk_member", "bulk_heard", "bulk_cov", "sus_start",
                 "sus_confirm")
# K12's refutation (awareness only with awareness_max > 0) and expire
REFUTE_INPLACE = ("incarnation", "awareness", "know", "learn_tick",
                  "sends_left", "r_kind", "r_inc", "r_start")
FREE_INPLACE = ("know", "sends_left", "committed_dead", "committed_left",
                "committed_inc", "r_active", "r_coverage")
# K14's bulk step, on every tick while the bulk channel is live
BULK_INPLACE = ("bulk_member", "bulk_heard", "bulk_cov", "committed_dead")


def _pieces(t) -> tuple:
    """A leaf's tensors: its blocks, its copies, or itself."""
    if isinstance(t, Blocks):
        return t.parts
    if isinstance(t, Replicated):
        return t.copies
    return (t,)


def _writable(s: SwimState, fields, what: str) -> None:
    """Raise unless each leaf a kernel writes in place is contiguous and
    shares no storage with another leaf it writes (on a node-sharded
    state: every block and every copy, each of its own)."""
    seen = {}
    for f in fields:
        for t in _pieces(getattr(s, f)):
            if not t.is_contiguous():
                raise ValueError(f"{what} writes {f} in place: it must be "
                                 f"contiguous")
            at = (t.device, t.untyped_storage().data_ptr())
            if at in seen:
                raise ValueError(f"{what} writes {f} and {seen[at]} in "
                                 f"place: they share storage")
            seen[at] = f


def _writable_maps(maps: dict, what: str) -> None:
    """Raise unless each [N] map a K9 update writes in place is contiguous
    and overlaps no other map it writes (the rows of _maps' [4, N] block
    share one storage, not bytes)."""
    spans = []
    for name, t in maps.items():
        if not t.is_contiguous():
            raise ValueError(f"{what} writes {name} in place: it must be "
                             f"contiguous")
        lo = t.data_ptr()
        hi = lo + t.numel() * t.element_size()
        for other, a, b in spans:
            if lo < b and a < hi:
                raise ValueError(f"{what} writes {name} and {other} in "
                                 f"place: they share storage")
        spans.append((name, lo, hi))


def init_state(params: SwimParams, key=None, n_initial: int = 0,
               device=None) -> SwimState:
    """Fresh pool on `device` (the card unless the caller names one)."""
    device = devices.resolve(device)
    n, u = params.n_nodes, params.rumor_slots
    if n_initial < 0 or n_initial > n:
        raise ValueError(f"n_initial={n_initial} outside [0, {n}]")
    if key is None:
        key = prng.PRNGKey(params.seed ^ 0x5EEDF00D)
    coords = prng.uniform(key, (n, 2), device) * 30.0
    ar = torch.arange(n, device=device)
    present = torch.ones(n, dtype=torch.bool, device=device) if not n_initial \
        else ar < n_initial

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SwimState(
        tick=0, up=present, member=present.clone(),
        incarnation=z(n, I32), coords=coords,
        committed_dead=z(n, torch.bool), committed_left=z(n, torch.bool),
        committed_inc=z(n, I32),
        r_active=z(u, torch.bool), r_kind=z(u, I8), r_subject=z(u, I32),
        r_inc=z(u, I32), r_start=z(u, I32), r_confirm=z(u, I8),
        r_coverage=z(u, F32),
        know=z((n, u), torch.bool), learn_tick=z((n, u), I16),
        sends_left=z((n, u), I8),
        sus_start=torch.full((n,), -1, dtype=I32, device=device),
        sus_confirm=z(n, I8), bulk_member=z(n, torch.bool),
        bulk_heard=z(n, F32), bulk_cov=z(n, F32), awareness=z(n, I8),
        sus_count=z(n, I32), chaos_grp=z(n, I16),
        chaos_ok=torch.ones(n, dtype=F32, device=device),
        ctr=z(CTR_N, F32), bulk_live=False)


# ---------------------------------------------------------------------------
# small helpers: scatters with .at[]-semantics, int16 tick, timeout table
# ---------------------------------------------------------------------------

def _t16(tick: int) -> int:
    """The host tick as the wrapping int16 the JAX state stamps."""
    return ((int(tick) + 2 ** 15) % 2 ** 16) - 2 ** 15


def _scatter(base: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             reduce: str) -> torch.Tensor:
    """base.at[idx].max/min(val) — out of place, include_self.  As JAX
    scatters, an index in [-N, 0) wraps once and any other index outside
    [0, N) is dropped: it lands in a spare row cut off after."""
    n = base.shape[0]
    idx = idx.to(I64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    wide = torch.cat([base, base[:1]])
    if base.dtype == torch.bool:
        out = wide.to(I32).scatter_reduce(0, idx, val.to(I32), reduce,
                                          include_self=True)
        return out[:n].bool()
    return wide.scatter_reduce(0, idx, val.to(base.dtype), reduce,
                               include_self=True)[:n]


def _set_drop(table: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """table.at[idx].set(val, mode="drop") for idx in [0, U] (U drops)."""
    u = table.shape[0]
    ext = torch.cat([table, table[:1]])
    ext[idx.to(I64)] = val.to(table.dtype)
    return ext[:u]


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k: the k largest, earlier index first among equals.  The JAX
    package's `_top_k_sharded` returns exactly this for any shard count
    (swim.py:569-602), so one device needs no block argument."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k].to(I32)


def _top_k_sharded(x, k: int):
    """lax.top_k over a node-sharded vector without a gather
    (swim.py:569-602): each block's top k (its first max first among
    equals), then the top k of the [B*k] candidates, emitted block-major so
    that among equal values the earlier global index wins, as the flat
    top-k picks it.  When k > L every block gives all its L values, the
    flat form.  A tensor takes _top_k."""
    if not isinstance(x, Blocks):
        return _top_k(x, k)
    ell, home = x.rows, x.device
    kk = min(k, ell)
    vals, idx = [], []
    for b, part in enumerate(x.parts):
        v, i = _top_k(part, kk)
        vals.append(v.to(home))
        idx.append(i.to(home, I64) + b * ell)
    v2, j = _top_k(torch.cat(vals), k)
    return v2, torch.cat(idx)[j.to(I64)].to(I32)


@functools.lru_cache(maxsize=64)
def timeout_table(params: SwimParams) -> Tuple[int, ...]:
    """Lifeguard suspicion timeout for confirmations c = 0..64: the timer
    decays from max to min as log(c+1)/log(k+1), floored at min, plus the
    probe-cycle declare lag (swim.py:477-489).  Computed once on the host
    in float32 so every device indexes the same integers: a device `log`
    one ulp off could push `t` over an integer and add a whole tick."""
    mn = np.float32(params.suspicion_min_ticks)
    mx = np.float32(params.suspicion_max_ticks)
    c = np.arange(65, dtype=np.float32)
    frac = np.log(c + np.float32(1.0)) / np.float32(math.log(params.confirm_k + 1.0))
    t = mx - (mx - mn) * np.clip(frac, np.float32(0.0), np.float32(1.0))
    out = np.ceil(np.maximum(t, mn)).astype(np.int32) + params.declare_lag_ticks
    return tuple(int(v) for v in out)


_table_cache: dict = {}


def _table(params: SwimParams, device, dtype) -> torch.Tensor:
    """timeout_table on `device`, built once per (params, device, dtype):
    no per-tick upload."""
    key = (params, torch.device(device), dtype)
    table = _table_cache.get(key)
    if table is None:
        table = torch.tensor(timeout_table(params), dtype=dtype, device=device)
        _table_cache[key] = table
    return table


def _timeouts(params: SwimParams, confirm: torch.Tensor) -> torch.Tensor:
    """[...] int32 timeout for int confirmation counts (0..64)."""
    return _table(params, confirm.device, I32)[confirm.to(I64)]


# ---------------------------------------------------------------------------
# derived per-subject maps + small-table lookups
# ---------------------------------------------------------------------------

def _subject_map(params: SwimParams, s: SwimState, kind: int,
                 values: torch.Tensor) -> torch.Tensor:
    mask = s.r_active & (s.r_kind == kind)
    subj = torch.where(mask, s.r_subject, 0)
    val = torch.where(mask, values.to(I32), -1)
    base = torch.full((params.n_nodes,), -1, dtype=I32, device=s.device)
    return _scatter(base, subj, val, "amax")


def _maps_plain(params: SwimParams, s: SwimState):
    """The plain PyTorch version of K9's build (swim.py:392-412)."""
    u = params.rumor_slots
    slots = torch.arange(u, dtype=I32, device=s.device)
    suspect_of = _subject_map(params, s, SUSPECT, slots)
    dead_of = _subject_map(params, s, DEAD, slots)
    left_of = _subject_map(params, s, LEFT, slots)
    alive_val = _subject_map(params, s, ALIVE, s.r_inc * u + slots)
    return suspect_of, dead_of, left_of, alive_val


def _maps(params: SwimParams, s: SwimState):
    """The four [N] int32 subject maps (suspect_of, dead_of, left_of,
    alive_val), built once a probe tick; on CUDA tensors one K9 launch
    writes them as the rows of one [4, N] block."""
    if not s.know.is_cuda:
        return _maps_plain(params, s)
    maps = torch.empty((4, params.n_nodes), dtype=I32, device=s.device)
    kernels.launch_subject_maps(s.r_active, s.r_kind, s.r_subject, s.r_inc,
                                *maps)
    return tuple(maps)


def _map_add_plain(map_n, subjects, slots, ok):
    """The plain PyTorch version of K9's map_add (swim.py:414-420)."""
    return _scatter(map_n, torch.where(ok, subjects, 0),
                    torch.where(ok, slots, -1), "amax")


def _map_add(map_n, subjects, slots, ok):
    """map_n with an origination's (subject, slot) pairs under `ok` added
    (not rebuilt from the table: after an eviction the maps stay stale by
    design).  On CUDA tensors one K9 launch consumes map_n: it updates it
    in place and returns map_n itself."""
    if not map_n.is_cuda:
        return _map_add_plain(map_n, subjects, slots, ok)
    _writable_maps({"map": map_n}, "K9 map_add")
    kernels.launch_map_add(map_n, subjects, slots, ok)
    return map_n


def _maps_convert_plain(maps, s: SwimState, convert: torch.Tensor):
    """The plain PyTorch version of K9's maps_convert (swim.py:422-435)."""
    suspect_of, dead_of, left_of, alive_val = maps
    u = s.r_active.shape[0]
    subj = torch.where(convert, s.r_subject, 0)
    suspect_of = _scatter(suspect_of, subj,
                          torch.where(convert, -1, 1 << 30), "amin")
    dead_of = _scatter(dead_of, subj, torch.where(
        convert, torch.arange(u, dtype=I32, device=s.device), -1), "amax")
    return suspect_of, dead_of, left_of, alive_val


def _maps_convert(maps, s: SwimState, convert: torch.Tensor):
    """The maps with the converting [U] slots' subjects moved from
    suspect_of to dead_of (left_of and alive_val pass through).  On CUDA
    tensors one K9 launch consumes the maps: it updates suspect_of and
    dead_of in place and returns the maps it was given."""
    if not s.know.is_cuda:
        return _maps_convert_plain(maps, s, convert)
    suspect_of, dead_of, left_of, alive_val = maps
    _writable_maps({"suspect_of": suspect_of, "dead_of": dead_of},
                   "K9 maps_convert")
    kernels.launch_maps_convert(suspect_of, dead_of, convert, s.r_subject)
    return suspect_of, dead_of, left_of, alive_val


def _onehot(cols: torch.Tensor, u: int) -> torch.Tensor:
    return cols[:, None] == torch.arange(u, dtype=I32, device=cols.device)[None, :]


def _row_gather(mat: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """mat[i, cols[i]], cols may be -1 (False/0 there); integer rows come
    back as int32, as jnp.sum promotes them."""
    onehot = _onehot(cols, mat.shape[1])
    if mat.dtype == torch.bool:
        return (mat & onehot).any(1)
    return torch.where(onehot, mat, 0).sum(1, dtype=I32)


def _table_lookup(vec_u: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    onehot = _onehot(cols, vec_u.shape[0])
    return torch.where(onehot, vec_u[None, :], 0).sum(1, dtype=I32)


# ---------------------------------------------------------------------------
# belief queries
# ---------------------------------------------------------------------------

def _believes_down_shift(params: SwimParams, s: SwimState, maps,
                         shift: torch.Tensor, tick: int) -> torch.Tensor:
    """[N] bool: does node i believe its ring peer (i + shift) % N is down?"""
    suspect_of, dead_of, left_of, alive_val = maps
    u = params.rumor_slots
    down = rolls.pull(s.committed_dead | s.committed_left, shift)
    down = down | _row_gather(s.know, rolls.pull(dead_of, shift))
    down = down | _row_gather(s.know, rolls.pull(left_of, shift))
    ss = rolls.pull(suspect_of, shift)
    know_s = _row_gather(s.know, ss)
    learn = _row_gather(s.learn_tick, ss)                 # int32, as in JAX
    conf = _table_lookup(s.r_confirm, ss)
    age = _t16(tick) - learn
    expired = know_s & (age >= _timeouts(params, conf).to(I16))
    av = rolls.pull(alive_val, shift)
    a_slot = torch.where(av >= 0, av % u, -1)
    a_inc = torch.where(av >= 0, torch.div(av, u, rounding_mode="floor"), -1)
    s_inc = _table_lookup(s.r_inc, ss)
    refuted = (av >= 0) & (a_inc > s_inc) & _row_gather(s.know, a_slot)
    refuted = refuted | (s_inc < rolls.pull(s.committed_inc, shift))
    down = down | (expired & ~refuted)
    return down | rolls.pull(s.bulk_member, shift)


def _monitor_slots(params: SwimParams, s, subject: int, device=None):
    """The per-slot [U] vectors of the monitor for one subject (from the
    table's copy on `device` on a node-sharded state)."""
    t = {f: getattr(s, f) for f in ("r_active", "r_subject", "r_kind",
                                    "r_confirm")}
    if device is not None:
        t = {f: v.on(device) for f, v in t.items()}
    subj = t["r_active"] & (t["r_subject"] == subject)
    is_dl = subj & ((t["r_kind"] == DEAD) | (t["r_kind"] == LEFT))
    is_s = subj & (t["r_kind"] == SUSPECT)
    is_a = subj & (t["r_kind"] == ALIVE)
    timeout16 = _timeouts(params, t["r_confirm"]).to(I16)
    return is_dl, is_s, is_a, timeout16


def _believers(slots, r_inc, know, learn_tick, tick: int, down, cinc):
    """[rows] bool: the rows that believe the subject down: a known
    dead/left rumor of it, its committed death or leave (`down`), or a
    known suspect rumor past its timeout that no known alive rumor of a
    higher incarnation, nor the committed incarnation `cinc`, refutes."""
    is_dl, is_s, is_a, timeout16 = slots
    down_i = (know & is_dl[None, :]).any(1) | down
    age_ok = (_t16(tick) - learn_tick) >= timeout16[None, :]
    a_inc_known = torch.where(is_a[None, :] & know, r_inc[None, :],
                              -1).amax(1)
    refuted = (a_inc_known[:, None] > r_inc[None, :]) \
        | (r_inc[None, :] < cinc)
    return down_i | (know & is_s[None, :] & age_ok & ~refuted).any(1)


def believed_down_fraction_plain(params: SwimParams, s: SwimState,
                                 subject: int) -> torch.Tensor:
    """The plain PyTorch version of K3 (swim.py:533-562), a 0-d float32."""
    n = s.up.shape[0]
    down_i = _believers(_monitor_slots(params, s, subject), s.r_inc, s.know,
                        s.learn_tick, s.tick,
                        s.committed_dead[subject] | s.committed_left[subject],
                        s.committed_inc[subject])
    observer = s.up & s.member & (torch.arange(n, device=s.device) != subject)
    frac = (down_i & observer).sum().to(F32) \
        / observer.sum().clamp_min(1).to(F32)
    bulk = torch.where(s.bulk_member[subject], s.bulk_cov[subject],
                       torch.zeros((), dtype=F32, device=s.device))
    return torch.maximum(frac, bulk)


def _cell(x: Blocks, i: int) -> torch.Tensor:
    """Node i's 0-d cell of a node-sharded leaf (in the block holding it)."""
    b, r = divmod(i, x.rows)
    return x.parts[b][r]


def believed_down_fraction_blocks_plain(params: SwimParams, s: SwimState,
                                        subject: int) -> torch.Tensor:
    """believed_down_fraction_plain over a node-sharded state, block by
    block: each block's believers and observers as integers, added in
    block order and divided once (the unsharded quotient's bits)."""
    home = s.device
    ell = s.up.rows
    cdead = _cell(s.committed_dead, subject) | _cell(s.committed_left,
                                                     subject)
    cinc = _cell(s.committed_inc, subject)
    believers = torch.zeros((), dtype=I64, device=home)
    observers = torch.zeros((), dtype=I64, device=home)
    for b, know in enumerate(s.know.parts):
        dev = know.device
        down_i = _believers(_monitor_slots(params, s, subject, dev),
                            s.r_inc.on(dev), know, s.learn_tick.parts[b],
                            s.tick, cdead.to(dev), cinc.to(dev))
        rows = torch.arange(b * ell, (b + 1) * ell, device=dev)
        observer = s.up.parts[b] & s.member.parts[b] & (rows != subject)
        believers = believers + (down_i & observer).sum().to(home)
        observers = observers + observer.sum().to(home)
    frac = believers.to(F32) / observers.clamp_min(1).to(F32)
    bulk = torch.where(_cell(s.bulk_member, subject),
                       _cell(s.bulk_cov, subject),
                       torch.zeros((), dtype=F32, device=home))
    return torch.maximum(frac, bulk.to(home))


def believed_down_fraction(params: SwimParams, s: SwimState, subject: int,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of live members (excluding the subject) that believe
    `subject` is down — the north-star convergence metric.  On CUDA
    tensors it launches K3, which reads the raw rumor table and the cached
    int16 timeout table itself, writing into `out` (one float32, e.g. a
    slot of a per-scan vector) when given.  On a node-sharded state K3
    runs one launch a block and one combine (the twin block by block),
    `out` on the mesh's first device."""
    sharded = isinstance(s.know, Blocks)
    if not s.know.is_cuda:
        frac = (believed_down_fraction_blocks_plain if sharded
                else believed_down_fraction_plain)(params, s, subject)
        if out is not None:
            out.copy_(frac.reshape(out.shape))
            return out
        return frac
    if out is None:
        out = torch.empty(1, dtype=F32, device=s.device)
    if sharded:
        kernels.launch_believed_down_blocks(
            s.know, s.learn_tick, s.up, s.member, s.r_active, s.r_kind,
            s.r_subject, s.r_inc, s.r_confirm,
            Replicated(_table(params, c.device, I16)
                       for c in s.r_active.copies),
            s.committed_dead, s.committed_left, s.committed_inc,
            s.bulk_member, s.bulk_cov, subject, _t16(s.tick), out)
        return out
    kernels.launch_believed_down(
        s.know, s.learn_tick, s.up, s.member, s.r_active, s.r_kind,
        s.r_subject, s.r_inc, s.r_confirm, _table(params, s.device, I16),
        s.committed_dead, s.committed_left, s.committed_inc, s.bulk_member,
        s.bulk_cov, subject, _t16(s.tick), out)
    return out


# ---------------------------------------------------------------------------
# rumor allocation / origination
# ---------------------------------------------------------------------------

def _originate_plain(params: SwimParams, s: SwimState,
                     want_score: torch.Tensor, kind: int,
                     inc_of_subject: torch.Tensor, row_subject: torch.Tensor):
    """The plain PyTorch version of K8 (swim.py:605-672): allocate up to
    `alloc_cap` rumor slots for subjects with want > 0.  The pressure
    eviction that JAX gates with lax.cond(demand > free) runs masked by
    that device-side condition."""
    a = params.alloc_cap
    u = params.rumor_slots
    dev = s.device
    demand = (want_score > 0).sum()
    free = (~s.r_active).sum()
    live = s.up & s.member
    n_live = live.sum().clamp_min(1)
    coverage = (s.know & live[:, None]).sum(0).to(F32) / n_live.to(F32)
    evicting = demand > free
    done = s.r_active & (coverage >= 0.995) & (s.r_kind != SUSPECT) & evicting
    released = _release(s, done, coverage)
    s = released.replace(r_coverage=torch.where(
        evicting, released.r_coverage, s.r_coverage))

    score, subjects = _top_k(want_score, a)
    free_rank = torch.where(s.r_active, 0, 1).to(I32) \
        * (u - torch.arange(u, dtype=I32, device=dev))
    free_score, slots = _top_k(free_rank, a)
    ok = (score > 0) & (free_score > 0)
    oob = torch.where(ok, slots, u)

    def full(v, dtype):
        return torch.full((a,), v, dtype=dtype, device=dev)

    r_active = _set_drop(s.r_active, oob, full(True, torch.bool))
    r_kind = _set_drop(s.r_kind, oob, full(kind, I8))
    r_subject = _set_drop(s.r_subject, oob, subjects)
    r_inc = _set_drop(s.r_inc, oob, inc_of_subject[subjects.to(I64)])
    r_start = _set_drop(s.r_start, oob, full(s.tick, I32))
    r_confirm = _set_drop(s.r_confirm, oob, full(1, I8))

    match_subj = torch.where(ok, subjects, -2)
    match = row_subject[:, None] == match_subj[None, :]        # [N, A]
    slot_row = torch.where(match, slots[None, :], -1).amax(1)  # [N]
    cell = _onehot(slot_row, u) & (slot_row >= 0)[:, None]
    know = s.know | cell
    learn_tick = torch.where(cell, _t16(s.tick), s.learn_tick)
    sends_left = torch.where(cell, params.retransmit_limit, s.sends_left)
    s = s.replace(r_active=r_active, r_kind=r_kind, r_subject=r_subject,
                  r_inc=r_inc, r_start=r_start, r_confirm=r_confirm,
                  know=know, learn_tick=learn_tick, sends_left=sends_left)
    return s, (subjects, slots, ok)


def _originate(params: SwimParams, s: SwimState, want_score: torch.Tensor,
               kind: int, inc_of_subject: torch.Tensor,
               row_subject: torch.Tensor):
    """Allocate up to `alloc_cap` rumor slots of `kind` for the subjects
    with want_score [N] int32 > 0, seeding the rows whose row_subject [N]
    int32 names one.  Returns (state, (subjects, slots, ok)): the
    allocated pairs and their validity, which the callers fold into their
    subject maps (_map_add; K11's post launch reads them per node).  On
    CUDA tensors it launches K8, which updates s's rows, committed leaves
    and rumor table in place: the state returned holds s's tensors, and
    (subjects, slots, ok) are fresh."""
    if not s.know.is_cuda:
        return _originate_plain(params, s, want_score, kind, inc_of_subject,
                                row_subject)
    _writable(s, ORIGINATE_INPLACE, "K8")
    a, dev = params.alloc_cap, s.device
    out = dict(subjects_out=torch.empty(a, dtype=I32, device=dev),
               slots_out=torch.empty(a, dtype=I32, device=dev),
               ok_out=torch.empty(a, dtype=torch.bool, device=dev))
    kernels.launch_originate(
        want=want_score, row_subject=row_subject,
        inc_of_subject=inc_of_subject, up=s.up, member=s.member,
        know=s.know, learn_tick=s.learn_tick, sends_left=s.sends_left,
        committed_dead=s.committed_dead, committed_left=s.committed_left,
        committed_inc=s.committed_inc, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        r_confirm=s.r_confirm, r_coverage=s.r_coverage, alloc=a, kind=kind,
        tick=s.tick, tick16=_t16(s.tick), limit=params.retransmit_limit,
        **out)
    return s, (out["subjects_out"], out["slots_out"], out["ok_out"])


# ---------------------------------------------------------------------------
# step phases
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProbeObs:
    """Per-node probe measurements of one probe round: node i probed its
    ring peer (i + shift) % N; direct acks carry an RTT sample."""

    shift: torch.Tensor    # int32 scalar ring offset
    rtt_ms: torch.Tensor   # [N] float32
    acked: torch.Tensor    # [N] bool


def _probe_draws(params: SwimParams, tick: int) -> dict:
    """The random draws of the probe round at `tick`, by name, which
    _probe_inputs makes in one K1 launch."""
    n, k = params.n_nodes, params.indirect_checks
    kt = prng.tick_key(params.seed, tick, 1)
    k_off, k_direct, k_leg, k_rtt, k_lha = prng.split(kt, 5)
    want = {"offs": rolls.offsets_draw(k_off, n, 1 + k),
            "rtt": prng.Draw("exponential", k_rtt, (n,)),
            "direct": prng.Draw("uniform", k_direct, (n,))}
    if params.awareness_max > 0:
        want["lha"] = prng.Draw("uniform", k_lha, (n,))
    if k > 0:
        for name, key in zip(("uA", "uB", "uC"), prng.split(k_leg, 3)):
            want[name] = prng.Draw("uniform", key, (n, k))
    return want


def _probe_inputs(params: SwimParams, s: SwimState) -> dict:
    """The probe round's draws at the state's tick, by name: one K1 batch
    on the card."""
    want = _probe_draws(params, s.tick)
    return dict(zip(want, prng.draw(list(want.values()), s.device)))


def _probe_pass_plain(params: SwimParams, s: SwimState, maps, drawn: dict):
    """The plain PyTorch version of K7: one SWIM probe round up to its
    rumor origination (swim.py:698-884), on the round's draws.  Returns
    (state, want [N] int32, row_subject [N] int32, ProbeObs)."""
    n = params.n_nodes
    dev = s.device
    tick = s.tick
    k = params.indirect_checks
    offs = drawn["offs"]
    d = offs[0]

    live = s.up & s.member
    if params.awareness_max > 0:
        score = torch.clamp(s.awareness, 0, params.awareness_max - 1)
        mult = (score + 1).to(F32)
        lha_go = drawn["lha"] * mult < 1.0
    else:
        mult = torch.ones(n, dtype=F32, device=dev)
        lha_go = torch.ones(n, dtype=torch.bool, device=dev)
    prober = live & lha_go
    skip = _believes_down_shift(params, s, maps, d, tick)
    t_up = rolls.pull(live, d)

    if params.degraded_frac > 0.0:
        h = (torch.arange(n, dtype=I64, device=dev) * 2654435761
             + params.seed) & prng.M32
        degraded = (h.to(F32) / np.float32(2 ** 32)) < params.degraded_frac
        ok_node = torch.where(degraded, prng.f32(1.0 - params.degraded_loss),
                              prng.f32(1.0 - params.p_loss))
    else:
        ok_node = torch.full((n,), 1.0 - params.p_loss, dtype=F32, device=dev)
    if params.chaos:
        # the nemesis: a per-node delivery rate folds into every leg, and
        # a leg exists only between same-group endpoints
        ok_node = ok_node * s.chaos_ok
        grp = s.chaos_grp
        same_t = grp == rolls.pull(grp, d)

    diff = s.coords - rolls.pull(s.coords, d)
    rtt = torch.sqrt((diff * diff).sum(-1)) + params.rtt_base_ms
    rtt = rtt * (1.0 + drawn["rtt"] * 0.1)
    ok_t = rolls.pull(ok_node, d)
    m_t = torch.minimum(ok_node, ok_t)
    legs_ok = drawn["direct"] < m_t * m_t
    if params.chaos:
        legs_ok = legs_ok & same_t
    direct_ack = t_up & legs_ok & (2.0 * rtt < params.probe_timeout_ms * mult)

    if k > 0:
        ok_r = torch.stack([rolls.pull(ok_node, offs[1 + j]) for j in range(k)],
                           dim=-1)
        l1 = drawn["uA"] < torch.minimum(ok_node[:, None], ok_r)
        m_rt = torch.minimum(ok_r, ok_t[:, None])
        l23 = drawn["uB"] < m_rt * m_rt
        l4 = drawn["uC"] < torch.minimum(ok_r, ok_node[:, None])
        if params.chaos:
            rgrp = torch.stack([rolls.pull(grp, offs[1 + j])
                                for j in range(k)], dim=-1)
            same_r = rgrp == grp[:, None]
            same_rt = rgrp == rolls.pull(grp, d)[:, None]
            l1 = l1 & same_r
            l4 = l4 & same_r
            l23 = l23 & same_rt
        relay_ok = torch.stack([rolls.pull(live, offs[1 + j]) for j in range(k)],
                               dim=-1)
        reach = t_up[:, None] & l23
        ind_ack = relay_ok & l1 & reach & l4
        nacked = relay_ok & l1 & ~reach & l4
        ack = direct_ack | ind_ack.any(-1)
    else:
        nacked = torch.zeros((n, 0), dtype=torch.bool, device=dev)
        ack = direct_ack

    t_member = rolls.pull(s.member, d)
    failed = prober & ~skip & ~ack & t_member
    probed = prober & ~skip & t_member
    if params.awareness_max > 0:
        nack_count = nacked.sum(-1, dtype=I32)
        delta_fail = (k - nack_count) if k > 0 else 0
        zero = torch.zeros((), dtype=I32, device=dev)
        delta = torch.where(probed & ack, -1,
                            torch.where(failed, delta_fail, zero))
        s = s.replace(awareness=torch.clamp(
            s.awareness.to(I32) + delta, 0, params.awareness_max - 1).to(I8))
    cnt = rolls.push(failed, d).to(I32)
    suspect_of, dead_of, left_of, _ = maps

    # (a) confirm existing suspicions; joiners start carrying the rumor
    r_confirm = s.r_confirm.to(I32) + torch.where(
        s.r_active & (s.r_kind == SUSPECT),
        torch.clamp_max(cnt[s.r_subject.to(I64)], 8), 0)
    r_confirm = torch.clamp_max(r_confirm, 64).to(I8)
    es = rolls.pull(suspect_of, d)
    joiner = failed & (es >= 0)
    cell = _onehot(es, params.rumor_slots) & joiner[:, None]
    fresh_cell = cell & ~s.know
    s = s.replace(
        r_confirm=r_confirm, know=s.know | cell,
        learn_tick=torch.where(fresh_cell, _t16(tick), s.learn_tick),
        sends_left=torch.where(fresh_cell, params.retransmit_limit,
                               s.sends_left))

    # (b) dense per-subject suspicion timers
    suspected = cnt > 0
    start_new = suspected & (s.sus_start < 0) \
        & ~s.committed_dead & ~s.committed_left & s.member
    sus_start = torch.where(start_new, tick, s.sus_start)
    sus_confirm = torch.where(
        start_new, 1,
        torch.where(suspected & (s.sus_start >= 0),
                    torch.clamp_max(s.sus_confirm.to(I32) + cnt, 64),
                    s.sus_confirm.to(I32))).to(I8)
    s = s.replace(sus_start=sus_start, sus_confirm=sus_confirm,
                  sus_count=s.sus_count + start_new.to(I32))

    zero = torch.zeros((), dtype=I64, device=dev)
    incr = torch.stack([probed.sum(), (probed & ack).sum(), failed.sum(),
                        start_new.sum(), zero, zero, zero]).to(F32)
    s = s.replace(ctr=s.ctr + incr)

    # (c) originate suspect rumors for subjects with no existing rumor
    fresh = (cnt > 0) & (suspect_of < 0) & (dead_of < 0) & (left_of < 0) \
        & ~s.committed_dead & ~s.committed_left
    want = torch.where(fresh, cnt, 0)
    target = ((torch.arange(n, dtype=I64, device=dev) + d) % n).to(I32)
    row_subject = torch.where(failed, target, -1)
    obs = ProbeObs(shift=d, rtt_ms=2.0 * rtt,
                   acked=prober & ~skip & direct_ack)
    return s, want, row_subject, obs


def _probe_pass(params: SwimParams, s: SwimState, maps, drawn: dict):
    """_probe_pass_plain's result; on CUDA tensors one K7 launch, which
    updates s's rows, awareness, timers, r_confirm and counters in place
    (the state returned holds s's tensors) and writes want, row_subject
    and the ProbeObs into fresh tensors."""
    if not s.know.is_cuda:
        return _probe_pass_plain(params, s, maps, drawn)
    suspect_of, dead_of, left_of, alive_val = maps
    amax = params.awareness_max
    _writable(s, PROBE_INPLACE if amax > 0 else
              tuple(f for f in PROBE_INPLACE if f != "awareness"), "K7")
    e = torch.empty_like
    out = dict(want_out=e(s.sus_start), row_subject_out=e(s.sus_start),
               rtt_out=e(s.bulk_cov), acked_out=e(s.up))
    kernels.launch_probe_round(
        up=s.up, member=s.member, awareness=s.awareness, coords=s.coords,
        committed_dead=s.committed_dead, committed_left=s.committed_left,
        committed_inc=s.committed_inc, bulk_member=s.bulk_member,
        know=s.know, learn_tick=s.learn_tick, sends_left=s.sends_left,
        sus_start=s.sus_start, sus_confirm=s.sus_confirm,
        sus_count=s.sus_count,
        chaos_grp=s.chaos_grp if params.chaos else None,
        chaos_ok=s.chaos_ok if params.chaos else None,
        r_active=s.r_active, r_kind=s.r_kind, r_subject=s.r_subject,
        r_inc=s.r_inc, r_confirm=s.r_confirm,
        timeouts=_table(params, s.device, I16), suspect_of=suspect_of,
        dead_of=dead_of, left_of=left_of, alive_val=alive_val, ctr=s.ctr,
        offs=drawn["offs"], rtt_draw=drawn["rtt"], direct=drawn["direct"],
        lha=drawn.get("lha"), leg_a=drawn.get("uA"), leg_b=drawn.get("uB"),
        leg_c=drawn.get("uC"), awareness_max=amax,
        degraded=params.degraded_frac > 0.0, seed=params.seed,
        ok_good=prng.f32(1.0 - params.p_loss),
        ok_bad=prng.f32(1.0 - params.degraded_loss),
        degraded_frac=params.degraded_frac,
        probe_timeout_ms=params.probe_timeout_ms,
        rtt_base_ms=params.rtt_base_ms, tick=s.tick, tick16=_t16(s.tick),
        limit=params.retransmit_limit, **out)
    obs = ProbeObs(shift=drawn["offs"][0], rtt_ms=out["rtt_out"],
                   acked=out["acked_out"])
    return s, out["want_out"], out["row_subject_out"], obs


def _probe_round_plain(params: SwimParams, s: SwimState, maps):
    """The plain twin of _probe_round: _probe_pass_plain, then
    _originate_plain and _map_add_plain, on the same draws."""
    s, want, row_subject, obs = _probe_pass_plain(params, s, maps,
                                                  _probe_inputs(params, s))
    s, alloc = _originate_plain(params, s, want, SUSPECT, s.incarnation,
                                row_subject)
    return s, obs, (_map_add_plain(maps[0], *alloc), *maps[1:])


def _probe_round(params: SwimParams, s: SwimState, maps):
    """One SWIM probe round: ring probe + k indirect probes + suspicion
    (swim.py:698-897).  Its draws are one K1 batch; on CUDA tensors the
    round is K7, its suspect rumors K8 and their map update K9.  Returns
    (state, ProbeObs, maps with the new suspect rumors)."""
    s, want, row_subject, obs = _probe_pass(params, s, maps,
                                            _probe_inputs(params, s))
    s, alloc = _originate(params, s, want, SUSPECT, s.incarnation,
                          row_subject)
    return s, obs, (_map_add(maps[0], *alloc), *maps[1:])


def _suspicion_expiry_plain(params: SwimParams, s: SwimState):
    """The plain PyTorch version of K10: holders whose suspicion timer
    expired convert the suspect slot into its dead rumor in place
    (swim.py:900-962).  Returns (state, convert)."""
    u = params.rumor_slots
    dev = s.device
    tick = s.tick
    is_suspect = s.r_active & (s.r_kind == SUSPECT)
    timeout16 = _timeouts(params, s.r_confirm).to(I16)
    age = _t16(tick) - s.learn_tick                               # int16
    u_ids = torch.arange(u, dtype=I32, device=dev)
    same = s.r_subject[:, None] == s.r_subject[None, :]           # [U, U]
    is_alive = s.r_active & (s.r_kind == ALIVE)
    av = torch.where(same & is_alive[None, :],
                     s.r_inc[None, :] * u + u_ids[None, :], -1).amax(1)
    a_slot = torch.where(av >= 0, av % u, 0)
    a_inc = torch.where(av >= 0, torch.div(av, u, rounding_mode="floor"), -1)
    refutable = (av >= 0) & (a_inc > s.r_inc)
    know_alive = s.know.index_select(1, a_slot.to(I64))           # [N, U]
    refuted = refutable[None, :] & know_alive
    refuted = refuted | (s.r_inc < s.committed_inc[s.r_subject.to(I64)])[None, :]
    observer = (s.up & s.member)[:, None]
    expired = s.know & is_suspect[None, :] & (age >= timeout16[None, :]) \
        & ~refuted & observer
    any_exp = expired.any(0)
    is_dead = s.r_active & (s.r_kind == DEAD)
    dead_exists = (same & is_dead[None, :]).any(1)
    convert = any_exp & ~dead_exists & ~s.committed_dead[s.r_subject.to(I64)]
    limit = params.retransmit_limit
    s = s.replace(
        r_kind=torch.where(convert, DEAD, s.r_kind),
        r_start=torch.where(convert, tick, s.r_start),
        know=torch.where(convert[None, :], expired, s.know),
        learn_tick=torch.where(convert[None, :] & expired, _t16(tick),
                               s.learn_tick),
        sends_left=torch.where(convert[None, :],
                               torch.where(expired, limit, 0).to(I8),
                               s.sends_left))
    return s, convert


def _suspicion_expiry(params: SwimParams, s: SwimState):
    """_suspicion_expiry_plain's result.  On CUDA tensors one K10 launch
    consumes s: it updates the converted columns of s's rows and the
    converted slots of its table in place (the state returned holds s's
    tensors) and writes convert into a fresh tensor.  Returns (state,
    convert [U] bool)."""
    if not s.know.is_cuda:
        return _suspicion_expiry_plain(params, s)
    _writable(s, EXPIRY_INPLACE, "K10")
    convert = torch.empty_like(s.r_active)
    kernels.launch_suspicion_expiry(
        know=s.know, learn_tick=s.learn_tick, sends_left=s.sends_left,
        up=s.up, member=s.member, committed_dead=s.committed_dead,
        committed_inc=s.committed_inc, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        r_confirm=s.r_confirm, timeouts=_table(params, s.device, I16),
        tick=s.tick, tick16=_t16(s.tick), limit=params.retransmit_limit,
        convert_out=convert)
    return s, convert


def _dense_suspicion_expiry_plain(params: SwimParams, s: SwimState,
                                  shift: torch.Tensor, maps) -> SwimState:
    """The plain PyTorch version of K11 around its origination (_originate,
    which is K8 on CUDA tensors): expire dense per-subject suspicion timers
    into dead rumors, with overflow into the bulk channel
    (swim.py:965-1083)."""
    n = params.n_nodes
    dev = s.device
    tick = s.tick
    active = s.sus_start >= 0
    refute = active & s.up & s.member \
        & (tick - s.sus_start >= params.probe_period_ticks)
    timeout = _timeouts(params, s.sus_confirm)
    expired = active & ~refute & (tick - s.sus_start >= timeout) & s.member
    suspect_of, dead_of, left_of, _ = maps

    subj = s.r_subject.to(I64)
    is_suspect = s.r_active & (s.r_kind == SUSPECT)
    exp_u = is_suspect & expired[subj] & (dead_of[subj] < 0) \
        & ~s.committed_dead[subj]
    sel = exp_u[None, :] & s.know
    s = s.replace(
        r_kind=torch.where(exp_u, DEAD, s.r_kind),
        r_start=torch.where(exp_u, tick, s.r_start),
        learn_tick=torch.where(sel, _t16(tick), s.learn_tick),
        sends_left=torch.where(sel, params.retransmit_limit, s.sends_left))
    suspect_of, dead_of, left_of, _ = _maps_convert_plain(
        (suspect_of, dead_of, left_of, None), s, exp_u)
    prober_live = rolls.push(s.up & s.member, shift)
    want = torch.where(expired & (dead_of < 0) & (left_of < 0)
                       & (suspect_of < 0) & ~s.committed_dead
                       & ~s.bulk_member & prober_live, 1, 0).to(I32)
    target = ((torch.arange(n, dtype=I64, device=dev) + shift) % n).to(I32)
    row_subject = torch.where(rolls.pull(want, shift) > 0, target, -1)
    s, alloc = _originate(params, s, want, DEAD, s.incarnation, row_subject)
    dead_of2 = _map_add_plain(dead_of, *alloc)
    left_of2 = left_of
    overflow = (want > 0) & (dead_of2 < 0)
    if params.chaos:
        # the bulk channel's mean-field coverage is not partition-aware:
        # the nemesis build turns the overflow off (swim.py:1049-1060)
        overflow = torch.zeros_like(overflow)
    bulk_member = s.bulk_member | overflow
    v_prev = s.bulk_member.sum().to(F32)
    seeded = rolls.pull(overflow, shift)
    bulk_heard = torch.minimum(
        torch.minimum(s.bulk_heard, v_prev) + seeded.to(F32),
        bulk_member.sum().to(F32))
    n_live_f = (s.up & s.member).sum().clamp_min(1).to(F32)
    bulk_cov = torch.where(overflow, 1.0 / n_live_f, s.bulk_cov)
    s = s.replace(bulk_member=bulk_member, bulk_heard=bulk_heard,
                  bulk_cov=bulk_cov)
    done = refute | s.committed_dead | s.committed_left \
        | (dead_of2 >= 0) | (left_of2 >= 0) | ~s.member | bulk_member
    return s.replace(
        sus_start=torch.where(done, -1, s.sus_start),
        sus_confirm=torch.where(done, 0, s.sus_confirm).to(I8))


def _dense_suspicion_expiry(params: SwimParams, s: SwimState,
                            shift: torch.Tensor, maps) -> SwimState:
    """Expire dense per-subject suspicion timers into dead rumors, with
    overflow into the bulk channel (swim.py:965-1083).  On CUDA tensors
    K11's pre launch (the slot conversions, the wants at each prober's
    target, the sums), K8's dead origination and K11's post launch (the
    dead map after the conversions and the origination read per node, the
    overflow, the timer clears); `shift` stays a device tensor.  On the
    card it consumes s: the three launches update DENSE_INPLACE and
    ORIGINATE_INPLACE in place, and the state returned holds s's
    tensors."""
    if not s.know.is_cuda:
        return _dense_suspicion_expiry_plain(params, s, shift, maps)
    _writable(s, DENSE_INPLACE, "K11")
    dev = s.device
    shift = torch.as_tensor(shift, dtype=I32, device=dev)
    suspect_of, dead_of, left_of, _ = maps
    wants = torch.empty((2, params.n_nodes), dtype=I32, device=dev)
    want, row_subject = wants[0], wants[1]
    exp = torch.empty_like(s.r_active)
    counts = torch.empty(kernels.DENSE_COUNTS, dtype=I64, device=dev)
    kernels.launch_dense_expiry(
        sus_start=s.sus_start, sus_confirm=s.sus_confirm, up=s.up,
        member=s.member, committed_dead=s.committed_dead,
        bulk_member=s.bulk_member, suspect_of=suspect_of, dead_of=dead_of,
        left_of=left_of, know=s.know, learn_tick=s.learn_tick,
        sends_left=s.sends_left, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_start=s.r_start,
        timeouts=_table(params, dev, I32), shift=shift, tick=s.tick,
        tick16=_t16(s.tick), limit=params.retransmit_limit,
        period=params.probe_period_ticks, exp_out=exp, want_out=want,
        row_subject_out=row_subject, counts_out=counts)
    r_subject = s.r_subject.clone()     # K8 rewrites the table in place
    s, (subjects, slots, ok) = _originate(params, s, want, DEAD,
                                          s.incarnation, row_subject)
    kernels.launch_dense_expiry_post(
        want=want, dead_of=dead_of, left_of=left_of, exp=exp,
        r_subject=r_subject, subjects=subjects, slots=slots, ok=ok, up=s.up,
        member=s.member, committed_dead=s.committed_dead,
        committed_left=s.committed_left, counts=counts, shift=shift,
        tick=s.tick, period=params.probe_period_ticks, chaos=params.chaos,
        bulk_member=s.bulk_member, bulk_heard=s.bulk_heard,
        bulk_cov=s.bulk_cov, sus_start=s.sus_start,
        sus_confirm=s.sus_confirm)
    return s


def _refutation_plain(params: SwimParams, s: SwimState) -> SwimState:
    """The plain PyTorch version of K12's refutation: a live subject that
    hears it is suspected (or declared dead) bumps its incarnation and
    converts the slot to alive in place (swim.py:1086-1149)."""
    u = params.rumor_slots
    n = params.n_nodes
    dev = s.device
    refutable = s.r_active & ((s.r_kind == SUSPECT) | (s.r_kind == DEAD))
    subj = s.r_subject.to(I64)
    subject_knows = s.know[subj, torch.arange(u, device=dev)]
    need = refutable & subject_knows & s.up[subj] & s.member[subj] \
        & (s.r_inc >= s.incarnation[subj])
    idx = torch.where(need, s.r_subject, 0)
    inc = _scatter(s.incarnation, idx, torch.where(need, s.r_inc + 1, -1),
                   "amax")
    awareness = s.awareness
    if params.awareness_max > 0:
        bumped = awareness.to(I32).scatter_add(0, idx.to(I64), need.to(I32))
        awareness = torch.clamp(bumped.to(I8), 0, params.awareness_max - 1)
    onehot_subj = torch.arange(n, device=dev)[:, None] == subj[None, :]
    cell_new = need[None, :] & onehot_subj
    return s.replace(
        awareness=awareness,
        incarnation=inc,
        r_kind=torch.where(need, ALIVE, s.r_kind),
        r_inc=torch.where(need, inc[subj], s.r_inc),
        r_start=torch.where(need, s.tick, s.r_start),
        know=torch.where(need[None, :], cell_new, s.know),
        learn_tick=torch.where(cell_new, _t16(s.tick), s.learn_tick),
        sends_left=torch.where(need[None, :],
                               torch.where(cell_new, params.retransmit_limit,
                                           0).to(I8),
                               s.sends_left))


def _refutation(params: SwimParams, s: SwimState) -> SwimState:
    """_refutation_plain's result.  On CUDA tensors one K12 launch consumes
    s: it updates REFUTE_INPLACE in place (awareness only with
    awareness_max > 0), and the state returned holds s's tensors."""
    if not s.know.is_cuda:
        return _refutation_plain(params, s)
    amax = params.awareness_max
    _writable(s, REFUTE_INPLACE if amax > 0 else
              tuple(f for f in REFUTE_INPLACE if f != "awareness"), "K12")
    kernels.launch_refutation(
        incarnation=s.incarnation, awareness=s.awareness, up=s.up,
        member=s.member, know=s.know, learn_tick=s.learn_tick,
        sends_left=s.sends_left, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        awareness_max=amax, tick=s.tick, tick16=_t16(s.tick),
        limit=params.retransmit_limit)
    return s


def _both(a, b):
    """a & b of two [N] bool leaves, block by block on a sharded state."""
    return a.map(torch.logical_and, b) if isinstance(a, Blocks) else a & b


def tick_offsets(key, n: int, k: int, like) -> torch.Tensor:
    """rolls.offsets on the device of `like`; for a node-sharded leaf one
    draw on each distinct device of its mesh (every device draws alike),
    Replicated."""
    if isinstance(like, Blocks):
        return Replicated(rolls.offsets(key, n, k, d)
                          for d in dict.fromkeys(like.devices))
    return rolls.offsets(key, n, k, like.device)


def _disseminate(params: SwimParams, s: SwimState) -> SwimState:
    """Piggyback gossip over the rumor table (swim.py:1152-1181): K2, with
    the learn-tick stamp and the gossip counters folded in (on a sharded
    state over its blocks)."""
    tick = s.tick
    offs = tick_offsets(prng.tick_key(params.seed, tick, 2), params.n_nodes,
                        params.gossip_nodes, s.up)
    res = gossip_ops.disseminate(offs, s.know, s.sends_left,
                                 sender_ok=s.up,
                                 receiver_ok=_both(s.up, s.member),
                                 slot_active=s.r_active,
                                 retransmit_limit=params.retransmit_limit,
                                 p_loss=params.p_loss,
                                 key=prng.tick_key(params.seed, tick, 5),
                                 learn_tick=s.learn_tick, tick16=_t16(tick),
                                 ctr=s.ctr, want_newly=False,
                                 group=s.chaos_grp if params.chaos else None,
                                 node_ok=s.chaos_ok if params.chaos else None)
    return s.replace(know=res.know, learn_tick=res.learn_tick,
                     sends_left=res.sends_left, ctr=res.ctr)


def _bulk_disseminate(params: SwimParams, s: SwimState) -> SwimState:
    """Advance the bulk death channel one gossip tick (swim.py:1184-1247)."""
    n = params.n_nodes
    dev = s.device
    offs = rolls.offsets(prng.tick_key(params.seed, s.tick, 4), n,
                         params.gossip_nodes, dev)
    v = s.bulk_member.sum().to(F32).clamp_min(1.0)
    cap = np.float32(params.packet_msgs)
    p_ok = np.float32(1.0 - params.p_loss)
    recv = s.up & s.member
    heard = torch.minimum(s.bulk_heard, v)
    supply_src = torch.where(s.up, heard, 0.0)
    n_up = s.up.sum().clamp_min(1).to(F32)
    mean_supply = supply_src.sum() / n_up
    views = rolls.pull_multi(supply_src, offs)
    if params.chaos:
        # cross-group contacts carry nothing; degraded endpoints scale the
        # transfer by the pairwise rate, (v * ok_sender) * ok_receiver
        views = [torch.where(gv == s.chaos_grp, (v * ov) * s.chaos_ok, 0.0)
                 for v, gv, ov in zip(views,
                                      rolls.pull_multi(s.chaos_grp, offs),
                                      rolls.pull_multi(s.chaos_ok, offs))]
    for view in views:
        supply = torch.clamp_max(view, float(cap))
        novelty = 1.0 - heard / v
        heard = torch.where(recv,
                            torch.minimum(heard + supply * novelty * float(p_ok), v),
                            heard)
    sel = torch.clamp_max(float(cap) / mean_supply.clamp_min(1.0), 1.0)
    cov = s.bulk_cov
    q = 1.0 - torch.clamp(cov * sel * float(p_ok), 0.0, 1.0)
    q_pow = _integer_pow(q, params.gossip_nodes)
    p_learn = 1.0 - q_pow
    cov = torch.where(s.bulk_member,
                      torch.clamp(cov + (1.0 - cov) * p_learn, 0.0, 1.0), 0.0)
    return s.replace(bulk_heard=heard, bulk_cov=cov)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y by XLA's integer_pow: square-and-multiply, same rounding."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc if acc is not None else torch.ones_like(x)


def _bulk_commit(params: SwimParams, s: SwimState) -> SwimState:
    """Commit bulk subjects whose own coverage reached 99.5%."""
    done = s.bulk_member & (s.bulk_cov >= 0.995)
    removed = torch.where(done, s.bulk_cov, 0.0).sum()
    v_new = (s.bulk_member & ~done).sum().to(F32)
    heard = torch.minimum(torch.clamp_min(s.bulk_heard - removed, 0.0), v_new)
    return s.replace(
        committed_dead=s.committed_dead | done,
        bulk_member=s.bulk_member & ~done,
        bulk_heard=heard,
        bulk_cov=torch.where(done, 0.0, s.bulk_cov))


def _bulk_step_plain(params: SwimParams, s: SwimState) -> SwimState:
    """The plain PyTorch version of K14: the bulk branch, applied only where
    the channel holds members (the device-side form of JAX's lax.cond on
    any(bulk_member), swim.py:1350-1354)."""
    live = s.bulk_member.any()
    t = _bulk_commit(params, _bulk_disseminate(params, s))
    pick = lambda a, b: torch.where(live, a, b)  # noqa: E731
    return s.replace(committed_dead=pick(t.committed_dead, s.committed_dead),
                     bulk_member=pick(t.bulk_member, s.bulk_member),
                     bulk_heard=pick(t.bulk_heard, s.bulk_heard),
                     bulk_cov=pick(t.bulk_cov, s.bulk_cov))


def _bulk_step(params: SwimParams, s: SwimState) -> SwimState:
    """_bulk_step_plain's result.  On CUDA tensors one K14 launch (a
    cooperative count, supply, advance and commit, its ring offsets drawn
    inside it from the same randint spec as rolls.offsets') consumes s:
    it updates BULK_INPLACE in place where values change, with no host
    sync, and the state returned holds s's tensors.  Its float sums run in
    an order of its own (bulk_heard and bulk_cov within ulps of the
    twin's)."""
    global bulk_steps
    bulk_steps += 1
    if not s.know.is_cuda:
        return _bulk_step_plain(params, s)
    _writable(s, BULK_INPLACE, "K14")
    offsets = prng.randint_spec(rolls.offsets_draw(
        prng.tick_key(params.seed, s.tick, 4), params.n_nodes,
        params.gossip_nodes))
    kernels.launch_bulk_step(
        bulk_member=s.bulk_member, bulk_heard=s.bulk_heard,
        bulk_cov=s.bulk_cov, up=s.up, member=s.member,
        committed_dead=s.committed_dead, offsets=offsets,
        group=s.chaos_grp if params.chaos else None,
        node_ok=s.chaos_ok if params.chaos else None,
        cap=float(np.float32(params.packet_msgs)),
        p_ok=float(np.float32(1.0 - params.p_loss)))
    return s


def _expire_plain(params: SwimParams, s: SwimState) -> SwimState:
    """The plain PyTorch version of K12's expire: free slots whose
    dissemination window passed; commit dead/left into the O(N) baseline,
    coverage-guarded (swim.py:1267-1287)."""
    life = torch.where(s.r_kind == SUSPECT, params.expiry_suspect_ticks,
                       params.expiry_gossip_ticks).to(I32)
    age = s.tick - s.r_start
    live = s.up & s.member
    n_live = live.sum().clamp_min(1)
    coverage = (s.know & live[:, None]).sum(0).to(F32) / n_live.to(F32)
    done = s.r_active & (age >= life) \
        & ((coverage >= 0.995) | (age >= 4 * life))
    return _release(s, done, coverage)


def _expire(params: SwimParams, s: SwimState) -> SwimState:
    """_expire_plain's result.  On CUDA tensors one K12 expire launch (a
    cooperative count, decision and apply) consumes s: it updates
    FREE_INPLACE in place, and the state returned holds s's tensors
    (learn_tick is left as it is)."""
    if not s.know.is_cuda:
        return _expire_plain(params, s)
    _writable(s, FREE_INPLACE, "K12 expire")
    kernels.launch_expire(
        know=s.know, sends_left=s.sends_left, up=s.up, member=s.member,
        committed_dead=s.committed_dead, committed_left=s.committed_left,
        committed_inc=s.committed_inc, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        r_coverage=s.r_coverage, tick=s.tick,
        life_gossip=params.expiry_gossip_ticks,
        life_suspect=params.expiry_suspect_ticks)
    return s


def _release(s: SwimState, done: torch.Tensor,
             coverage: torch.Tensor) -> SwimState:
    """Free the `done` slots, committing beliefs a majority heard."""
    commit_ok = coverage >= 0.5
    commit_dead = done & (s.r_kind == DEAD) & commit_ok
    commit_left = done & (s.r_kind == LEFT) & commit_ok
    commit_alive = done & (s.r_kind == ALIVE) & commit_ok
    committed_dead = _scatter(s.committed_dead,
                              torch.where(commit_dead, s.r_subject, 0),
                              commit_dead, "amax")
    committed_left = _scatter(s.committed_left,
                              torch.where(commit_left, s.r_subject, 0),
                              commit_left, "amax")
    committed_inc = _scatter(s.committed_inc,
                             torch.where(commit_alive, s.r_subject, 0),
                             torch.where(commit_alive, s.r_inc, 0), "amax")
    keep = ~done
    return s.replace(
        r_active=s.r_active & keep,
        committed_dead=committed_dead,
        committed_left=committed_left,
        committed_inc=committed_inc,
        know=s.know & keep[None, :],
        sends_left=torch.where(keep[None, :], s.sends_left, 0).to(I8),
        r_coverage=torch.where(keep, coverage, 0.0))


def _bulk_flag(bulk_member: torch.Tensor) -> bool:
    """The probe tick's one host sync: does the bulk channel hold members?"""
    global host_syncs
    host_syncs += 1
    return bool(bulk_member.any().item())


def step_with_obs(params: SwimParams, s: SwimState):
    """Advance the whole cluster one gossip tick (swim.py:1320-1354).
    Returns (state, obs); obs is None on ticks without a probe round.
    On the card a probe tick consumes s: K7, K8 and K10-K12 update its
    tensors in place (and K9 the tick's own maps).  So does every tick
    with the bulk channel live, gossip-only ticks included: K14 updates
    BULK_INPLACE in place.  A caller that reads s again steps
    s.clone().  A node-sharded state (parallel/mesh.py) runs every tick
    over its blocks (models/swim_blocks.py: each probe-tick pass block by
    block, one host read of the bulk flag a probe tick whatever B is).
    Its bulk channel is ROADMAP queue A item 3b-ii: a tick that starts
    with the channel live raises meshlib.BulkChannelLive before anything
    runs, gathering nothing, and so does a probe tick whose dense expiry
    puts members into it, after its passes: the error carries the state
    those passes left (on the card the state given is consumed), whose
    bulk_live refuses every later tick."""
    obs = None
    if isinstance(s.up, Blocks):
        if s.bulk_live:
            raise meshlib.BulkChannelLive(
                f"tick {s.tick} (the bulk channel is live): "
                + meshlib.NOT_YET, s)
        if s.tick % params.probe_period_ticks == 0:
            s, obs = swim_blocks.probe_tick(params, s)
            if s.bulk_live:
                raise meshlib.BulkChannelLive(
                    f"tick {s.tick} (the probe tick's dense expiry put "
                    f"members into the bulk channel): " + meshlib.NOT_YET, s)
        return _disseminate(params, s).replace(tick=s.tick + 1), obs
    if s.tick % params.probe_period_ticks == 0:
        maps = _maps(params, s)
        s, obs, maps = _probe_round(params, s, maps)
        s, convert = _suspicion_expiry(params, s)
        maps = _maps_convert(maps, s, convert)
        s = _dense_suspicion_expiry(params, s, obs.shift, maps)
        s = _refutation(params, s)
        s = _expire(params, s)
        s = s.replace(bulk_live=_bulk_flag(s.bulk_member))
    s = _disseminate(params, s)
    if s.bulk_live:
        s = _bulk_step(params, s)
    return s.replace(tick=s.tick + 1), obs


def step(params: SwimParams, s: SwimState) -> SwimState:
    """step_with_obs's state (on the card it consumes s on a probe tick
    and on every tick with the bulk channel live)."""
    return step_with_obs(params, s)[0]


def run(params: SwimParams, s: SwimState, n_ticks: int,
        monitor_subject: Optional[int] = None):
    """Run `n_ticks` steps; with a monitor subject, the believed-down
    fraction of that subject after every tick lands in one [n_ticks]
    float32 device vector (read back once by the caller).  On the card it
    consumes s (step_with_obs)."""
    fr = torch.zeros(n_ticks, dtype=F32, device=s.device)
    for t in range(n_ticks):
        s = step(params, s)
        if monitor_subject is not None:
            believed_down_fraction(params, s, monitor_subject,
                                   out=fr[t:t + 1])
    return s, fr


# ---------------------------------------------------------------------------
# device-side metrics summary
# ---------------------------------------------------------------------------

METRIC_NAMES = (
    "probe.sent", "probe.acked", "probe.failed", "suspicion.started",
    "gossip.delivered", "gossip.served", "gossip.lost",
    "queue.alive", "queue.suspect", "queue.dead", "queue.left",
    "queue.depth", "slot.utilization", "convergence.fraction",
    "members.alive", "members.failed_committed", "members.left_committed",
    "bulk.pending", "bulk.coverage", "awareness.mean", "tick",
)


def metrics_vector(params: SwimParams, s: SwimState) -> torch.Tensor:
    """One [len(METRIC_NAMES)] float32 vector of sim telemetry
    (swim.py:1393-1435), read back only at sync checkpoints.  On a
    node-sharded state from the blocks' integer totals
    (swim_blocks.metrics_vector)."""
    if isinstance(s.up, Blocks):
        return swim_blocks.metrics_vector(params, s)
    live = s.up & s.member
    n_live = live.sum().clamp_min(1).to(F32)
    active = s.r_active
    n_active = active.sum().clamp_min(1).to(F32)
    live_cells = n_live * n_active
    know_live = s.know & live[:, None] & active[None, :]
    util = (know_live & (s.sends_left > 0)).sum().to(F32) / live_cells
    conv = torch.where(active, s.r_coverage, 0.0).sum() / n_active
    n_bulk = s.bulk_member.sum().to(F32)
    bulk_cov = torch.where(s.bulk_member, s.bulk_cov, 0.0).sum() \
        / n_bulk.clamp_min(1.0)
    gauges = torch.stack([
        (active & (s.r_kind == ALIVE)).sum().to(F32),
        (active & (s.r_kind == SUSPECT)).sum().to(F32),
        (active & (s.r_kind == DEAD)).sum().to(F32),
        (active & (s.r_kind == LEFT)).sum().to(F32),
        active.sum().to(F32),
        util,
        conv,
        live.sum().to(F32),
        s.committed_dead.sum().to(F32),
        s.committed_left.sum().to(F32),
        n_bulk,
        bulk_cov,
        torch.where(live, s.awareness.to(I32), 0).sum().to(F32) / n_live,
        torch.full((), s.tick, dtype=F32, device=s.device),
    ])
    return torch.cat([s.ctr, gauges])


def kill(s: SwimState, node: int) -> SwimState:
    """Crash a node (fail-stop).  The detector must discover this.  On a
    node-sharded state only the node's block is copied."""
    if isinstance(s.up, Blocks):
        return swim_blocks.kill(s, node)
    up = s.up.clone()
    up[node] = False
    return s.replace(up=up)


def kill_mask(s: SwimState, mask: torch.Tensor) -> SwimState:
    """Correlated failure: every node in `mask` ([N] bool) crashes in the
    same tick (swim.py:1570-1575)."""
    return s.replace(up=s.up & ~mask)


# ---------------------------------------------------------------------------
# mass-event detection stats (K5)
# ---------------------------------------------------------------------------

def mass_detection_stats_plain(params: SwimParams, s: SwimState,
                               victim_mask: torch.Tensor):
    """The plain PyTorch version of K5 (swim.py:1578-1604): (recall 0-d
    float32, false positives 0-d int32).  A subject is cluster-detected
    when its death or leave is committed, an active dead/left rumor about
    it reached >= 99% of live members, or it is a bulk-channel subject
    whose own coverage reached 99%."""
    live = s.up & s.member
    n_live = live.sum().clamp_min(1)
    coverage = (s.know & live[:, None]).sum(0).to(F32) / n_live.to(F32)
    dead_sl = s.r_active & ((s.r_kind == DEAD) | (s.r_kind == LEFT)) \
        & (coverage >= 0.99)
    rumor_detected = _scatter(torch.zeros_like(s.up),
                              torch.where(dead_sl, s.r_subject, 0), dead_sl,
                              "amax")
    believed_down = s.committed_dead | s.committed_left | rumor_detected \
        | (s.bulk_member & (s.bulk_cov >= 0.99))
    victims = victim_mask & s.member
    recall = (believed_down & victims).sum().to(F32) \
        / victims.sum().clamp_min(1).to(F32)
    return recall, (believed_down & live).sum().to(I32)


def mass_detection_stats(params: SwimParams, s: SwimState,
                         victim_mask: torch.Tensor, out=None):
    """(recall, false_positives) of a correlated-failure experiment: the
    fraction of victims (members of `victim_mask`) the cluster detected,
    and the live members it believes down.  On CUDA tensors one K5 launch
    writes them into `out`, a pair of device slots (a float32 [1] view
    and an int32 [1] view, e.g. of per-chunk vectors), when given, so a
    per-tick caller reads nothing back; else into fresh [1] tensors."""
    if not s.know.is_cuda:
        recall, fp = mass_detection_stats_plain(params, s, victim_mask)
        if out is None:
            return recall, fp
        out[0].copy_(recall.reshape(out[0].shape))
        out[1].copy_(fp.reshape(out[1].shape))
        return out
    if out is None:
        out = (torch.empty(1, dtype=F32, device=s.device),
               torch.empty(1, dtype=I32, device=s.device))
    kernels.launch_mass_detect(
        s.know, s.up, s.member, s.committed_dead, s.committed_left,
        s.bulk_member, s.bulk_cov, victim_mask, s.r_active, s.r_kind,
        s.r_subject, out[0], out[1])
    return out


# Per-shard split of the pool gauges: the node axis cut into `n_blocks`
# contiguous blocks (SimConfig.shard_blocks), each gauge reduced per block.
SHARD_METRIC_NAMES = (
    "members.alive", "members.failed_committed",
    "members.left_committed", "awareness.mean",
)


def shard_metrics(params: SwimParams, s: SwimState,
                  n_blocks: int) -> torch.Tensor:
    """[n_blocks, len(SHARD_METRIC_NAMES)] float32 per-shard gauges
    (swim.py:1449-1469)."""
    if isinstance(s.up, Blocks):
        return _shard_metrics_blocks(s, n_blocks)

    def blk(x):
        return x.reshape(n_blocks, -1)

    live = s.up & s.member
    alive = blk(live).sum(1).to(F32)
    n_live = alive.clamp_min(1.0)
    failed = blk(s.committed_dead).sum(1).to(F32)
    left = blk(s.committed_left).sum(1).to(F32)
    aware = blk(torch.where(live, s.awareness.to(I32), 0)).sum(1).to(F32) \
        / n_live
    return torch.stack([alive, failed, left, aware], dim=1)


def _shard_metrics_blocks(s: SwimState, n_blocks: int) -> torch.Tensor:
    """shard_metrics of a node-sharded state, a row a block (the same
    integer sums a row as the unsharded reshape's)."""
    if n_blocks != s.up.n_blocks:
        raise ValueError(f"shard_metrics: {n_blocks} gauges' blocks of a "
                         f"state in {s.up.n_blocks} blocks")
    home = s.device
    rows = []
    for b in range(n_blocks):
        live = s.up.parts[b] & s.member.parts[b]
        alive = live.sum().to(F32)
        aware = torch.where(live, s.awareness.parts[b].to(I32), 0).sum() \
            .to(F32) / alive.clamp_min(1.0)
        rows.append(torch.stack([
            alive, s.committed_dead.parts[b].sum().to(F32),
            s.committed_left.parts[b].sum().to(F32), aware]).to(home))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# oracle reads: the membership status and its reductions (K4)
# ---------------------------------------------------------------------------

STATUS_ALIVE = 0
STATUS_FAILED = 1
STATUS_LEFT = 2


def status_vector_plain(params: SwimParams, s: SwimState) -> torch.Tensor:
    """[N] int8 member status (swim.py:1482-1495): failed = committed dead
    or an active dead rumor, left = committed left or not a member; left
    wins.  The dead rumors scatter to their subjects, masked slots to
    index 0 with False."""
    n = s.member.shape[0]
    subj = _dead_rumors(s, n, s.member.device)
    dead = _scatter(torch.zeros_like(s.member), torch.where(subj >= 0, subj, n),
                    subj >= 0, "amax")
    return _status(s.member, s.committed_dead, s.committed_left, dead)


def _clamped(ids: torch.Tensor, n: int) -> torch.Tensor:
    """ids as a JAX gather takes them: negative ones wrapped once, then
    clamped into [0, n)."""
    ids = ids.to(I64)
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def membership_counts_plain(params: SwimParams, s: SwimState,
                            provisioned: torch.Tensor) -> torch.Tensor:
    st = status_vector_plain(params, s)
    return torch.stack([(provisioned & (st == STATUS_ALIVE)).sum(),
                        (provisioned & (st == STATUS_FAILED)).sum(),
                        (provisioned & (st == STATUS_LEFT)).sum(),
                        provisioned.sum()]).to(I32)


def membership_page_plain(params: SwimParams, s: SwimState,
                          ids: torch.Tensor):
    st = status_vector_plain(params, s)
    at = _clamped(ids, st.shape[0])
    return st[at], s.incarnation[at], s.up[at]


def membership_delta_plain(params: SwimParams, s: SwimState,
                           prev_status: torch.Tensor,
                           provisioned: torch.Tensor, k: int):
    """The plain version of K4's delta (swim.py:1525-1559): the first k
    changed indices by a stable top-k of the 0/1 changed mask."""
    st = status_vector_plain(params, s)
    changed = (st != prev_status) & provisioned
    n = changed.shape[0]
    kk = min(k, n)
    vals, idx = _top_k(changed.to(I32), kk)
    idx = torch.where(vals > 0, idx, -1)
    if kk < k:
        idx = torch.cat([idx, torch.full((k - kk,), -1, dtype=I32,
                                         device=idx.device)])
    return st, changed.sum().to(I32), idx, st[idx.clamp_min(0).to(I64)]


def _scan(s: SwimState, provisioned=None, prev=None, want_status=False):
    """K4's scan, one device kernel: (status or None, counts [5] int32,
    the tiles' prefix of changed counts or None)."""
    n, dev = s.member.shape[0], s.device
    status = torch.empty(n, dtype=I8, device=dev) \
        if want_status or prev is not None else None
    counts = torch.empty(kernels.MEMBER_COUNTS, dtype=I32, device=dev)
    tiles = torch.empty(kernels.member_tiles(n), dtype=I32, device=dev) \
        if prev is not None else None
    kernels.launch_members_scan(s.member, s.committed_dead, s.committed_left,
                                s.r_active, s.r_kind, s.r_subject, provisioned,
                                prev, status, counts, tiles)
    return status, counts, tiles


def _scan_blocks(s: SwimState, provisioned=None, prev=None,
                 want_status=False):
    """K4's scan over a node-sharded state, a launch a block, then the
    combine: (status Blocks or None, counts [5] int32, the blocks' [B * 5]
    counts, each block's tile prefix as Blocks or None)."""
    home, nb, ell = s.device, s.member.n_blocks, s.member.rows
    status = s.member.map(lambda m: torch.empty(ell, dtype=I8,
                                                device=m.device)) \
        if want_status or prev is not None else None
    blk_counts = torch.empty(nb * kernels.MEMBER_COUNTS, dtype=I32,
                             device=home)
    tiles = s.member.map(lambda m: torch.empty(
        kernels.member_tiles(ell), dtype=I32, device=m.device)) \
        if prev is not None else None
    kernels.launch_members_scan_blocks(
        s.member, s.committed_dead, s.committed_left, s.r_active, s.r_kind,
        s.r_subject, provisioned, prev, status, blk_counts, tiles)
    meshlib.join(s.member.devices)
    counts = torch.empty(kernels.MEMBER_COUNTS, dtype=I32, device=home)
    kernels.launch_members_combine(blk_counts, nb, counts)
    return status, counts, blk_counts, tiles


def _dead_rumors(s: SwimState, n: int, device):
    """The [U] table's dead subjects as JAX's scatter takes them: (each
    slot's index into [0, N) or -1 for none)."""
    table = {f: getattr(s, f) for f in ("r_active", "r_kind", "r_subject")}
    if isinstance(s.r_active, Replicated):
        table = {f: v.on(device) for f, v in table.items()}
    is_dead = table["r_active"] & (table["r_kind"] == DEAD)
    subj = table["r_subject"].to(I64)
    subj = torch.where(subj < 0, subj + n, subj)
    return torch.where(is_dead & (subj >= 0) & (subj < n), subj, -1)


def _status(member, cdead, cleft, dead) -> torch.Tensor:
    left = cleft | ~member
    failed = cdead | dead
    return torch.where(left, STATUS_LEFT,
                       torch.where(failed, STATUS_FAILED, STATUS_ALIVE)).to(I8)


def status_vector_blocks_plain(params: SwimParams, s: SwimState) -> Blocks:
    """status_vector_plain of a node-sharded state, block by block."""
    n, ell = params.n_nodes, s.member.rows
    out = []
    for b, member in enumerate(s.member.parts):
        dev = member.device
        local = _dead_rumors(s, n, dev) - b * ell
        hit = (local >= 0) & (local < ell)
        dead = _scatter(torch.zeros_like(member), torch.where(hit, local, ell),
                        hit, "amax")
        out.append(_status(member, s.committed_dead.parts[b],
                           s.committed_left.parts[b], dead))
    return Blocks(out)


def _gather_rows(x: Blocks, at: torch.Tensor) -> torch.Tensor:
    """x at the [K] int64 node ids `at` (in [0, N), on x's first device),
    block by block with selects: O(K * B), no [N] buffer, no sync."""
    home, ell = x.device, x.rows
    out = None
    for b, part in enumerate(x.parts):
        local = (at - b * ell).to(part.device)
        mine = (local >= 0) & (local < ell)
        got = part.index_select(0, torch.where(mine, local, 0)).to(home)
        mine = mine.to(home).reshape((-1,) + (1,) * (part.dim() - 1))
        out = got if out is None else torch.where(mine, got, out)
    return out


def _blocks_sum(x: Blocks, fn) -> torch.Tensor:
    """sum over blocks of fn(block b, b) (0-d integer tensors), in block
    order, on the first block's device."""
    home = x.device
    tot = None
    for b, part in enumerate(x.parts):
        v = fn(part, b).to(home)
        tot = v if tot is None else tot + v
    return tot


def membership_counts_blocks_plain(params, s, provisioned: Blocks):
    st = status_vector_blocks_plain(params, s)
    sums = [_blocks_sum(st, lambda part, b, c=c: (
        provisioned.parts[b] & (part == c)).sum())
        for c in (STATUS_ALIVE, STATUS_FAILED, STATUS_LEFT)]
    sums.append(_blocks_sum(provisioned, lambda part, b: part.sum()))
    return torch.stack(sums).to(I32)


def membership_page_blocks_plain(params, s, ids: torch.Tensor):
    n = params.n_nodes
    at = _clamped(ids, n)
    dead = (_dead_rumors(s, n, ids.device)[None, :] == at[:, None]).any(1)
    st = _status(_gather_rows(s.member, at), _gather_rows(s.committed_dead, at),
                 _gather_rows(s.committed_left, at), dead)
    return st, _gather_rows(s.incarnation, at), _gather_rows(s.up, at)


def membership_delta_blocks_plain(params, s, prev_status: Blocks,
                                  provisioned: Blocks, k: int):
    """membership_delta_plain of a node-sharded state: the blocks'
    statuses, their changed masks, and the first k changed rows by
    _top_k_sharded (no [N] vector on any device)."""
    st = status_vector_blocks_plain(params, s)
    changed = st.map(lambda a, p, v: (a != p) & v, prev_status, provisioned)
    n = params.n_nodes
    kk = min(k, n)
    vals, idx = _top_k_sharded(changed.map(lambda c: c.to(I32)), kk)
    idx = torch.where(vals > 0, idx, -1)
    if kk < k:
        idx = torch.cat([idx, torch.full((k - kk,), -1, dtype=I32,
                                         device=idx.device)])
    n_changed = _blocks_sum(changed, lambda part, b: part.sum()).to(I32)
    return st, n_changed, idx, _gather_rows(st, idx.clamp_min(0).to(I64))


def status_vector(params: SwimParams, s: SwimState) -> torch.Tensor:
    """[N] int8 member status (STATUS_*), staying on the device: K4's scan
    on CUDA tensors.  A node-sharded state gives Blocks."""
    if isinstance(s.member, Blocks):
        if not s.member.is_cuda:
            return status_vector_blocks_plain(params, s)
        return _scan_blocks(s, want_status=True)[0]
    if not s.member.is_cuda:
        return status_vector_plain(params, s)
    return _scan(s, want_status=True)[0]


def membership_counts(params: SwimParams, s: SwimState,
                      provisioned: torch.Tensor) -> torch.Tensor:
    """[4] int32 (alive, failed, left, total) over provisioned nodes:
    16 bytes to read back whatever N is (K4's scan on CUDA tensors; on a
    node-sharded state a scan a block and the combine, `provisioned`
    Blocks)."""
    if isinstance(s.member, Blocks):
        if not s.member.is_cuda:
            return membership_counts_blocks_plain(params, s, provisioned)
        return _scan_blocks(s, provisioned=provisioned)[1][:4]
    if not s.member.is_cuda:
        return membership_counts_plain(params, s, provisioned)
    return _scan(s, provisioned=provisioned)[1][:4]


def membership_page(params: SwimParams, s: SwimState, ids: torch.Tensor):
    """(status [K] int8, incarnation [K] int32, up [K] bool) at the [K]
    int32 ids (K4's page on CUDA tensors: no [N] status is built; on a
    node-sharded state one launch reading the blocks through tables, the
    ids on the mesh's first device)."""
    k, dev = ids.shape[0], s.device
    sharded = isinstance(s.member, Blocks)
    if not s.member.is_cuda:
        return (membership_page_blocks_plain if sharded
                else membership_page_plain)(params, s, ids)
    st = torch.empty(k, dtype=I8, device=dev)
    inc = torch.empty(k, dtype=I32, device=dev)
    up = torch.empty(k, dtype=torch.bool, device=dev)
    if sharded:
        kernels.launch_members_page_blocks(
            ids, s.member, s.committed_dead, s.committed_left, s.r_active,
            s.r_kind, s.r_subject, s.incarnation, s.up, st, inc, up)
    else:
        kernels.launch_members_page(
            ids, s.member, s.committed_dead, s.committed_left, s.r_active,
            s.r_kind, s.r_subject, s.incarnation, s.up, st, inc, up)
    return st, inc, up


def membership_delta(params: SwimParams, s: SwimState,
                     prev_status: torch.Tensor, provisioned: torch.Tensor,
                     k: int):
    """Changed provisioned members since a status checkpoint: (new status
    [N] int8, n_changed 0-d int32, idx [k] int32 ascending then -1, state
    [k] int8 = status at max(idx, 0)).  On CUDA tensors, K4's scan then its
    emit: no sort of [N].  On a node-sharded state the status, checkpoint
    and provisioned mask are Blocks: a scan and an emit a block, the
    combine between them."""
    dev = s.device
    if isinstance(s.member, Blocks):
        if not s.member.is_cuda:
            return membership_delta_blocks_plain(params, s, prev_status,
                                                 provisioned, k)
        st, counts, blk_counts, tiles = _scan_blocks(
            s, provisioned=provisioned, prev=prev_status)
        idx = torch.empty(k, dtype=I32, device=dev)
        state = torch.empty(k, dtype=I8, device=dev)
        kernels.launch_members_emit_blocks(st, prev_status, provisioned,
                                           tiles, blk_counts, k, idx, state)
        return st, counts[4], idx, state
    if not s.member.is_cuda:
        return membership_delta_plain(params, s, prev_status, provisioned, k)
    st, counts, tiles = _scan(s, provisioned=provisioned, prev=prev_status)
    idx = torch.empty(k, dtype=I32, device=dev)
    state = torch.empty(k, dtype=I8, device=dev)
    kernels.launch_members_emit(st, prev_status, provisioned, tiles, k, idx,
                                state, counts)
    return st, counts[4], idx, state


# ---------------------------------------------------------------------------
# membership commands (ground-truth edits and rumor origination)
# ---------------------------------------------------------------------------

def _one(n: int, node: int, device) -> torch.Tensor:
    """want_score of _originate for one subject: 1 at node, else 0."""
    want = torch.zeros(n, dtype=I32, device=device)
    want[node] = 1
    return want


def _own_row(n: int, node: int, device) -> torch.Tensor:
    """row_subject of _originate seeding the subject's own row."""
    return torch.where(torch.arange(n, device=device) == node, node,
                       -1).to(I32)


def _set(x: torch.Tensor, node: int, value) -> torch.Tensor:
    out = x.clone()
    out[node] = value
    return out


def rejoin(params: SwimParams, s: SwimState, node: int) -> SwimState:
    """Restart + rejoin after a committed death (swim.py:1656-1687): a
    bumped incarnation, committed dead/left cleared, the node's stale
    dead/left/suspect rumors withdrawn with their knowledge cells, and an
    alive rumor originated from the node itself.  On the card it consumes
    s (K8 updates tensors it shares in place).  A node-sharded state runs
    swim_blocks.rejoin."""
    if isinstance(s.up, Blocks):
        return swim_blocks.rejoin(params, s, node)
    n, dev = params.n_nodes, s.device
    inc = s.incarnation.clone()
    inc[node] += 1
    stale = s.r_active & (s.r_subject == node) & (
        (s.r_kind == DEAD) | (s.r_kind == LEFT) | (s.r_kind == SUSPECT))
    s = s.replace(
        up=_set(s.up, node, True), member=_set(s.member, node, True),
        committed_dead=_set(s.committed_dead, node, False),
        committed_left=_set(s.committed_left, node, False),
        incarnation=inc,
        r_active=s.r_active & ~stale,
        know=s.know & ~stale[None, :],
        sends_left=torch.where(stale[None, :], 0, s.sends_left).to(I8),
        bulk_member=_set(s.bulk_member, node, False),
        bulk_cov=_set(s.bulk_cov, node, 0.0))
    return _originate(params, s, _one(n, node, dev), ALIVE, inc,
                      _own_row(n, node, dev))[0]


def revive_mask(s: SwimState, mask: torch.Tensor) -> SwimState:
    """Flap restart (swim.py:1611-1645): every node in `mask` ([N] bool)
    comes back up; its stale suspect/dead rumors are withdrawn with their
    knowledge cells and budgets, its incarnation rises above every stale
    rumor's (a scatter-max of r_inc + 1, masked slots writing 0 to node
    0), and its dense timer and bulk-channel entry reset.  A committed
    death needs `rejoin`."""
    mask = mask.to(torch.bool)
    stale = s.r_active & mask[s.r_subject.to(I64)] \
        & ((s.r_kind == SUSPECT) | (s.r_kind == DEAD))
    bump = _scatter(torch.zeros_like(s.incarnation),
                    torch.where(stale, s.r_subject, 0),
                    torch.where(stale, s.r_inc + 1, 0), "amax")
    return s.replace(
        up=s.up | mask,
        incarnation=torch.maximum(s.incarnation, bump),
        r_active=s.r_active & ~stale,
        know=s.know & ~stale[None, :],
        sends_left=torch.where(stale[None, :], 0, s.sends_left).to(I8),
        sus_start=torch.where(mask, -1, s.sus_start),
        sus_confirm=torch.where(mask, 0, s.sus_confirm).to(I8),
        bulk_member=s.bulk_member & ~mask,
        bulk_cov=torch.where(mask, 0.0, s.bulk_cov))


def revive(s: SwimState, node: int) -> SwimState:
    """Bring one node back up after a flap (revive_mask of one node)."""
    n = s.up.shape[0]
    return revive_mask(s, torch.arange(n, device=s.device) == node)


def inject_suspicion(params: SwimParams, s: SwimState, subject: int,
                     origin: int) -> SwimState:
    """Testing hook (swim.py:1698-1704): `origin` suspects `subject` now.
    On the card it consumes s (K8 updates its tensors in place)."""
    n, dev = params.n_nodes, s.device
    row_subject = torch.where(torch.arange(n, device=dev) == origin, subject,
                              -1).to(I32)
    return _originate(params, s, _one(n, subject, dev), SUSPECT,
                      s.incarnation, row_subject)[0]


def leave(params: SwimParams, s: SwimState, node: int) -> SwimState:
    """Graceful leave (swim.py:1689-1695): the node originates its `left`
    rumor, then stops being a member.  On the card it consumes s (K8
    updates its tensors in place)."""
    n, dev = params.n_nodes, s.device
    s, _ = _originate(params, s, _one(n, node, dev), LEFT, s.incarnation,
                      _own_row(n, node, dev))
    return s.replace(member=_set(s.member, node, False))


# the probe tick, metrics and commands of a node-sharded pool
from consul_tpu_torch.models import swim_blocks  # noqa: E402
