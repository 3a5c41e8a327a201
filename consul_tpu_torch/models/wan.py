"""Multi-datacenter federation: per-DC LAN pools and one WAN server pool
(the port of consul_tpu/models/wan.py).

Consul's cross-DC architecture: every DC runs its own LAN gossip pool of
all its agents; the servers of all DCs also join one WAN pool with slower
timers (reference agent/consul/server_serf.go:36-185 with the
`gossip_wan` defaults; flood.go:12-27 floods LAN servers into the WAN;
router.go:534 ranks DCs by WAN coordinates).  User events cross DCs
through the servers: an event fired in DC d spreads over d's LAN, reaches
a server, crosses the WAN pool, and each remote server re-fires it into
its own LAN (at most one inject per DC per tick in each direction).

Node numbering: LAN node ids 0..S-1 of each DC are its servers; WAN node
id = dc * S + server index.

The JAX package vmaps one serf step over a [D, ...] batch of LAN pools.
Here the D pools are D port `ClusterState`s stepped in a Python loop (a
serf step chooses its probe branch from a host tick, reads one flag per
probe tick and launches ctypes kernels, none of which vmaps); every DC
draws the same tick streams, and only `init_state` gives each DC its own
key.  The bridge's decisions are host work on small tables: when no LAN
or WAN event slot is active (the events layer's host mirrors say so) no
candidate can exist and the bridge reads nothing; otherwise it reads the
servers' knowledge and the event ids back in one copy (`host_syncs`
counts them), runs the reference's two loops on the host and fires
through `events.fire` with host ints, so the events layer's mirrors stay
exact.  The bridged-id rings are host state.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import events, serf, vivaldi
from consul_tpu_torch.utils import devices, prng

# the bridge's device-to-host reads (one per tick with an active event slot)
host_syncs = 0


@dataclasses.dataclass(frozen=True)
class WanParams:
    n_dcs: int
    servers_per_dc: int
    lan: serf.SerfParams        # per-DC pool (the same shape in each DC)
    wan: serf.SerfParams        # pool of n_dcs * servers_per_dc servers


def make_params(n_dcs: int = 3, nodes_per_dc: int = 1024,
                servers_per_dc: int = 5, p_loss: float = 0.01,
                seed: int = 0, rumor_slots: int = 16,
                event_slots: int = 16,
                shard_blocks: int = 1) -> WanParams:
    lan = serf.make_params(
        GossipConfig.lan(),
        SimConfig(n_nodes=nodes_per_dc, rumor_slots=rumor_slots,
                  p_loss=p_loss, seed=seed, shard_blocks=shard_blocks),
        event_slots=event_slots)
    wan = serf.make_params(
        GossipConfig.wan(),
        SimConfig(n_nodes=n_dcs * servers_per_dc, rumor_slots=rumor_slots,
                  p_loss=p_loss, seed=seed ^ 0xBAD5EED),
        event_slots=event_slots)
    return WanParams(n_dcs=n_dcs, servers_per_dc=servers_per_dc,
                     lan=lan, wan=wan)


BRIDGE_RING = 4                 # x event_slots: per-DC bridged-id memory


@dataclasses.dataclass(frozen=True)
class WanState:
    lan: Tuple[serf.ClusterState, ...]   # one pool per DC
    wan: serf.ClusterState               # the WAN server pool
    bridged: Tuple[Tuple[int, ...], ...]  # [D][B] ids already bridged (-1 empty)
    bridged_ptr: Tuple[int, ...]          # [D] ring cursors

    def replace(self, **kw) -> "WanState":
        return dataclasses.replace(self, **kw)


def init_state(params: WanParams, device=None) -> WanState:
    """Fresh federation on `device` (the card unless the caller names
    one): DC d's LAN pool from split(PRNGKey(seed ^ 0xD0), D)[d]."""
    device = devices.resolve(device)
    keys = prng.split(prng.PRNGKey(params.lan.swim.seed ^ 0xD0),
                      params.n_dcs)
    b = BRIDGE_RING * params.lan.events.event_slots
    return WanState(
        lan=tuple(serf.init_state(params.lan, k, device=device)
                  for k in keys),
        wan=serf.init_state(params.wan, device=device),
        bridged=((-1,) * b,) * params.n_dcs,
        bridged_ptr=(0,) * params.n_dcs)


def _active_ids(active, ids) -> List[int]:
    """Active slots' ids, -1 for inactive slots (0 is a valid event id)."""
    return [i if a else -1 for a, i in zip(active, ids)]


def _first_active_candidate(active, known, ids, other_ids, seen):
    """(found, slot): the first active event known to a bridge node whose
    id is neither in the destination's active slots nor in this DC's
    bridged-id ring (the ring stops an event from ping-ponging between
    pools whose slots expire on different schedules); slot 0 when none."""
    other, seen = set(other_ids), set(seen)
    for j, (a, k, i) in enumerate(zip(active, known, ids)):
        if a and k and i not in other and i not in seen:
            return True, j
    return False, 0


def _ring_push(row, ptr: int, value: int):
    row = list(row)
    row[ptr % len(row)] = value
    return tuple(row), ptr + 1


def step(params: WanParams, s: WanState) -> WanState:
    """One gossip tick of the whole federation: every LAN pool and the WAN
    pool step (the WAN config's 10-tick probe period against the LAN's
    5 keeps the relative cadence), then the event bridge.  On the card it
    consumes s (serf.step)."""
    s = s.replace(lan=tuple(serf.step(params.lan, c) for c in s.lan),
                  wan=serf.step(params.wan, s.wan))
    return _bridge_events(params, s)


def _read_bridge_tables(params: WanParams, s: WanState):
    """The bridge's small device inputs in one device-to-host copy: per DC
    which slots some server knows and which servers know any slot, the
    WAN pool's knowledge, and every event id table."""
    global host_syncs
    d, sp = params.n_dcs, params.servers_per_dc
    e_lan = params.lan.events.event_slots
    e_wan = params.wan.events.event_slots
    srv = [c.events.know[:sp] for c in s.lan]
    parts = [torch.stack([k.any(0) for k in srv]).flatten(),
             torch.stack([k.any(1) for k in srv]).flatten(),
             s.wan.events.know.flatten()]
    flat = torch.cat([p.to(torch.int32) for p in parts]
                     + [c.events.e_id for c in s.lan] + [s.wan.events.e_id])
    host = flat.cpu().tolist()
    host_syncs += 1
    at = 0

    def take(n):
        nonlocal at
        out = host[at:at + n]
        at += n
        return out

    served = [[bool(v) for v in take(e_lan)] for _ in range(d)]
    srv_any = [[bool(v) for v in take(sp)] for _ in range(d)]
    wan_know = [[bool(v) for v in take(e_wan)] for _ in range(d * sp)]
    lan_eid = [take(e_lan) for _ in range(d)]
    wan_eid = take(e_wan)
    return served, srv_any, wan_know, lan_eid, wan_eid


def _first_true(row) -> int:
    """argmax of a bool row: the first True, 0 when none."""
    return next((i for i, v in enumerate(row) if v), 0)


def _bridge_events(params: WanParams, s: WanState) -> WanState:
    """wan.py:133-205 with the decisions on the host, in the reference's
    order: each LAN -> WAN injection changes the WAN candidate set the
    next DC checks, and the ring pushes interleave with both loops."""
    if not any(s.wan.events.active_host) and \
            not any(any(c.events.active_host) for c in s.lan):
        return s            # no active slot anywhere: no candidate exists
    d, sp = params.n_dcs, params.servers_per_dc
    served, srv_any, wan_know, lan_eid, wan_eid = \
        _read_bridge_tables(params, s)
    bridged, ptrs = list(s.bridged), list(s.bridged_ptr)
    wan_ev = s.wan.events

    # LAN -> WAN: a server that knows a local event injects it
    for dc in range(d):
        lan_active = s.lan[dc].events.active_host
        found, slot = _first_active_candidate(
            lan_active, served[dc], lan_eid[dc],
            _active_ids(wan_ev.active_host, wan_eid), bridged[dc])
        if not found:
            continue
        eid = lan_eid[dc][slot]
        origin = dc * sp + _first_true(srv_any[dc])
        w_slot = events.fire_slot(wan_ev)
        wan_ev = events.fire(params.wan.events, wan_ev, origin, eid)
        wan_eid[w_slot] = eid
        for r, row in enumerate(wan_know):
            row[w_slot] = r == origin
        bridged[dc], ptrs[dc] = _ring_push(bridged[dc], ptrs[dc], eid)

    # WAN -> LAN: a server that knows a WAN event fires it locally
    lan = list(s.lan)
    for dc in range(d):
        mine = wan_know[dc * sp:(dc + 1) * sp]
        known_here = [any(col) for col in zip(*mine)]
        lan_ev = s.lan[dc].events
        found, slot = _first_active_candidate(
            wan_ev.active_host, known_here, wan_eid,
            _active_ids(lan_ev.active_host, lan_eid[dc]), bridged[dc])
        if not found:
            continue
        eid = wan_eid[slot]
        origin = _first_true([any(row) for row in mine])
        bridged[dc], ptrs[dc] = _ring_push(bridged[dc], ptrs[dc], eid)
        lan[dc] = lan[dc].replace(events=events.fire(params.lan.events,
                                                     lan_ev, origin, eid))
    return s.replace(lan=tuple(lan), wan=s.wan.replace(events=wan_ev),
                     bridged=tuple(bridged), bridged_ptr=tuple(ptrs))


def run(params: WanParams, s: WanState, n_ticks: int) -> WanState:
    """`n_ticks` steps (on the card it consumes s)."""
    for _ in range(n_ticks):
        s = step(params, s)
    return s


# ------------------------------------------------------------------- helpers

def fire_event(params: WanParams, s: WanState, dc: int, origin: int,
               event_id: int) -> WanState:
    """Fire a user event from LAN node `origin` of DC `dc`."""
    lan = list(s.lan)
    lan[dc] = serf.fire_event(params.lan, lan[dc], origin, event_id)
    return s.replace(lan=tuple(lan))


def event_coverage_by_dc(params: WanParams, s: WanState,
                         event_id: int) -> torch.Tensor:
    """[D] float32, on the device: the fraction of live members of each DC
    that received the event."""
    out = []
    for c in s.lan:
        ev = c.events
        hit = ((ev.e_id[None, :] == event_id) & (ev.deliver_tick >= 0)).any(1)
        alive = c.swim.up & c.swim.member
        out.append((hit & alive).sum().to(torch.float32)
                   / alive.sum().clamp_min(1).to(torch.float32))
    return torch.stack(out)


def dc_distance_matrix(params: WanParams, s: WanState) -> torch.Tensor:
    """[D, D] median server-to-server estimated RTT over the S x S pairs of
    each DC pair — the WAN-coordinate DC ranking (router.go:534), with
    vivaldi.estimate_rtt (its positivity floor included) and jnp.median's
    even-count rule."""
    d, sp = params.n_dcs, params.servers_per_dc
    n = d * sp
    dev = s.wan.coords.coords.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    dist = vivaldi.estimate_rtt(s.wan.coords, ids.repeat_interleave(n),
                                ids.repeat(n)).reshape(d, sp, d, sp)
    return vivaldi.median(dist.permute(0, 2, 1, 3).reshape(d, d, sp * sp))


def wan_kill_dc(params: WanParams, s: WanState, dc: int) -> WanState:
    """Partition a whole DC: crash its servers in the WAN pool (the other
    DCs' routers should mark it unreachable)."""
    sp = params.servers_per_dc
    sw = s.wan.swim
    ids = torch.arange(sw.up.shape[0], device=sw.up.device)
    mask = (ids >= dc * sp) & (ids < (dc + 1) * sp)
    return s.replace(wan=s.wan.replace(swim=sw.replace(up=sw.up & ~mask)))


def dc_reachable(params: WanParams, s: WanState) -> torch.Tensor:
    """[D] bool, on the device: a DC is reachable while any of its servers
    is WAN-alive in the committed view."""
    sw = s.wan.swim
    alive = sw.up & sw.member & ~sw.committed_dead
    return alive.reshape(params.n_dcs, params.servers_per_dc).any(1)
