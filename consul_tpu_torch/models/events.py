"""Lamport-clocked user-event broadcast with dedup — serf's event layer
(the port of consul_tpu/models/events.py).

A per-node Lamport clock, an E-slot table of in-flight events and an
[N, E] knowledge matrix riding the shared gossip pass (ops/gossip.py,
kernel K2 on the card).  JAX skips the whole tick with
lax.cond(any(e_active)); here `fire` is a host command and expiry
depends only on the tick, so the state mirrors which slots are active
(and since when) on the host and the skip needs no device read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.ops import gossip as gossip_ops
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.parallel.mesh import Blocks
from consul_tpu_torch.utils import devices, prng

I8, I32 = torch.int8, torch.int32


@dataclasses.dataclass(frozen=True)
class EventParams:
    n_nodes: int
    event_slots: int = 32
    gossip_nodes: int = 3
    retransmit_limit: int = 16
    expiry_ticks: int = 64
    p_loss: float = 0.0
    seed: int = 0


def make_params(gossip: GossipConfig, sim: SimConfig,
                event_slots: int = 32) -> EventParams:
    spread = max(8, 4 * math.ceil(math.log2(sim.n_nodes + 1)))
    return EventParams(
        n_nodes=sim.n_nodes,
        p_loss=sim.p_loss,
        event_slots=event_slots,
        gossip_nodes=gossip.gossip_nodes,
        retransmit_limit=gossip.retransmit_limit(sim.n_nodes),
        expiry_ticks=spread,
        seed=sim.seed ^ 0xE7E7,
    )


@dataclasses.dataclass(frozen=True)
class EventState:
    tick: int                  # host mirror of the int32 tick
    lamport: torch.Tensor      # [N] int32
    e_active: torch.Tensor     # [E] bool
    e_id: torch.Tensor         # [E] int32
    e_ltime: torch.Tensor      # [E] int32
    e_origin: torch.Tensor     # [E] int32
    e_start: torch.Tensor      # [E] int32
    know: torch.Tensor         # [N, E] bool
    deliver_tick: torch.Tensor  # [N, E] int32
    sends_left: torch.Tensor   # [N, E] int8
    # host mirrors of e_active / e_start (fire and expiry are host facts)
    active_host: Tuple[bool, ...] = ()
    start_host: Tuple[int, ...] = ()

    def replace(self, **kw) -> "EventState":
        return dataclasses.replace(self, **kw)


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(EventState)
                      if f.name not in ("tick", "active_host", "start_host"))


def init_state(params: EventParams, device=None) -> EventState:
    device = devices.resolve(device)
    n, e = params.n_nodes, params.event_slots

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EventState(
        tick=0, lamport=z(n, I32), e_active=z(e, torch.bool),
        e_id=z(e, I32), e_ltime=z(e, I32), e_origin=z(e, I32),
        e_start=z(e, I32), know=z((n, e), torch.bool),
        deliver_tick=torch.full((n, e), -1, dtype=I32, device=device),
        sends_left=z((n, e), I8),
        active_host=(False,) * e, start_host=(0,) * e)


def fire_slot(s: EventState) -> int:
    """The slot `fire` takes, from the host mirrors: the lowest free one,
    else the first with the largest start tick."""
    if not all(s.active_host):
        return s.active_host.index(False)
    return max(range(len(s.active_host)),
               key=lambda j: (s.start_host[j], -j))


def fire(params: EventParams, s: EventState, origin: int,
         event_id: int) -> EventState:
    """Fire a user event from `origin` (agent/user_event.go:23): the
    lowest free slot, else the slot the reference recycles (the first
    with the largest start tick among the active ones)."""
    e = params.event_slots
    dev = s.know.device
    slot = fire_slot(s)
    lamport = s.lamport.clone()
    ltime = lamport[origin] + 1
    lamport[origin] = ltime
    onehot = torch.arange(e, device=dev) == slot
    origin_row = torch.arange(params.n_nodes, device=dev) == origin
    cell = origin_row[:, None] & onehot[None, :]
    limit = min(params.retransmit_limit, 127)
    active_host = tuple(a or j == slot for j, a in enumerate(s.active_host))
    start_host = tuple(s.tick if j == slot else t
                       for j, t in enumerate(s.start_host))
    return s.replace(
        lamport=lamport,
        e_active=s.e_active | onehot,
        e_id=torch.where(onehot, event_id, s.e_id),
        e_ltime=torch.where(onehot, ltime, s.e_ltime),
        e_origin=torch.where(onehot, origin, s.e_origin),
        e_start=torch.where(onehot, s.tick, s.e_start),
        know=torch.where(onehot[None, :], cell, s.know),
        deliver_tick=torch.where(onehot[None, :],
                                 torch.where(cell, s.tick, -1).to(I32),
                                 s.deliver_tick),
        sends_left=torch.where(onehot[None, :],
                               torch.where(cell, limit, 0).to(I8),
                               s.sends_left),
        active_host=active_host, start_host=start_host)


def step(params: EventParams, s: EventState, up: torch.Tensor,
         member: torch.Tensor) -> EventState:
    """One gossip tick of event dissemination between live members; only
    the tick moves when no event is in flight."""
    if not any(s.active_host):
        return s.replace(tick=s.tick + 1)
    if isinstance(s.know, Blocks):
        return _step_blocks(params, s, up, member)
    n = params.n_nodes
    dev = s.know.device
    offs = rolls.offsets(prng.tick_key(params.seed, s.tick, 3), n,
                         params.gossip_nodes, dev)
    res = gossip_ops.disseminate(offs, s.know, s.sends_left,
                                 sender_ok=up, receiver_ok=up & member,
                                 slot_active=s.e_active,
                                 retransmit_limit=min(params.retransmit_limit,
                                                      127),
                                 p_loss=params.p_loss,
                                 key=prng.tick_key(params.seed, s.tick, 6))
    deliver_tick = torch.where(res.newly, s.tick, s.deliver_tick)
    seen = torch.where(res.newly, s.e_ltime[None, :], 0)
    lamport = torch.maximum(s.lamport, seen.amax(1))
    done = s.e_active & (s.tick - s.e_start >= params.expiry_ticks)
    done_host = tuple(a and s.tick - t >= params.expiry_ticks
                      for a, t in zip(s.active_host, s.start_host))
    return s.replace(
        tick=s.tick + 1,
        lamport=lamport,
        e_active=s.e_active & ~done,
        know=res.know & ~done[None, :],
        deliver_tick=deliver_tick,
        sends_left=torch.where(done[None, :], 0, res.sends_left).to(I8),
        active_host=tuple(a and not d for a, d in zip(s.active_host,
                                                      done_host)))


def _step_blocks(params: EventParams, s: EventState, up: Blocks,
                 member: Blocks) -> EventState:
    """step on a node-sharded pool (parallel/mesh.py): K2 over the blocks,
    then its row-local passes block by block, the [E] table copy by
    copy."""
    from consul_tpu_torch.models.swim import tick_offsets
    offs = tick_offsets(prng.tick_key(params.seed, s.tick, 3),
                        params.n_nodes, params.gossip_nodes, s.know)
    res = gossip_ops.disseminate(offs, s.know, s.sends_left,
                                 sender_ok=up,
                                 receiver_ok=up.map(torch.logical_and, member),
                                 slot_active=s.e_active,
                                 retransmit_limit=min(params.retransmit_limit,
                                                      127),
                                 p_loss=params.p_loss,
                                 key=prng.tick_key(params.seed, s.tick, 6))
    tick = s.tick
    done = s.e_active.map(lambda a, st: a & (tick - st >= params.expiry_ticks),
                          s.e_start)
    done_host = tuple(a and tick - t >= params.expiry_ticks
                      for a, t in zip(s.active_host, s.start_host))

    def lamport(lam, newly, ltime):
        seen = torch.where(newly, ltime[None, :], 0)
        return torch.maximum(lam, seen.amax(1))

    return s.replace(
        tick=tick + 1,
        lamport=s.lamport.map(lamport, res.newly, s.e_ltime),
        e_active=s.e_active.map(lambda a, d: a & ~d, done),
        know=res.know.map(lambda k, d: k & ~d[None, :], done),
        deliver_tick=s.deliver_tick.map(
            lambda dt, newly: torch.where(newly, tick, dt), res.newly),
        sends_left=res.sends_left.map(
            lambda sl, d: torch.where(d[None, :], 0, sl).to(I8), done),
        active_host=tuple(a and not d for a, d in zip(s.active_host,
                                                      done_host)))


def coverage(params: EventParams, s: EventState, slot: int,
             up: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Fraction of live members that have ever received event `slot`."""
    alive = up & member
    got = (s.deliver_tick[:, slot] >= 0) & alive
    return got.sum().to(torch.float32) / alive.sum().clamp_min(1).to(torch.float32)
