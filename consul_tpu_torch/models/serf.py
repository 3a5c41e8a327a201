"""The Serf layer: SWIM membership + Vivaldi coordinates + user events in
one cluster step (the port of consul_tpu/models/serf.py:28-164).

Each tick advances failure detection and dissemination (models/swim.py),
feeds the round's direct probe acks to the coordinate solver on probe
ticks (serf's update-on-probe-ack coupling), and advances user events
with the tick's new up/member vectors.  The oracle's reads over the pool
(status, counts, page, delta, per-shard gauges, RTT order) close the
module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import events, swim, vivaldi
from consul_tpu_torch.parallel.mesh import Blocks, BulkChannelLive, Replicated
from consul_tpu_torch.utils import devices


@dataclasses.dataclass(frozen=True)
class SerfParams:
    swim: swim.SwimParams
    vivaldi: vivaldi.VivaldiParams
    events: events.EventParams

    @property
    def n_nodes(self) -> int:
        return self.swim.n_nodes


def make_params(gossip: Optional[GossipConfig] = None,
                sim: Optional[SimConfig] = None,
                coord_dims: int = 8, event_slots: int = 32) -> SerfParams:
    gossip = gossip or GossipConfig.lan()
    sim = sim or SimConfig()
    return SerfParams(
        swim=swim.make_params(gossip, sim),
        vivaldi=vivaldi.VivaldiParams(n_nodes=sim.n_nodes, dims=coord_dims,
                                      seed=sim.seed),
        events=events.make_params(gossip, sim, event_slots),
    )


@dataclasses.dataclass(frozen=True)
class ClusterState:
    swim: swim.SwimState
    coords: vivaldi.VivaldiState
    events: events.EventState

    def replace(self, **kw) -> "ClusterState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "ClusterState":
        """A copy whose every tensor is its own (step and run consume the
        state they are given on the card)."""
        return ClusterState(swim=self.swim.clone(),
                            coords=_cloned(self.coords),
                            events=_cloned(self.events))


def _cloned(x):
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), (torch.Tensor, Blocks, Replicated))})


def init_state(params: SerfParams, key=None, n_initial: int = 0,
               device=None) -> ClusterState:
    """Fresh pool on `device`: the card unless the caller names one."""
    device = devices.resolve(device)
    return ClusterState(
        swim=swim.init_state(params.swim, key, n_initial=n_initial,
                             device=device),
        coords=vivaldi.init_state(params.vivaldi, device=device),
        events=events.init_state(params.events, device=device))


def step(params: SerfParams, s: ClusterState) -> ClusterState:
    """One gossip tick of the full serf pool.  On the card a probe tick
    consumes s (swim.step_with_obs): keep s.clone() to read it again.  A
    node-sharded pool (parallel/mesh.shard_state) runs every tick until
    its bulk channel goes live; then BulkChannelLive carries the
    pool the refusal leaves (swim.step_with_obs)."""
    try:
        sw, obs = swim.step_with_obs(params.swim, s.swim)
    except BulkChannelLive as e:
        raise BulkChannelLive(str(e), ClusterState(
            swim=e.state, coords=s.coords, events=s.events)) from None
    coords = s.coords
    if obs is not None:
        coords = vivaldi.observe_ring(params.vivaldi, coords, obs.shift,
                                      obs.rtt_ms, obs.acked)
    ev = events.step(params.events, s.events, up=sw.up, member=sw.member)
    return ClusterState(swim=sw, coords=coords, events=ev)


def run(params: SerfParams, s: ClusterState, n_ticks: int,
        monitor_subject: Optional[int] = None):
    """`n_ticks` steps; with a monitor subject, its believed-down fraction
    after every tick in one [n_ticks] float32 device vector.  On the card
    it consumes s (step)."""
    fr = torch.zeros(n_ticks, dtype=torch.float32, device=s.swim.device)
    for t in range(n_ticks):
        s = step(params, s)
        if monitor_subject is not None:
            swim.believed_down_fraction(params.swim, s.swim, monitor_subject,
                                        out=fr[t:t + 1])
    return s, fr


def metrics_vector(params: SerfParams, s: ClusterState) -> torch.Tensor:
    """Device-side telemetry for the pool (swim.METRIC_NAMES order)."""
    return swim.metrics_vector(params.swim, s.swim)


def status_vector(params: SerfParams, s: ClusterState) -> torch.Tensor:
    """[N] int8 member status (swim.STATUS_*), on the device."""
    return swim.status_vector(params.swim, s.swim)


def shard_metrics(params: SerfParams, s: ClusterState,
                  n_blocks: int) -> torch.Tensor:
    """[B, 4] per-shard gauges (swim.SHARD_METRIC_NAMES order)."""
    return swim.shard_metrics(params.swim, s.swim, n_blocks)


def membership_counts(params: SerfParams, s: ClusterState,
                      provisioned: torch.Tensor) -> torch.Tensor:
    return swim.membership_counts(params.swim, s.swim, provisioned)


def membership_page(params: SerfParams, s: ClusterState, ids: torch.Tensor):
    return swim.membership_page(params.swim, s.swim, ids)


def membership_delta(params: SerfParams, s: ClusterState,
                     prev_status: torch.Tensor, provisioned: torch.Tensor,
                     k: int):
    return swim.membership_delta(params.swim, s.swim, prev_status,
                                 provisioned, k)


def rtt_order(params: SerfParams, s: ClusterState, origin,
              ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """?near= ordering (agent/consul/rtt.go:196, lib/rtt.go:13-43): the
    estimated RTT from `origin` to each of the [K] `ids`, padding rows
    (`valid` False) at +inf, and the stable argsort of those [K] distances
    as int32 (serf.py:120-145).  The JAX package computes the distance of
    every node so a node-sharded mesh never gathers a row; one device
    computes the K query rows alone, with the same arithmetic per row."""
    c = s.coords
    o = torch.as_tensor(origin, dtype=torch.int64, device=ids.device)
    at = ids.to(torch.int64)
    if isinstance(c.coords, Blocks):    # the K rows read block by block
        rows = lambda x, i: swim._gather_rows(x, i.reshape(-1))  # noqa: E731
    else:
        rows = lambda x, i: x[i]  # noqa: E731
    d = vivaldi._norm(rows(c.coords, at) - rows(c.coords, o)) \
        + rows(c.height, at) + rows(c.height, o)
    adjusted = d + rows(c.adjustment, at) + rows(c.adjustment, o)
    dist = torch.where(adjusted > 0.0, adjusted, d)
    dist = torch.where(valid, dist, torch.inf)
    return torch.sort(dist, stable=True).indices.to(torch.int32)


def fire_event(params: SerfParams, s: ClusterState, origin: int,
               event_id: int) -> ClusterState:
    """Fire a user event (reference agent/user_event.go:23 UserEvent)."""
    return s.replace(events=events.fire(params.events, s.events, origin,
                                        event_id))
