"""Gossip tuning surface and simulation config (the port's own copy).

The tunables mirror Consul's `gossip_lan` / `gossip_wan` blocks
(reference: agent/config/default.go:70-84) with the documented defaults
(reference: website/content/docs/agent/options.mdx:1498-1574):

  LAN: gossip 200ms to 3 nodes, probe 1s / timeout 500ms,
       suspicion_mult 4, retransmit_mult 4
  WAN: gossip 500ms to 4 nodes, probe 5s / timeout 3s, suspicion_mult 6

The simulator discretizes time into ticks of one gossip interval; probes
fire every `probe_interval / gossip_interval` ticks.  Field for field and
derived value for derived value this equals `consul_tpu/config.py`
(tests/test_torch_swim.py holds the two together).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """memberlist-shaped failure-detector tuning (all seconds)."""

    probe_interval: float = 1.0
    probe_timeout: float = 0.5
    gossip_interval: float = 0.2
    gossip_nodes: int = 3
    indirect_checks: int = 3
    suspicion_mult: int = 4
    suspicion_max_timeout_mult: int = 6
    retransmit_mult: int = 4
    # piggyback packet capacity (memberlist UDPBufferSize=1400; an encoded
    # suspect/dead message plus compound-message framing is ~40 bytes)
    udp_packet_bytes: int = 1400
    gossip_msg_bytes: int = 40
    # Lifeguard Local Health Awareness: probe interval and timeout stretch
    # by (health score + 1); 0 disables (memberlist AwarenessMaxMultiplier)
    awareness_max_multiplier: int = 8

    @classmethod
    def lan(cls) -> "GossipConfig":
        return cls()

    @classmethod
    def wan(cls) -> "GossipConfig":
        return cls(
            probe_interval=5.0,
            probe_timeout=3.0,
            gossip_interval=0.5,
            gossip_nodes=4,
            suspicion_mult=6,
        )

    @property
    def probe_period_ticks(self) -> int:
        return max(1, round(self.probe_interval / self.gossip_interval))

    def retransmit_limit(self, n: int) -> int:
        """memberlist's retransmitLimit: mult * ceil(log10(n + 1))."""
        return self.retransmit_mult * max(1, math.ceil(math.log10(n + 1)))

    def suspicion_min_ticks(self, n: int) -> int:
        """Lifeguard min suspicion timeout, in gossip ticks.

        memberlist: suspicionTimeout = mult * max(1, log10(n)) * probe_interval.
        """
        node_scale = max(1.0, math.log10(max(1, n)))
        return max(1, math.ceil(self.suspicion_mult * node_scale * self.probe_period_ticks))

    def suspicion_max_ticks(self, n: int) -> int:
        return self.suspicion_max_timeout_mult * self.suspicion_min_ticks(n)

    def confirm_k(self) -> int:
        """Expected independent suspicion confirmations (Lifeguard)."""
        return max(1, self.suspicion_mult - 2)

    def packet_msgs(self) -> int:
        """Distinct piggybacked gossip messages per UDP packet."""
        return max(1, self.udp_packet_bytes // self.gossip_msg_bytes)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulator sizing + environment model (static)."""

    n_nodes: int = 1024
    n_initial: int = 0             # members at t=0 (0 = all N)
    rumor_slots: int = 32          # U: max concurrently-active rumors
    alloc_cap: int = 8             # max new rumors allocated per tick per kind
    p_loss: float = 0.01           # per-leg UDP message loss probability
    # locally-degraded nodes (Lifeguard's motivating scenario): a
    # deterministic `degraded_frac` of nodes lose each of their OWN legs
    # with `degraded_loss` instead of p_loss
    degraded_frac: float = 0.0
    degraded_loss: float = 0.0
    rtt_base_ms: float = 0.5       # min one-way latency
    rtt_spread_ms: float = 30.0    # scale of the coordinate space (ms)
    coord_dims: int = 2            # ground-truth latency-space dims
    seed: int = 0
    # node-axis shard count: the per-shard gauges' blocks; the port runs
    # every block on one device (ops/rolls.py)
    shard_blocks: int = 1
    # nemesis hooks; the port's first slice runs without them
    chaos: bool = False
