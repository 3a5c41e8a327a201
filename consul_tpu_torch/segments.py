"""Network segments: LAN gossip sharded into isolated pools (the port of
consul_tpu/segments.py).

The reference shards the LAN gossip plane into network segments: each
segment is its own serf pool, clients join exactly one, servers join all
of them and bridge (agent/consul/segment_oss.go, server.go:254-258,
flood.go:12-27).  Failure detection and event dissemination stay
segment-local.  Here each segment is one port `GossipOracle` on the same
device, and `SegmentedOracle` presents the combined membership as one
oracle-shaped surface; `?segment=` filters where the reference filters.

The default segment's name is "" (the reference's `<default>`); user
events fire into every segment, as servers re-broadcast them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from consul_tpu_torch import host
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.oracle import GossipOracle

DEFAULT_SEGMENT = ""


class SegmentedOracle:
    """Oracle-shaped facade over one GossipOracle per segment, each on
    `device` with `hooks`."""

    def __init__(self, segments: Dict[str, Tuple[GossipConfig,
                                                 SimConfig]],
                 device=None, hooks: Optional[host.Hooks] = None):
        if not segments:
            raise ValueError("at least one segment required")
        self.hooks = hooks or host.Hooks()
        self.pools: Dict[str, GossipOracle] = {}
        for seg, (gossip, sim) in segments.items():
            prefix = f"{seg}-node" if seg else "node"
            self.pools[seg] = GossipOracle(gossip, sim, node_prefix=prefix,
                                           device=device, hooks=self.hooks)

    # ------------------------------------------------------------ lifecycle

    def start(self, tick_seconds: float = 0.0) -> None:
        for p in self.pools.values():
            p.start(tick_seconds)

    def stop(self) -> None:
        for p in self.pools.values():
            p.stop()

    def advance(self, n_ticks: int = 1) -> None:
        for p in self.pools.values():
            p.advance(n_ticks)

    # ------------------------------------------------------------- identity

    def segments(self) -> List[str]:
        return sorted(self.pools)

    def _pool_of(self, name: str) -> Tuple[str, GossipOracle]:
        for seg, p in self.pools.items():
            if name in p._ids:
                return seg, p
        raise KeyError(name)

    def node_id(self, name: str) -> int:
        return self._pool_of(name)[1].node_id(name)

    # ----------------------------------------------------------- membership

    def members(self, limit: Optional[int] = None, offset: int = 0,
                segment: Optional[str] = None) -> List[dict]:
        """Combined member list; `segment` restricts to one pool (the
        reference's ?segment= filter / members -segment).  Pagination
        spans pools in sorted-segment order."""
        order = sorted(self.pools)
        if segment is not None:
            if segment not in self.pools:
                raise KeyError(f"unknown segment {segment!r}")
            ns = order.index(segment)
            rows = self.pools[segment].members(limit=limit,
                                               offset=offset)
            return [dict(r, segment=segment, addr_ns=ns) for r in rows]
        out: List[dict] = []
        remaining_offset = max(0, offset)
        budget = limit
        for ns, seg in enumerate(order):
            p = self.pools[seg]
            # provisioned count, not slot count: sparse pools list only
            # members that ever joined, and page math must match
            n = p.provisioned_count
            if remaining_offset >= n:
                remaining_offset -= n
                continue
            rows = p.members(limit=budget, offset=remaining_offset)
            # addr_ns namespaces the synthetic member address: per-pool
            # ids restart at 0, so without it node0 and alpha-node0
            # would collide on the same Addr
            out += [dict(r, segment=seg, addr_ns=ns) for r in rows]
            remaining_offset = 0
            if budget is not None:
                budget -= len(rows)
                if budget <= 0:
                    break
        return out

    def members_summary(self) -> Dict[str, int]:
        total: Dict[str, int] = {"alive": 0, "failed": 0, "left": 0,
                                 "total": 0}
        for p in self.pools.values():
            for k, v in p.members_summary().items():
                total[k] = total.get(k, 0) + v
        return total

    def members_delta(self, max_changes: int = 256) -> dict:
        """Changed members since the last delta checkpoint across every
        segment pool (GossipOracle.members_delta — the gather-free
        incremental read): `changed` rows are (segment, id, status)."""
        out = {"count": 0, "changed": [], "truncated": False}
        for seg in sorted(self.pools):
            d = self.pools[seg].members_delta(max_changes)
            out["count"] += d["count"]
            out["changed"] += [(seg, i, st) for i, st in d["changed"]]
            out["truncated"] = out["truncated"] or d["truncated"]
        return out

    def journal_flaps(self, max_changes: int = 256) -> int:
        """Flight-recorder flap feed across every segment pool
        (GossipOracle.journal_flaps — O(flaps) rows per pool)."""
        return sum(p.journal_flaps(max_changes)
                   for p in self.pools.values())

    def publish_sim_metrics(self, registry=None) -> Dict[str, float]:
        """Per-segment consul.serf.* gauges, labeled {segment=…} (the
        reference reports serf metrics per LAN segment pool), plus
        each pool's flap journal feeding the flight recorder.  Returns
        the LAST pool's raw metrics dict for API parity."""
        reg = registry or self.hooks.registry()
        m: Dict[str, float] = {}
        for seg in sorted(self.pools):
            p = self.pools[seg]
            m = p.sim_metrics()
            for name, v in m.items():
                reg.set_gauge(("serf",) + tuple(name.split(".")), v,
                              labels={"segment": seg or "default"})
            p.journal_flaps()
        return m

    def status(self, name: str) -> str:
        return self._pool_of(name)[1].status(name)

    def believed_down_fraction(self, name: str) -> float:
        return self._pool_of(name)[1].believed_down_fraction(name)

    def kill(self, name: str) -> None:
        self._pool_of(name)[1].kill(name)

    def revive(self, name: str) -> None:
        self._pool_of(name)[1].revive(name)

    def leave(self, name: str) -> None:
        self._pool_of(name)[1].leave(name)

    # ---------------------------------------------------------- coordinates
    # Coordinates are per-segment planes (lib/rtt.go CoordinateSet keyed
    # by segment): cross-segment distances are undefined.

    def coordinate(self, name: str) -> dict:
        seg, p = self._pool_of(name)
        return dict(p.coordinate(name), segment=seg)

    def rtt(self, a: str, b: str) -> float:
        seg_a, pa = self._pool_of(a)
        seg_b, _ = self._pool_of(b)
        if seg_a != seg_b:
            raise KeyError(
                f"nodes {a!r}/{b!r} are in different segments "
                f"({seg_a!r} vs {seg_b!r}): no shared coordinate plane")
        return pa.rtt(a, b)

    def sort_by_rtt(self, origin: str, names: List[str]) -> List[str]:
        """Same-segment names sort by coordinate distance; foreign-
        segment names keep their order at the tail (Intersect returns
        zero distance only for comparable planes)."""
        try:
            seg, pool = self._pool_of(origin)
        except KeyError:
            return list(names)
        local = [n for n in names if n in pool._ids]
        foreign = [n for n in names if n not in pool._ids]
        return pool.sort_by_rtt(origin, local) + foreign

    # --------------------------------------------------------------- events

    def fire_event(self, name: str, payload: bytes, origin: str) -> str:
        """User events reach every segment (servers re-broadcast across
        the pools they bridge)."""
        ids = []
        for seg in sorted(self.pools):
            p = self.pools[seg]
            org = origin if origin in p._ids else \
                p.node_name(0)
            ids.append(p.fire_event(name, payload, origin=org))
        return ids[0] if ids else "0"

    def event_list(self) -> List[dict]:
        # the default segment's ring is authoritative for listing (every
        # event was fired into all pools)
        first = sorted(self.pools)[0]
        return self.pools[first].event_list()

    def event_coverage(self, event_id) -> float:
        vals = [p.event_coverage(event_id) for p in self.pools.values()]
        return min(vals) if vals else 0.0

    # -------------------------------------------------------------- keyring
    # one keyring for the whole cluster (keyring ops broadcast to every
    # segment pool, agent/keyring.go)

    def keyring_list(self) -> dict:
        first = sorted(self.pools)[0]
        out = self.pools[first].keyring_list()
        out["NumNodes"] = self.n_nodes
        return out

    def keyring_install(self, key: str) -> None:
        for p in self.pools.values():
            p.keyring_install(key)

    def keyring_use(self, key: str) -> None:
        for p in self.pools.values():
            p.keyring_use(key)

    def keyring_remove(self, key: str) -> None:
        for p in self.pools.values():
            p.keyring_remove(key)

    # ----------------------------------------------------------------- misc

    @property
    def tick(self) -> int:
        return max(p.tick for p in self.pools.values())

    @property
    def n_nodes(self) -> int:
        return sum(p.n_nodes for p in self.pools.values())
