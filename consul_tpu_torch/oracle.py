"""GossipOracle: the host-side handle on a device-resident serf pool.

The port of consul_tpu/oracle.py.  The oracle owns the `ClusterState`,
advances it (inline or from a pacer thread), applies host commands
(join, leave, kill, event fire, keyring) between ticks, and answers
member, coordinate and RTT queries: the interface the agent's HTTP
members and metrics routes, DNS `?near=`, the delegate socket, remote
exec and the server's reconcile loop read the device plane through.

Node naming: the sim is dense [0, N); the oracle maps names to ids and
tracks which ids are provisioned (joined), so a 1M-slot pool can start
sparsely populated.

Every read answers against the current state with a bounded transfer:
the membership reads run kernel K4 on the card (status, counts, page and
the changed rows of a delta), and every device-to-host copy goes through
the one `_to_host` seam.  With `mesh=` (parallel/mesh.py) the pool's node
axis is cut into one block a mesh device and every read answers against
the sharded state, moving O(k) bytes, never O(N); it advances (every
tick over the blocks, models/swim_blocks.py), warms up, kills, revives
and reads its sim metrics there too, while leave, spawn, fire_event, rtt
and event_coverage on a mesh are ROADMAP queue A item 3b-ii, as is a
live bulk channel: the advance that fills it raises, keeping the pool
its probe passes left, and every later advance raises.  Host
services (flight recorder, profiler, telemetry registry) come from the
caller as `host.Hooks`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from consul_tpu_torch import host, kernels
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import events as events_model
from consul_tpu_torch.models import serf, swim, vivaldi
from consul_tpu_torch.parallel import mesh as meshlib
from consul_tpu_torch.utils import devices


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The oracle's one device-to-host seam.  Every transfer the oracle
    makes goes through here, so the O(k)-transfer contract is testable by
    spying on this one function; callers hand it bounded pages and
    summaries, never a node-axis state leaf."""
    return x.detach().cpu().numpy()


def _bucket(k: int, n: int) -> int:
    """A page size rounded up to a power of two (min 8, capped at n), as
    the JAX oracle pads its pages: a delta's `page` and `truncated` depend
    on it.  The cap never drops below k: a query list may exceed the pool
    size (sort_by_rtt over a list with repeated names)."""
    b = 8
    while b < k:
        b *= 2
    if k <= n:
        b = min(b, max(n, 1))
    return b


def _coord_row(c: vivaldi.VivaldiState, i: int):
    """One node's Vivaldi row: (vec [D], error, adjustment, height).  The
    JAX package sums the row out of a one-hot mask so a sharded mesh
    never gathers (oracle.py:55-69); the sum adds zeros, which turns -0.0
    into 0.0 and changes nothing else, and `+ 0.0` does the same here.  A
    node-sharded state gives the row from the block that holds it."""
    if isinstance(c.coords, meshlib.Blocks):
        pick = lambda x: swim._cell(x, i)  # noqa: E731
    else:
        pick = lambda x: x[i]  # noqa: E731
    return (pick(c.coords) + 0.0, pick(c.error) + 0.0,
            pick(c.adjustment) + 0.0, pick(c.height) + 0.0)


class GossipOracle:
    """Host handle on one serf pool on `device` (the card unless the
    caller names another), with `hooks` for the host services.  With
    `mesh` (parallel/mesh.make_mesh) the pool is node-sharded over the
    mesh's devices: shard_blocks is set to the mesh's size and the first
    mesh device is the oracle's device (oracle.py:72-104)."""

    def __init__(self, gossip: Optional[GossipConfig] = None,
                 sim: Optional[SimConfig] = None,
                 node_prefix: str = "node", device=None,
                 hooks: Optional[host.Hooks] = None, mesh=None):
        self.gossip = gossip or GossipConfig.lan()
        self.sim = sim or SimConfig(n_nodes=64, rumor_slots=16)
        self.mesh = mesh
        if mesh is not None:
            if self.sim.shard_blocks != mesh.size:
                self.sim = dataclasses.replace(self.sim,
                                               shard_blocks=mesh.size)
            device = mesh.home
        self.device = devices.resolve(device)
        self.hooks = hooks or host.Hooks()
        self.params = serf.make_params(self.gossip, self.sim)
        self._state = serf.init_state(self.params,
                                      n_initial=self.sim.n_initial,
                                      device=self.device)
        if mesh is not None:
            self._state = meshlib.shard_state(self._state, mesh)
        # Readers take the lock and read the current self._state.  On the
        # card a probe tick or a command updates the state's tensors in
        # place (K7, K8), so nothing keeps a state past the lock unless it
        # clones it.
        self._lock = threading.RLock()
        self._node_prefix = node_prefix
        self._names: Dict[int, str] = {
            i: f"{node_prefix}{i}" for i in range(self.sim.n_nodes)}
        self._ids: Dict[str, int] = {v: k for k, v in self._names.items()}
        # provisioned = ids that ever joined; never-joined slots of a
        # sparse pool (n_initial < n) are no phantom "left" members
        n_init = self.sim.n_initial or self.sim.n_nodes
        self._provisioned = np.arange(self.sim.n_nodes) < n_init
        # the device mirror the counts and deltas reduce against: uploaded
        # whole only here, then one element written per spawn
        self._prov_dev = self._node_vector(torch.tensor(self._provisioned))
        # one status checkpoint per delta consumer: members_delta() and
        # the flap journal each own one, so neither eats the other's
        # changes; None until that consumer's first call
        self._status_ckpt: Optional[torch.Tensor] = None
        self._flap_ckpt: Optional[torch.Tensor] = None
        self._events: List[dict] = []           # host-side payload ring
        self._event_ring = 256                  # reference ring size
        self._event_seq = 0
        # gossip keyring (serf keyring install/use/remove/list): the sim
        # carries no ciphertext, but key lifecycle is the operator surface
        self._keyring: List[str] = []
        self._primary_key: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def _node_vector(self, x: torch.Tensor):
        """An [N] host-made vector where the pool's leaves live: on the
        device, or cut into the mesh's blocks."""
        if self.mesh is None:
            return x.to(self.device)
        return meshlib.shard_state(x, self.mesh, self.sim.n_nodes)

    def _node_fill(self, value, dtype):
        """An [N] vector of `value` made where the pool's leaves live (on a
        mesh block by block: no [N] buffer anywhere)."""
        if self.mesh is None:
            return torch.full((self.sim.n_nodes,), value, dtype=dtype,
                              device=self.device)
        ell = self.sim.n_nodes // self.mesh.size
        return meshlib.Blocks(torch.full((ell,), value, dtype=dtype, device=d)
                              for d in self.mesh.devices)

    def _unsharded(self, what: str) -> None:
        """Raise for a command or a tick on a node-sharded pool."""
        if self.mesh is not None:
            raise NotImplementedError(f"GossipOracle.{what}: "
                                      + meshlib.NOT_YET)

    # ------------------------------------------------------------ lifecycle

    def start(self, tick_seconds: float = 0.0) -> None:
        """Background pacer: one tick per `tick_seconds` of wall time (0 =
        free-running).  On the card each tick is fenced by a CUDA event
        recorded after it and waited on outside the lock, so the device
        queue holds at most one tick and readers get lock windows."""
        if self._thread is not None:
            return
        self._running = True

        def loop():
            with torch.cuda.device(self.device) \
                    if self.device.type == "cuda" else contextlib.nullcontext():
                while self._running:
                    t0 = time.time()
                    self.advance(1)
                    if self.device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
                        done.synchronize()
                    if tick_seconds > 0:
                        time.sleep(max(0.0,
                                       tick_seconds - (time.time() - t0)))
                    else:
                        time.sleep(0)   # yield: readers need lock windows

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def advance(self, n_ticks: int = 1) -> None:
        t0 = time.perf_counter()
        with self._lock:
            s = self._state
            try:
                for _ in range(n_ticks):
                    s = serf.step(self.params, s)
            except meshlib.BulkChannelLive as e:
                # the step consumed s: keep the pool it left, which every
                # later tick refuses, and tell the caller
                self._state = e.state
                raise
            self._state = s
        self.hooks.observe("oracle.advance",
                           (time.perf_counter() - t0) / max(1, n_ticks))

    def warmup(self) -> None:
        """Build the kernels and run the mutating commands, a tick and the
        metrics read once at the current pool shape, discarding results,
        so a delegate client's first request never pays the kernels' first
        build (nvcc, tens of seconds) inside its timeout.  They run on a
        clone: on the card a command or a step consumes its state.  On a
        mesh the commands it runs are the ones a mesh takes (no leave)."""
        if self.device.type == "cuda":
            kernels.library()
        with self._lock:
            s = self._state.clone()
            swim.rejoin(self.params.swim, s.swim.clone(), 0)
            if self.mesh is None:
                swim.leave(self.params.swim, s.swim.clone(), 0)
            swim.kill(s.swim, 0)
            serf.metrics_vector(self.params, s)
            serf.step(self.params, s)
        if self.device.type == "cuda":
            for d in (self.mesh.distinct if self.mesh is not None
                      else (self.device,)):
                torch.cuda.synchronize(d)
        # the paged read and the summary are every client's first reads
        try:
            self.members(limit=1)
            self.members_summary()
        except Exception:
            pass

    # ------------------------------------------------------------- identity

    def node_id(self, name: str) -> int:
        """A provisioned member's id; the default names of never-joined
        slots do not resolve (listings hide them, so lookups must too)."""
        i = self._ids[name]
        if not self._provisioned[i]:
            raise KeyError(name)
        return i

    def node_name(self, node_id: int) -> str:
        return self._names.get(node_id, f"{self._node_prefix}{node_id}")

    # ----------------------------------------------------------- membership

    _STATUS_NAMES = ("alive", "failed", "left")

    def _page(self, ids: np.ndarray):
        """(status, incarnation, up) rows for `ids`, padded to a
        power-of-two bucket; transfers O(len(ids)), never O(N)."""
        k = len(ids)
        padded = np.zeros(_bucket(k, self.sim.n_nodes), np.int32)
        padded[:k] = ids
        at = torch.from_numpy(padded).to(self.device)
        with self._lock:
            st, inc, up = serf.membership_page(self.params, self._state, at)
        return _to_host(st)[:k], _to_host(inc)[:k], _to_host(up)[:k]

    def members(self, limit: Optional[int] = None,
                offset: int = 0) -> List[dict]:
        """Serf member list with statuses (alive/failed/left), paged: only
        the requested rows are read on the device and transferred."""
        ids = np.flatnonzero(self._provisioned)
        n = len(ids)
        offset = max(0, offset)
        end = n if limit is None else min(offset + max(0, limit), n)
        page_ids = ids[offset:end]
        if len(page_ids) == 0:
            return []
        status, inc, up = self._page(page_ids)
        names = self._STATUS_NAMES
        return [{"name": self.node_name(int(i)), "id": int(i),
                 "status": names[status[j]], "incarnation": int(inc[j]),
                 "actually_up": bool(up[j])}
                for j, i in enumerate(page_ids)]

    def members_summary(self) -> Dict[str, int]:
        """Counts by status over the provisioned members: one device
        reduction, 16 bytes transferred whatever N is."""
        with self._lock:
            counts = serf.membership_counts(self.params, self._state,
                                            self._prov_dev)
        alive, failed, left, total = (int(v) for v in _to_host(counts))
        return {"alive": alive, "failed": failed, "left": left,
                "total": total}

    def _delta_read(self, ckpt_attr: str, max_changes: int) -> dict:
        """The incremental delta against a named checkpoint (check, read
        and advance it under the lock): {"count", "changed", "truncated",
        "page" (the row budget used), "first" (the call that set the
        checkpoint)}."""
        k = _bucket(max(1, max_changes), self.sim.n_nodes)
        with self._lock:
            prev = getattr(self, ckpt_attr)
            first = prev is None
            if first:
                # no checkpoint yet: everything differs from status -1
                prev = self._node_fill(-1, torch.int8)
            st, n_changed, idx, states = serf.membership_delta(
                self.params, self._state, prev, self._prov_dev, k)
            setattr(self, ckpt_attr, st)
        n_changed = int(_to_host(n_changed))
        idx = _to_host(idx)
        states = _to_host(states)
        names = self._STATUS_NAMES
        changed = [(int(i), names[states[j]])
                   for j, i in enumerate(idx) if i >= 0]
        return {"count": n_changed, "changed": changed,
                "truncated": n_changed > k, "page": k, "first": first}

    def members_delta(self, max_changes: int = 256) -> dict:
        """Changed members since this cursor's last call: {"count",
        "changed": [(id, status_name)...], "truncated"}; min(F,
        max_changes) rows move for F changes.  The first call reports
        every provisioned member.  Independent of journal_flaps' cursor."""
        d = self._delta_read("_status_ckpt", max_changes)
        return {"count": d["count"], "changed": d["changed"],
                "truncated": d["truncated"]}

    def status(self, name: str) -> str:
        i = self.node_id(name)
        status, _, _ = self._page(np.array([i], np.int32))
        return self._STATUS_NAMES[int(status[0])]

    def believed_down_fraction(self, name: str) -> float:
        with self._lock:
            frac = swim.believed_down_fraction(
                self.params.swim, self._state.swim, self.node_id(name))
        return float(_to_host(frac).reshape(-1)[0])

    def kill(self, name: str) -> None:
        with self._lock:
            self._state = self._state.replace(
                swim=swim.kill(self._state.swim, self.node_id(name)))

    def revive(self, name: str) -> None:
        """Restart and rejoin: heals even a committed death (a higher
        incarnation refutes it, as memberlist's rejoin does)."""
        with self._lock:
            self._state = self._state.replace(
                swim=swim.rejoin(self.params.swim, self._state.swim,
                                 self.node_id(name)))

    def leave(self, name: str) -> None:
        self._unsharded("leave")
        with self._lock:
            self._state = self._state.replace(
                swim=swim.leave(self.params.swim, self._state.swim,
                                self.node_id(name)))

    def spawn(self, name: Optional[str] = None) -> str:
        """Elastic join of a new node into the first unprovisioned slot
        (or the slot whose default name is `name`), optionally renamed;
        RuntimeError when the pool is full, ValueError for a name in use."""
        self._unsharded("spawn")
        with self._lock:
            i = None
            if name is not None and name in self._ids:
                j = self._ids[name]
                if self._provisioned[j]:
                    raise ValueError(f"node name {name!r} in use")
                i = j
            if i is None:
                free = np.flatnonzero(~self._provisioned)
                if len(free) == 0:
                    raise RuntimeError("pool full: no unprovisioned slots")
                i = int(free[0])
            if name is not None and self._names[i] != name:
                self._ids.pop(self._names[i], None)
                self._names[i] = name
                self._ids[name] = i
            # the state first, then the provisioned mask: a reader pairing
            # the old mask with the new state misses the new node at worst
            self._state = self._state.replace(
                swim=swim.rejoin(self.params.swim, self._state.swim, i))
            self._prov_dev[i] = True
            self._provisioned[i] = True
            return self._names[i]

    @property
    def provisioned_count(self) -> int:
        """Members that ever joined (the listing length)."""
        return int(self._provisioned.sum())

    # ---------------------------------------------------------- coordinates

    def coordinate(self, name: str) -> dict:
        """One member's Vivaldi coordinate: one row, one transfer."""
        i = self.node_id(name)
        with self._lock:
            vec, err, adj, height = _coord_row(self._state.coords, i)
            row = torch.cat([vec, torch.stack([err, adj, height])])
        row = _to_host(row)
        d = row.shape[0] - 3
        return {"node": name,
                "vec": row[:d].tolist(),
                "error": float(row[d]),
                "adjustment": float(row[d + 1]),
                "height": float(row[d + 2])}

    def rtt(self, a: str, b: str) -> float:
        """Estimated RTT seconds (consul rtt, lib/rtt.go:13)."""
        self._unsharded("rtt")
        ia, ib = self.node_id(a), self.node_id(b)
        at = torch.tensor([ia, ib], dtype=torch.int32, device=self.device)
        with self._lock:
            est = vivaldi.estimate_rtt(self._state.coords, at[:1], at[1:])
        return float(_to_host(est)[0])

    def sort_by_rtt(self, origin: str, names: List[str]) -> List[str]:
        """?near= ordering (agent/consul/rtt.go:196): distances and the
        stable argsort of the query rows on the device, the O(k) order
        vector the only transfer.  The query pads to a power-of-two
        bucket, as the JAX oracle pads it."""
        if not names:
            return []
        io = self.node_id(origin)
        ids = np.array([self.node_id(n) for n in names], np.int32)
        k = len(ids)
        bucket = _bucket(k, self.sim.n_nodes)
        padded = np.zeros(bucket, np.int32)
        padded[:k] = ids
        at = torch.from_numpy(padded).to(self.device)
        valid = torch.from_numpy(np.arange(bucket) < k).to(self.device)
        with self._lock:
            order = serf.rtt_order(self.params, self._state, io, at, valid)
        order = _to_host(order)
        return [names[i] for i in order if i < k]

    # --------------------------------------------------------------- events

    def fire_event(self, name: str, payload: bytes, origin: str) -> str:
        """UserEvent (agent/user_event.go:23): the host keeps the payload
        ring, the device disseminates the id.  Ids come from a monotonic
        counter, never the ring length, so since-cursor consumers keep
        seeing new events after the ring trims."""
        self._unsharded("fire_event")
        with self._lock:
            self._event_seq += 1
            eid = self._event_seq
            self._state = serf.fire_event(self.params, self._state,
                                          self.node_id(origin), eid)
            ev = self._state.events
            slot = torch.argmax((ev.e_id == eid).to(torch.int32))
            ltime = int(_to_host(ev.e_ltime[slot]))
            rec = {"id": eid, "name": name, "payload": payload,
                   "ltime": ltime, "origin": origin}
            self._events.append(rec)
            if len(self._events) > self._event_ring:
                self._events = self._events[-self._event_ring:]
        # journaled outside the lock, with the caller's trace context
        self.hooks.emit("serf.user_event",
                        labels={"name": name, "origin": origin,
                                "id": eid, "ltime": ltime})
        return str(eid)

    def event_list(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def event_coverage(self, event_id: int) -> float:
        self._unsharded("event_coverage")
        with self._lock:
            st = self._state
            hit = np.nonzero(_to_host(st.events.e_id) == event_id)[0]
            if len(hit) == 0:
                return 1.0  # expired: its dissemination window passed
            cov = events_model.coverage(self.params.events, st.events,
                                        int(hit[0]), st.swim.up,
                                        st.swim.member)
        return float(_to_host(cov))

    # -------------------------------------------------------------- keyring

    def keyring_list(self) -> dict:
        with self._lock:
            return {"Keys": {k: self.sim.n_nodes for k in self._keyring},
                    "PrimaryKeys": ({self._primary_key: self.sim.n_nodes}
                                    if self._primary_key else {}),
                    "NumNodes": self.sim.n_nodes}

    def keyring_install(self, key: str) -> None:
        # validated before it is stored: a malformed primary key would
        # wedge the delegate socket (no frame could pass the codec)
        host.decode_key(key)
        with self._lock:
            if key not in self._keyring:
                self._keyring.append(key)
            if self._primary_key is None:
                self._primary_key = key

    def keyring_use(self, key: str) -> None:
        with self._lock:
            if key not in self._keyring:
                raise KeyError("key not installed")
            self._primary_key = key

    def keyring_remove(self, key: str) -> None:
        with self._lock:
            if key == self._primary_key:
                raise ValueError("cannot remove the primary key")
            if key in self._keyring:
                self._keyring.remove(key)

    # -------------------------------------------------------------- metrics

    def sim_metrics(self) -> Dict[str, float]:
        """Device-side sim telemetry as {name: value} (swim.METRIC_NAMES):
        one reduction over the state, one small transfer (on a mesh the
        blocks' totals, swim_blocks.metrics_vector)."""
        with self.hooks.span("oracle.metrics"):
            with self._lock:
                vec = serf.metrics_vector(self.params, self._state)
            vals = _to_host(vec)
        return {name: float(v) for name, v in zip(swim.METRIC_NAMES, vals)}

    def shard_metrics(self) -> Dict[int, Dict[str, float]]:
        """swim.SHARD_METRIC_NAMES gauges for each of the `shard_blocks`
        node-axis blocks, one [B, 4] transfer; empty for an unsharded pool
        or one whose N the blocks do not divide."""
        blocks = self.sim.shard_blocks
        if blocks <= 1 or self.sim.n_nodes % blocks:
            return {}
        with self._lock:
            mat = serf.shard_metrics(self.params, self._state, blocks)
        mat = _to_host(mat)
        return {b: {name: float(v)
                    for name, v in zip(swim.SHARD_METRIC_NAMES, mat[b])}
                for b in range(blocks)}

    def journal_flaps(self, max_changes: int = 256) -> int:
        """Membership flap events for the flight recorder from the delta
        against the journal's own checkpoint: min(F, page) rows move for F
        flaps.  The first call only sets the checkpoint.  When more
        members flapped than the page holds, the fetched rows are still
        journaled, with one `serf.flap.truncated` event giving the true
        count.  Returns the rows journaled."""
        d = self._delta_read("_flap_ckpt", max_changes)
        if d["first"]:
            return 0
        tick = self.tick
        # trace_id empty: a flap is cluster state, not part of whichever
        # request's scrape surfaced it
        if d["truncated"]:
            self.hooks.emit("serf.flap.truncated",
                            labels={"count": d["count"], "limit": d["page"],
                                    "tick": tick},
                            trace_id="")
        for i, status in d["changed"]:
            self.hooks.emit("serf.member.flap",
                            labels={"node": self.node_name(int(i)),
                                    "status": status, "tick": tick},
                            trace_id="")
        return len(d["changed"])

    def publish_sim_metrics(self, registry=None) -> Dict[str, float]:
        """sim_metrics() as consul.serf.* gauges, the per-shard split as
        consul.serf.*{shard} with the shards' skew and imbalance, and the
        flap journal fed from the delta.  `registry` defaults to the
        hooks' registry."""
        reg = registry or self.hooks.registry()
        m = self.sim_metrics()
        for name, v in m.items():
            reg.set_gauge(("serf",) + tuple(name.split(".")), v)
        shards = self.shard_metrics()
        if shards:
            for b, row in shards.items():
                for name, v in row.items():
                    reg.set_gauge(("serf",) + tuple(name.split(".")),
                                  v, labels={"shard": str(b)})
            alive = [row["members.alive"] for row in shards.values()]
            mean = sum(alive) / len(alive)
            # skew: the spread of live members across shards over the
            # mean; imbalance: the fullest shard's load factor
            reg.set_gauge(("serf", "shard", "skew"),
                          (max(alive) - min(alive)) / mean if mean else 0.0)
            reg.set_gauge(("serf", "shard", "imbalance"),
                          max(alive) / mean if mean else 0.0)
        self.journal_flaps()
        return m

    # ----------------------------------------------------------------- misc

    @property
    def tick(self) -> int:
        with self._lock:
            return int(self._state.swim.tick)

    @property
    def n_nodes(self) -> int:
        return self.sim.n_nodes

