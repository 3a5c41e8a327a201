"""The loops that run the federation, anti-entropy and Vivaldi workloads, the
same on the card and on the CPU (`device`), so a run on one can be held
to a run on the other.

* `wan_point`: tools/scale_sweep.py's `_dc_point` — warm a federation for
  six chunks, fire an event at a non-server member of DC 0, step in
  chunks until every DC's coverage reaches 0.99; `wan_partition` then
  crashes one DC's servers in the WAN pool and steps until the others
  mark it unreachable and the failure detector commits its servers.
* `ae_churn`: anti-entropy under service churn — every service
  registered in one command, one step that pushes them all, then one
  scaled full-sync interval of ticks that each re-register some live
  services at a bumped version and deregister others while a block of
  agents is down for a stretch, and a final step with every agent up.
  The host's choices come from numpy's generator on the seed.
* `vivaldi_converge`: tests/test_vivaldi.py's `_converge` — latent 2-D
  coordinates uniform(PRNGKey(7)) * 60 ms and `sim_step` ticks, with the
  median relative error every 50 ticks.

Every run draws from seed 7.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from consul_tpu_torch.bench import fence
from consul_tpu_torch.models import antientropy, vivaldi, wan
from consul_tpu_torch.utils import devices, prng

SEED = 7
# tools/scale_sweep.py:_dc_point's loop: 1% loss, event 7, 5-tick chunks,
# 250 ticks to cover; a partition gets 1,000 ticks in 10-tick chunks
WAN_LOSS, WAN_EVENT, WAN_CHUNK, WAN_BUDGET = 0.01, 7, 5, 250
PARTITION_CHUNK, PARTITION_LIMIT = 10, 1000
# tests/test_vivaldi.py:_converge's horizon, at serf's 8 dimensions, the
# error read every 50 ticks
VIVALDI_TICKS, VIVALDI_DIMS, VIVALDI_EVERY = 400, 8, 50
# the reference's 1-minute full sync at a tick a second (ae.go)
AE_INTERVAL = 60


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------

def wan_point(n_dcs: int, nodes_per_dc: int, servers_per_dc: int,
              device=None):
    """(params, state, row): the federation after the event covered every
    DC (row["convergence_ticks"] -1 when it did not within WAN_BUDGET
    ticks of the fire)."""
    device = devices.resolve(device)
    params = wan.make_params(n_dcs=n_dcs, nodes_per_dc=nodes_per_dc,
                             servers_per_dc=servers_per_dc, p_loss=WAN_LOSS,
                             seed=SEED)
    s = wan.init_state(params, device=device)
    for _ in range(6):
        s = wan.run(params, s, WAN_CHUNK)
    # the event starts at a LAN-only member: it must cross LAN gossip, a
    # server, the WAN pool, the remote servers and the remote LANs
    s = wan.fire_event(params, s, 0, nodes_per_dc - 1, WAN_EVENT)
    fence(device)
    t0 = time.perf_counter()
    elapsed, conv, cov = 0, -1, []
    while elapsed < WAN_BUDGET:
        s = wan.run(params, s, WAN_CHUNK)
        elapsed += WAN_CHUNK
        cov = wan.event_coverage_by_dc(params, s, WAN_EVENT).cpu().tolist()
        if min(cov) >= 0.99:
            conv = elapsed
            break
    wall = time.perf_counter() - t0
    return params, s, {"n_dcs": n_dcs, "nodes_per_dc": nodes_per_dc,
                       "servers_per_dc": servers_per_dc,
                       "wan_pool": n_dcs * servers_per_dc,
                       "convergence_ticks": conv, "coverage": cov,
                       "converge_wall_s": wall}


def wan_partition(params: wan.WanParams, s: wan.WanState, dc: int):
    """DC `dc`'s servers crashed in the WAN pool, then chunks until the
    others mark it unreachable and every crashed server is committed dead
    in the WAN pool.  Returns (state, {"reachable_ticks": ticks until
    `dc_reachable` is False for `dc` alone, "committed_ticks": ticks until
    the commits, "wall_s"}); a tick count is -1 when not within
    PARTITION_LIMIT.
    (`dc_reachable` reads the WAN pool's `up`, so it flips at the kill;
    the commits are the failure detector's verdict.)"""
    device = s.wan.swim.device
    sp = params.servers_per_dc
    want = [d != dc for d in range(params.n_dcs)]
    s = wan.wan_kill_dc(params, s, dc)
    fence(device)
    t0 = time.perf_counter()
    out = {"reachable_ticks": -1, "committed_ticks": -1}
    ticks = 0
    while ticks <= PARTITION_LIMIT:
        if out["reachable_ticks"] < 0 and \
                wan.dc_reachable(params, s).cpu().tolist() == want:
            out["reachable_ticks"] = ticks
        if out["committed_ticks"] < 0 and \
                bool(s.wan.swim.committed_dead[dc * sp:(dc + 1) * sp].all()):
            out["committed_ticks"] = ticks
        if min(out.values()) >= 0:
            break
        s = wan.run(params, s, PARTITION_CHUNK)
        ticks += PARTITION_CHUNK
    out["wall_s"] = time.perf_counter() - t0
    return s, out


# ---------------------------------------------------------------------------
# anti-entropy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Churn:
    n_agents: int
    capacity: int
    services: int
    reregister: int = 1000        # live services re-registered a tick
    deregister: int = 100         # live services deregistered a tick
    down_agents: int = 1000       # agents 0..down_agents-1 are down ...
    down_from: int = 100          # ... for ticks [down_from, down_to)
    down_to: int = 400

    @property
    def params(self) -> antientropy.AEParams:
        return antientropy.AEParams(
            n_agents=self.n_agents, capacity=self.capacity,
            sync_interval_ticks=AE_INTERVAL, seed=SEED)


def _pick(rng, alive: np.ndarray, k: int) -> np.ndarray:
    """k distinct positions where `alive` is True, in random order."""
    got = np.empty(0, np.int64)
    while len(got) < k:
        c = rng.integers(0, len(alive), 2 * k + 8)
        got = np.unique(np.concatenate([got, c[alive[c]]]))
    return rng.permutation(got)[:k]


def _digest(h, s: antientropy.AEState) -> None:
    for name in antientropy.TENSOR_FIELDS:
        h.update(getattr(s, name).cpu().numpy().tobytes())


def ae_churn(cfg: Churn, device=None,
             keep: Optional[Callable] = None, digest: bool = False) -> dict:
    """Run the churn workload.  `keep(label, state, up)` sees the state
    before chosen steps (label "first_push", then every tick's number).
    With `digest`, a sha256 over every leaf after every step.  Returns the
    final state, the desired live count, the per-tick step / register /
    deregister wall ms (fenced on the card), the in_sync fraction after
    the final step and the count of steps and in_sync calls."""
    device = devices.resolve(device)
    params = cfg.params
    rng = np.random.default_rng(SEED)
    ids = rng.choice(2 ** 30, size=cfg.services, replace=False).astype(
        np.int32)
    owner = (np.arange(cfg.services) % cfg.n_agents).astype(np.int32)
    ver = np.ones(cfg.services, np.int32)
    alive = np.ones(cfg.services, bool)
    h = hashlib.sha256()
    times = {"step_ms": [], "register_ms": [], "deregister_ms": []}
    up_all = torch.ones(cfg.n_agents, dtype=torch.bool, device=device)
    down = up_all.clone()
    down[:cfg.down_agents] = False

    def timed(what, fn):
        fence(device)
        t0 = time.perf_counter()
        out = fn()
        fence(device)
        times[what].append((time.perf_counter() - t0) * 1000.0)
        return out

    s = antientropy.init_state(params, device=device)
    s = timed("register_ms", lambda: antientropy.register_desired(
        s, ids, owner, ver))
    steps = 0
    if keep is not None:
        keep("first_push", s, up_all)
    s = timed("step_ms", lambda: antientropy.step(params, s, up_all))
    steps += 1
    for t in range(params.scaled_interval):
        pick = _pick(rng, alive, cfg.reregister + cfg.deregister)
        reg, dereg = pick[:cfg.reregister], pick[cfg.reregister:]
        ver[reg] += 1
        alive[dereg] = False
        s = timed("register_ms", lambda: antientropy.register_desired(
            s, ids[reg], owner[reg], ver[reg]))
        s = timed("deregister_ms", lambda: antientropy.deregister_desired(
            s, ids[dereg]))
        up = down if cfg.down_from <= t < cfg.down_to else up_all
        if keep is not None:
            keep(t, s, up)
        s = timed("step_ms", lambda: antientropy.step(params, s, up))
        steps += 1
        if digest:
            _digest(h, s)
    s = timed("step_ms", lambda: antientropy.step(params, s, up_all))
    steps += 1
    if digest:
        _digest(h, s)
    frac = float(antientropy.in_sync_fraction(s))
    return {"state": s, "desired_live": int(alive.sum()),
            "catalog_live": int((s.a_ids != antientropy.INVALID_ID).sum()),
            "desired_rows": int((s.d_ids != antientropy.INVALID_ID).sum()),
            "in_sync": frac, "steps": steps, "in_sync_calls": 1,
            "syncs_done": int(s.syncs_done), "ticks": s.tick,
            "digest": h.hexdigest() if digest else None, **times}


# ---------------------------------------------------------------------------
# Vivaldi
# ---------------------------------------------------------------------------

def vivaldi_converge(n: int, device=None) -> dict:
    """The standalone solver from the zero state for VIVALDI_TICKS ticks:
    the initial error, the error (pairs of tick 1, as test_vivaldi.py
    reads it) every VIVALDI_EVERY ticks, and the fenced wall of the ticks
    alone."""
    device = devices.resolve(device)
    ticks, every = VIVALDI_TICKS, VIVALDI_EVERY
    params = vivaldi.VivaldiParams(n_nodes=n, dims=VIVALDI_DIMS, seed=SEED)
    true = prng.uniform(prng.PRNGKey(SEED), (n, 2), device) * 0.060
    s = vivaldi.init_state(params, device=device)
    err0 = float(vivaldi.relative_error(params, true, s, 0))
    curve, wall = [], 0.0
    for t0 in range(0, ticks, every):
        fence(device)
        c0 = time.perf_counter()
        for t in range(t0, min(t0 + every, ticks)):
            s = vivaldi.sim_step(params, true, s, t)
        fence(device)
        wall += time.perf_counter() - c0
        curve.append((min(t0 + every, ticks),
                      float(vivaldi.relative_error(params, true, s, 1))))
    return {"params": params, "true": true, "state": s, "err0": err0,
            "curve": curve, "err": curve[-1][1], "ticks": ticks,
            "wall_s": wall}
