"""The SWIM half of the nemesis (consul_tpu/chaos.py:1319-1750).

Per-node partition groups (`chaos_grp`) and delivery rates (`chaos_ok`)
are state tensors of the chaos build (`SimConfig(chaos=True)`), so the
host evolves a fault schedule between chunks of device ticks.
`SwimChaosHarness` drives one pool through such a schedule and checks the
SWIM safety bound: a node the nemesis never touched (clean), up and a
member is never committed dead or left; after the faults heal, the pool
re-converges (every crashed node detected, no live member believed down)
within a tick budget.  Each newly committed member and each injected or
healed fault journals one flight row, stamped with the device tick,
through the caller's `host.Hooks`.

The four scenarios whose SWIM halves build the harness are
`swim_partition_heal`, `swim_crash_restart`, `swim_loss_burst` and
`swim_asym_degradation`; each returns (violations, detail), `detail`
being what the JAX scenario stores under `detail["swim"]`.  The raft
halves are host code of the JAX package and are not ported.

Entry points run on the card unless the caller names a device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from consul_tpu_torch import host
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import swim
from consul_tpu_torch.utils import devices

_SWIM_RUNS: dict = {}


def compiled_swim_run(params: swim.SwimParams, ticks: int, monitor=None):
    """One chunk runner per (params, ticks, monitor), returning swim.run's
    (state, trace) tuple.  The JAX package caches a jitted executable per
    key; the port runs eagerly and caches the closure, keyed the same way."""
    key = (params, ticks, monitor)
    if key not in _SWIM_RUNS:
        _SWIM_RUNS[key] = lambda st: swim.run(params, st, ticks, monitor)
    return _SWIM_RUNS[key]


class SwimChaosHarness:
    """A chaos-build SWIM pool under the nemesis.  `clean` tracks the nodes
    the nemesis never touched: a clean, up member must never be committed
    dead or left (no committed death of a reachable live node)."""

    def __init__(self, seed: int, n: int = 128, slots: int = 16,
                 p_loss: float = 0.01, chunk: int = 50, device=None,
                 hooks: Optional[host.Hooks] = None):
        self.device = devices.resolve(device)
        self.hooks = hooks if hooks is not None else host.Hooks()
        self.seed = seed
        self.params = swim.make_params(
            GossipConfig.lan(),
            SimConfig(n_nodes=n, rumor_slots=slots, p_loss=p_loss, seed=seed,
                      chaos=True))
        self.state = swim.init_state(self.params, device=self.device)
        self.n = n
        self.chunk = chunk
        self.clean = np.ones(n, bool)
        self.crashed = np.zeros(n, bool)
        # every node ever committed dead or left (a rejoin clears the
        # state's flag, not the fact the checks assert on)
        self.ever_committed = np.zeros(n, bool)
        self.violations: List[str] = []
        self._run = compiled_swim_run(self.params, chunk)

    def _mask(self, mask) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, bool), device=self.device)

    # ------------------------------------------------------------ stepping

    def advance(self, ticks: int) -> None:
        for _ in range(max(1, math.ceil(ticks / self.chunk))):
            self.state = self._run(self.state)[0]
            self._check_clean()

    def _check_clean(self) -> None:
        """One host copy of committed dead/left, up and member per chunk;
        each newly committed member journals one flap row."""
        s = self.state
        dead, left, up, member = torch.stack(
            [s.committed_dead, s.committed_left, s.up, s.member]).cpu().numpy()
        committed = dead | left
        new = committed & ~self.ever_committed
        for i in np.flatnonzero(new):
            self.hooks.emit("serf.member.flap",
                            labels={"node": f"node{int(i)}",
                                    "status": "failed" if dead[i] else "left",
                                    "tick": s.tick},
                            ts=float(s.tick))
        self.ever_committed |= committed
        bad = committed & self.clean & up & member
        if bad.any():
            ids = np.flatnonzero(bad)[:8].tolist()
            self.violations.append(
                f"swim: reachable live nodes {ids} committed dead/left "
                f"at tick {s.tick}")
            self.clean[bad] = False       # report each node once

    # -------------------------------------------------------------- faults

    def partition(self, mask) -> None:
        """Split the pool: masked nodes go to group 1, unreachable from
        group 0, and leave the clean set."""
        mask = np.asarray(mask, bool)
        self.clean &= ~mask
        self._journal("chaos.fault.injected", "partition",
                      f"{int(mask.sum())}nodes")
        self.state = self.state.replace(
            chaos_grp=self._mask(mask).to(torch.int16))

    def heal_partition(self) -> None:
        self._journal("chaos.fault.healed", "partition", "*")
        self.state = self.state.replace(
            chaos_grp=torch.zeros(self.n, dtype=torch.int16,
                                  device=self.device))

    def crash(self, mask) -> None:
        mask = np.asarray(mask, bool)
        self.clean &= ~mask
        self.crashed |= mask
        self._journal("chaos.fault.injected", "crash",
                      f"{int(mask.sum())}nodes")
        self.state = swim.kill_mask(self.state, self._mask(mask))

    def flap_revive(self, mask) -> None:
        """Restart crashed nodes inside the suspicion window: they come back
        with a bumped incarnation, so stale death rumors cannot commit
        them."""
        mask = np.asarray(mask, bool)
        self.crashed &= ~mask
        self._journal("chaos.fault.healed", "crash",
                      f"{int(mask.sum())}nodes")
        self.state = swim.revive_mask(self.state, self._mask(mask))

    def degrade(self, mask, ok: float) -> None:
        """Asymmetric local degradation: masked nodes deliver each of their
        legs at rate `ok` (float32), set on the device."""
        mask = np.asarray(mask, bool)
        self._journal("chaos.fault.injected", "degrade",
                      f"{int(mask.sum())}nodes@{ok}")
        self.state = self.state.replace(chaos_ok=torch.where(
            self._mask(mask), float(np.float32(ok)), self.state.chaos_ok))

    def loss_burst(self, p: float) -> None:
        """Symmetric loss: every leg delivers at (1 - p) on top of the
        baseline, a per-node rate of float32(sqrt(1 - p)) (a leg pays both
        endpoints)."""
        self._journal("chaos.fault.injected", "loss", f"p={p}")
        self.state = self.state.replace(chaos_ok=torch.full(
            (self.n,), math.sqrt(max(0.0, 1.0 - p)), dtype=torch.float32,
            device=self.device))

    def calm(self) -> None:
        self._journal("chaos.fault.healed", "loss", "*")
        self.state = self.state.replace(chaos_ok=torch.ones(
            self.n, dtype=torch.float32, device=self.device))

    def _journal(self, name: str, fault: str, target: str) -> None:
        """One flight row per injected or healed fault, at the device tick."""
        tick = self.state.tick
        self.hooks.emit(name, labels={"fault": fault, "target": target,
                                      "tick": tick}, ts=float(tick))

    # --------------------------------------------------------------- checks

    def rejoin_committed(self) -> int:
        """Rejoin every up member the cluster declared dead (committed, or
        carrying an active dead rumor): a real agent that hears itself
        declared dead rejoins with a bumped incarnation."""
        s = self.state
        declared = s.committed_dead.cpu().numpy().copy()
        r_active, r_kind, r_subject = (x.cpu().numpy() for x in
                                       (s.r_active, s.r_kind, s.r_subject))
        declared[r_subject[r_active & (r_kind == swim.DEAD)]] = True
        up = (s.up & s.member).cpu().numpy()
        todo = np.flatnonzero(declared & up)
        for node in todo:
            self.state = swim.rejoin(self.params, self.state, int(node))
        return len(todo)

    def check_not_committed(self, mask, label: str) -> None:
        bad = self.ever_committed & np.asarray(mask, bool)
        if bad.any():
            self.violations.append(
                f"swim: {label}: nodes {np.flatnonzero(bad)[:8].tolist()} "
                f"were committed dead")

    def reconverge(self, budget_ticks: int,
                   label: str = "reconverge") -> dict:
        """After the heal: within `budget_ticks` every still-crashed node
        must be cluster-detected and no live member believed down.  Each
        chunk runs the rejoin sweep."""
        victims = self._mask(self.crashed)
        recall, fp = 0.0, -1
        spent = 0
        while spent < budget_ticks:
            self.advance(self.chunk)
            spent += self.chunk
            self.rejoin_committed()
            rec, fps = swim.mass_detection_stats(self.params, self.state,
                                                 victims)
            recall, fp = float(rec.reshape(())), int(fps.reshape(()))
            if (not self.crashed.any() or recall >= 0.999) and fp == 0:
                return {"recall": recall, "false_positives": fp,
                        "ticks": spent}
        self.violations.append(
            f"swim: {label}: no re-convergence within {budget_ticks} "
            f"ticks (recall={recall}, believed-down live nodes={fp})")
        return {"recall": recall, "false_positives": fp, "ticks": spent}

    def digest_detail(self) -> dict:
        s = self.state
        return {
            "tick": s.tick,
            "committed_dead": torch.nonzero(s.committed_dead).flatten()
            .cpu().tolist(),
            "incarnation_sum": int(s.incarnation.sum()),
        }


# ---------------------------------------------------------------------------
# the SWIM halves of the scenarios
# ---------------------------------------------------------------------------

def _harness(seed, soak, n, slots, device, hooks) -> SwimChaosHarness:
    return SwimChaosHarness(seed, n=n or (256 if soak else 128),
                            slots=slots or 16, device=device, hooks=hooks)


def swim_partition_heal(seed: int, soak: bool = False, n: Optional[int] = None,
                        slots: Optional[int] = None, device=None, hooks=None):
    """25% of the pool splits off long enough for the majority to commit
    the minority's deaths; on the heal the committed-but-alive nodes
    rejoin and the pool re-converges (chaos.py:1619-1634)."""
    sw = _harness(seed, soak, n, slots, device, hooks)
    sw.advance(50)                               # settle the pool
    sw.partition(np.arange(sw.n) % 4 == 3)       # deterministic 25%
    p = sw.params
    # timer + declare lag + the 4x coverage-capped slot lifetime, with slack
    sw.advance(p.suspicion_max_ticks + p.declare_lag_ticks
               + 6 * p.expiry_gossip_ticks)
    sw.heal_partition()
    rejoined = sw.rejoin_committed()
    rec = sw.reconverge(4000, "partition_heal")
    return list(sw.violations), dict(sw.digest_detail(), rejoined=rejoined,
                                     **rec)


def swim_crash_restart(seed: int, soak: bool = False, n: Optional[int] = None,
                       slots: Optional[int] = None, device=None, hooks=None):
    """kill_mask of 10 nodes, a flap revive of 5 of them inside the
    suspicion window, then re-convergence (chaos.py:1664-1681)."""
    sw = _harness(seed, soak, n, slots, device, hooks)
    sw.advance(50)
    victims = np.random.default_rng(seed).choice(sw.n, size=10, replace=False)
    mask = np.zeros(sw.n, bool)
    mask[victims] = True
    sw.crash(mask)
    # suspicions airborne, but flap before the timeout can commit
    sw.advance(sw.chunk)
    revived = np.zeros(sw.n, bool)
    revived[victims[:5]] = True
    sw.flap_revive(revived)
    rec = sw.reconverge(6000, "crash_restart")
    sw.check_not_committed(revived, "flap-revived nodes")
    return list(sw.violations), dict(sw.digest_detail(), **rec)


def swim_loss_burst(seed: int, soak: bool = False, n: Optional[int] = None,
                    slots: Optional[int] = None, device=None, hooks=None):
    """A 30% symmetric loss window: loss alone must never commit a death
    (chaos.py:1699-1714)."""
    sw = _harness(seed, soak, n, slots, device, hooks)
    sw.advance(50)
    sw.loss_burst(0.30)
    sw.advance(sw.params.suspicion_max_ticks * (2 if soak else 1))
    sw.calm()
    sw.advance(500)
    n_committed = int(sw.state.committed_dead.sum())
    if n_committed:
        sw.violations.append(
            f"swim: loss burst committed {n_committed} deaths with "
            f"zero crashes")
    return list(sw.violations), dict(sw.digest_detail(),
                                     committed=n_committed)


def swim_asym_degradation(seed: int, soak: bool = False,
                          n: Optional[int] = None,
                          slots: Optional[int] = None, device=None,
                          hooks=None, observe: Optional[Callable] = None):
    """10% of nodes deliver their legs at 55%: they must neither be
    committed dead nor poison the pool (chaos.py:1732-1751).  `observe`,
    if given, is called with the harness at the end of the degraded
    window (a caller holding that state against a reference)."""
    sw = _harness(seed, soak, n, slots, device, hooks)
    sw.advance(50)
    degraded = np.arange(sw.n) % 10 == 5         # deterministic 10%
    sw.degrade(degraded, 0.55)
    sw.advance(sw.params.suspicion_max_ticks)
    if observe is not None:
        observe(sw)
    sw.calm()
    sw.advance(800)
    sw.check_not_committed(degraded, "degraded-but-live nodes")
    n_committed = int(sw.state.committed_dead.sum())
    if n_committed:
        sw.violations.append(
            f"swim: degradation committed {n_committed} deaths with "
            f"zero crashes")
    return list(sw.violations), dict(sw.digest_detail(),
                                     degraded=int(degraded.sum()))


SCENARIOS = {
    "partition_heal": swim_partition_heal,
    "crash_restart": swim_crash_restart,
    "loss_burst": swim_loss_burst,
    "asym_degradation": swim_asym_degradation,
}
