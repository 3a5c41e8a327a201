"""North-star pipeline on the port: 1M-node serf LAN pool, crash to
convergence (the counterpart of the repo's bench.py:53-159).

Builds a serf pool at the bench configuration, runs a warm scan, kills
one node, then runs timed scans — each tick also computing the victim's
believed-down fraction (kernel K3) — until more than 99.9% of live
members believe the victim down, and accounts F1 and false commits.
The fences sit where the JAX bench's `hard_sync` sits: after the warm
scan and the kill (before the clock starts) and at each scan's single
readback of its fractions.

Run on the card: `python -m consul_tpu_torch.bench` (prints one JSON
line, stamped with the topology it ran on and the number of times the
process loaded the kernel library, which must be one: the counterpart of
the JAX bench's `compiles`); tests call `run_convergence(...,
device="cpu")` at small N.  With `mesh=` (parallel/mesh.make_mesh) the
pool is node-sharded from its first tick, as the JAX bench's `mesh=`
(bench.py:55-77): shard_blocks is the mesh's size, the state stays
sharded through the drain (asserted), and the accuracy accounting adds
the blocks' integer counts.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import serf, swim, swim_blocks
from consul_tpu_torch.parallel import mesh as meshlib
from consul_tpu_torch.parallel.kernel_audit import topology_stamp
from consul_tpu_torch.utils import devices

N = 1_000_000
CHUNK = 200
VICTIM = 123_456


def fence(device: torch.device, mesh=None) -> None:
    """Wait for the card's queued work, every card of a mesh (nothing on
    the CPU)."""
    for d in (mesh.distinct if mesh is not None else (device,)):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def prepare(n_nodes: int = N, chunk: int = CHUNK, victim: int = VICTIM,
            seed: int = 7, device=None, mesh=None):
    """The bench pool after its warm scan and the kill, fenced:
    (params, state, warm-scan seconds).  With `mesh` the pool is made on
    the mesh's first device and node-sharded before its first tick."""
    device = mesh.home if mesh is not None else devices.resolve(device)
    params = serf.make_params(GossipConfig.lan(),
                              SimConfig(n_nodes=n_nodes, rumor_slots=32,
                                        alloc_cap=8, p_loss=0.01, seed=seed,
                                        shard_blocks=mesh.size
                                        if mesh is not None else 1))
    s = serf.init_state(params, device=device)
    if mesh is not None:
        s = meshlib.shard_state(s, mesh)
    t_warm = time.perf_counter()
    s, _ = serf.run(params, s, chunk, victim)
    fence(device, mesh)
    warm_s = time.perf_counter() - t_warm
    s = s.replace(swim=swim.kill(s.swim, victim))
    fence(device, mesh)
    return params, s, warm_s


def _false_commits(sw) -> int:
    """Live nodes with a committed death (on a sharded pool the blocks'
    counts added)."""
    if isinstance(sw.up, meshlib.Blocks):
        return int(swim_blocks._count(
            sw.committed_dead.map(torch.logical_and, sw.up)))
    return int((sw.committed_dead & sw.up).sum())


def run_convergence(n_nodes: int = N, chunk: int = CHUNK,
                    victim: int = VICTIM, max_ticks: int = 1200,
                    seed: int = 7, device=None, mesh=None) -> dict:
    """The north-star pipeline, parameterized by pool size.  `fracs` holds
    the victim's believed-down fraction after every timed tick.  `mesh`
    node-shards the pool over a parallel/mesh.Mesh (prepare)."""
    device = mesh.home if mesh is not None else devices.resolve(device)
    params, s, warm_s = prepare(n_nodes, chunk, victim, seed, device, mesh)
    launches0 = dict(kernels.LAUNCHES)
    syncs0 = swim.host_syncs
    t0 = time.time()
    ticks = 0
    frac = 0.0
    fracs = []
    while ticks < max_ticks:
        s, fr = serf.run(params, s, chunk, victim)
        fr = fr.cpu().numpy()          # the single host readback per scan
        fracs.extend(float(f) for f in fr)
        ticks += chunk
        if (fr > 0.999).any():
            extra = int(np.argmax(fr > 0.999)) + 1
            ticks = ticks - chunk + extra
            frac = float(fr[extra - 1])
            break
        frac = float(fr[-1])
    wall = time.time() - t0
    # kernel launches and host syncs of the timed window (a sync is a
    # probe tick's bulk-channel flag or a scan's fraction readback)
    launches = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()}
    timed_ticks_run = s.swim.tick - chunk
    syncs = swim.host_syncs - syncs0 + timed_ticks_run // chunk
    if mesh is not None:
        meshlib.assert_node_sharded(s.swim.know, mesh.size,
                                    "knowledge matrix after drain")

    ok = frac > 0.999
    false_commits = _false_commits(s.swim)
    tp = 1 if ok else 0
    precision = tp / max(tp + false_commits, 1)
    f1 = 2 * precision * tp / max(precision + tp, 1e-9)
    mvec = serf.metrics_vector(params, s).cpu().numpy()
    sim_counters = {name: float(v) for name, v in zip(swim.METRIC_NAMES, mvec)}
    return {"params": params, "state": s, "wall": wall, "warm_s": warm_s,
            "frac": frac, "ticks": ticks, "converged": ok, "f1": f1,
            "false_commits": false_commits, "sim_counters": sim_counters,
            "launches": launches, "timed_ticks_run": timed_ticks_run,
            "fracs": fracs,
            "host_syncs": syncs,
            "topology": topology_stamp(device, mesh),
            # kernel builds in this process: one on the card, none on the
            # CPU (the twins need no library)
            "library_loads": kernels.LIBRARY_LOADS
            if device.type == "cuda" else None,
            "device": {"type": device.type,
                       "name": torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"}}


def main() -> None:
    r = run_convergence()
    assert r["library_loads"] == 1, \
        f"the kernel library was loaded {r['library_loads']} times"
    print(json.dumps({
        "metric": "serf_1M_node_crash_convergence_wallclock",
        "value": r["wall"], "unit": "s", "ticks": r["ticks"],
        "converged": r["converged"], "f1": r["f1"],
        "false_commits": r["false_commits"], "launches": r["launches"],
        "host_syncs_per_tick": r["host_syncs"] / max(r["timed_ticks_run"], 1),
        "sim_counters": r["sim_counters"], "topology": r["topology"],
        "library_loads": r["library_loads"], "device": r["device"]}))


if __name__ == "__main__":
    main()
