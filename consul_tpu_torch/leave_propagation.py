"""Leave propagation against the serf simulator's published claim (the
port of tools/leave_propagation.py).

The reference sizes its LeavePropagateDelay from a serf-simulator result:
a graceful leave reaches > 99.99% of a 100,000-node cluster within 3
seconds (lib/serf/serf.go:26-30).  A steady pool, one `leave()`, and the
simulated time until >= 99.99% of the remaining members believe the node
left (the K3 monitor, one [200] device vector read back once).

    python -m consul_tpu_torch.leave_propagation [--nodes 100000]

Prints one JSON line and writes it to chiprun_out/leave.json.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import swim
from consul_tpu_torch.utils import devices


def run(nodes: int = 100_000, p_loss: float = 0.01, seed: int = 11,
        device=None) -> dict:
    """The leave-propagation row, on the card unless a device is named."""
    gossip = GossipConfig.lan()
    params = swim.make_params(gossip, SimConfig(
        n_nodes=nodes, rumor_slots=32, alloc_cap=8, p_loss=p_loss, seed=seed))
    s = swim.init_state(params, device=devices.resolve(device))
    s, _ = swim.run(params, s, 50)                       # steady state
    victim = nodes // 3
    s = swim.leave(params, s, victim)
    s, frac = swim.run(params, s, 200, victim)
    frac = frac.cpu().numpy()
    bar = 0.9999
    idx = int(np.argmax(frac >= bar))
    converged = bool(frac.max() >= bar)
    sim_s = (idx + 1) * gossip.gossip_interval if converged else None
    return {
        "metric": "leave_propagation_99_99_sim_s",
        "value": round(sim_s, 2) if sim_s is not None else None,
        "unit": "sim-seconds",
        "vs_baseline": round(3.0 / sim_s, 2) if sim_s else 0.0,
        "detail": {
            "nodes": nodes,
            "p_loss": p_loss,
            "final_fraction": float(frac.max()),
            "reference_claim": "leave reaches >99.99% of 100k nodes "
                               "in 3s (lib/serf/serf.go:26-30)",
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--p-loss", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "leave.json"))
    args = ap.parse_args(argv)
    row = run(args.nodes, args.p_loss, args.seed, args.device)
    print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
