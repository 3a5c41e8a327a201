"""Failure-detection accuracy (F1) under packet loss (the port of
tools/f1_harness.py).

Kill K nodes in a steady pool, run the detector, and score:

  recall        = killed nodes believed down by > 99% of live members
  precision     = TP / (TP + FP), FP = live nodes committed dead or
                  believed down by a majority of live members (a sample of
                  64 live nodes)
  false_commits = committed dead and actually up (must be 0)

    python -m consul_tpu_torch.f1 [N] [kills] [ticks] [--device cpu]

Prints one JSON line per p_loss in {0.02, 0.05, 0.10}.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import swim
from consul_tpu_torch.utils import devices


def run_one(n: int, kills: int, ticks: int, p_loss: float, seed: int = 7,
            lha: bool = True, degraded=(0.0, 0.0), device=None) -> dict:
    """One F1 row (tools/f1_harness.py:run_one), on the card unless a
    device is named."""
    gossip = GossipConfig.lan() if lha else dataclasses.replace(
        GossipConfig.lan(), awareness_max_multiplier=0)
    params = swim.make_params(gossip, SimConfig(
        n_nodes=n, rumor_slots=32, alloc_cap=8, p_loss=p_loss,
        degraded_frac=degraded[0], degraded_loss=degraded[1], seed=seed))
    s = swim.init_state(params, device=devices.resolve(device))
    s, _ = swim.run(params, s, 25)                      # steady state
    sus_base = s.sus_count.cpu().numpy().copy()         # warmup baseline
    victims = list(range(3, 3 + kills * 7, 7))[:kills]
    for v in victims:
        s = swim.kill(s, v)
    s, _ = swim.run(params, s, ticks)

    up = s.up.cpu().numpy()
    committed = s.committed_dead.cpu().numpy()
    false_commits = int((committed & up).sum())
    # suspicion timers started on subjects alive the whole run
    sus_delta = s.sus_count.cpu().numpy() - sus_base
    vm = np.zeros(n, bool)
    vm[victims] = True
    false_suspicions = int(sus_delta[~vm].sum())

    tp = sum(1 for v in victims
             if float(swim.believed_down_fraction(params, s, v)) > 0.99)
    rng = np.random.default_rng(seed)
    live_ids = np.nonzero(up)[0]
    sample = rng.choice(live_ids, size=min(64, len(live_ids)), replace=False)
    fp = false_commits
    for i in sample:
        if committed[i]:
            continue  # already counted in false_commits
        if float(swim.believed_down_fraction(params, s, int(i))) > 0.5:
            fp += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(len(victims), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {"p_loss": p_loss, "n": n, "kills": kills, "lha": lha,
            "recall": round(recall, 4), "precision": round(precision, 4),
            "f1": round(f1, 4), "false_commits": false_commits,
            "false_suspicions": false_suspicions}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if "--device" in argv:
        at = argv.index("--device")
        device = argv[at + 1]
        argv = argv[:at] + argv[at + 2:]
    args = [a for a in argv if not a.startswith("--")]
    n = int(args[0]) if len(args) > 0 else 4096
    kills = int(args[1]) if len(args) > 1 else 8
    ticks = int(args[2]) if len(args) > 2 else 900
    for p_loss in (0.02, 0.05, 0.10):
        print(json.dumps(run_one(n, kills, ticks, p_loss, device=device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
