"""Correlated-failure bench: rack-scale death under rumor-slot pressure
(the port of tools/correlated_failures.py:29-140).

A fraction of the pool dies in one tick; the bench traces cluster-level
recall (the fraction of victims whose death is committed or reached
>= 99% of live members, K5) and false positives every tick, until recall
reaches 0.999 or the tick budget runs out.  At N = 1M and 1% the kills
overflow the U-slot rumor table, so this is the workload that drives the
bulk death channel (`_bulk_step`: kernel K14 on a card) at full width.

    python -m consul_tpu_torch.correlated                  # 1M, 0.1% + 1%
    python -m consul_tpu_torch.correlated --nodes 65536 --fractions 0.01

Each tick's (recall, fp) lands in two [chunk] device vectors through K5's
`out=` slots and is read back once per chunk.  Prints one JSON line per
row, each with the device it ran on (on a card, its name and power limit
as nvidia-smi reports them), and writes the rows to
chiprun_out/correlated.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import swim
from consul_tpu_torch.utils import devices


SEED = 7
# the row whose kills overflow the rumor table at 1M (10,000 victims)
FRACTION = 0.01


def bench_params(nodes: int, slots: int = 32, seed: int = SEED):
    """The bench's SWIM parameters: LAN gossip, 1% packet loss."""
    return swim.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=nodes, rumor_slots=slots, p_loss=0.01, seed=seed))


def card(device: torch.device) -> str:
    """The device a row ran on: nvidia-smi's name and power limit on a
    card, "cpu" otherwise."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", str(device.index)],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def run_chunk(params, s, n: int, mask: torch.Tensor):
    """n ticks, each followed by K5 into the tick's slots of two [n] device
    vectors: (state, recall [n] float32, fp [n] int32)."""
    rec = torch.empty(n, dtype=torch.float32, device=s.device)
    fp = torch.empty(n, dtype=torch.int32, device=s.device)
    for t in range(n):
        s = swim.step(params, s)
        swim.mass_detection_stats(params, s, mask,
                                  out=(rec[t:t + 1], fp[t:t + 1]))
    return s, rec, fp


def start(params, frac: float, seed: int, device):
    """The pool at the kill: 25 warm ticks, then `frac` of the nodes
    (drawn from `seed`) crash at once.  Returns (state, victim mask)."""
    n = params.n_nodes
    k = max(1, int(n * frac))
    s = swim.init_state(params, device=device)
    s = swim.run(params, s, 25)[0]
    victims = np.random.default_rng(seed).choice(n, size=k, replace=False)
    mask = np.zeros(n, bool)
    mask[victims] = True
    mask_d = torch.as_tensor(mask, device=device)
    return swim.kill_mask(s, mask_d), mask_d


def mid_drain(params, device, frac: float = FRACTION, seed: int = SEED,
              every: int = 16):
    """The row replayed from its kill to mid-drain, the first `every`-tick
    boundary at which the bulk channel's members average a coverage of
    0.5 or more: that state, the next bulk step's input."""
    s, mask = start(params, frac, seed, device)
    for _ in range(0, 4096, every):
        s, _, _ = run_chunk(params, s, every, mask)
        members = s.bulk_member
        if bool(members.any()) and float(s.bulk_cov[members].mean()) >= 0.5:
            return s
    raise RuntimeError("the correlated replay never reached mid-drain")


def run_row(params, frac: float, max_ticks: int, chunk: int, seed: int,
            device, gossip: GossipConfig) -> dict:
    """One (slots, fraction) row: chunks from the kill until recall >=
    0.999 or max_ticks.  The row carries the recall and fp curves."""
    n = params.n_nodes
    s, mask_d = start(params, frac, seed, device)
    k = int(mask_d.sum())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    syncs0, bulk0 = swim.host_syncs, swim.bulk_steps
    k14_0 = kernels.LAUNCHES["bulk_step"]
    t0 = time.perf_counter()
    ticks = 0
    rec_curve, fp_curve = [], []
    conv_tick = None
    while ticks < max_ticks:
        s, rec, fp = run_chunk(params, s, chunk, mask_d)
        rec = rec.cpu().numpy()
        fp = fp.cpu().numpy()
        rec_curve.extend(rec.tolist())
        fp_curve.extend(fp.tolist())
        ticks += chunk
        if conv_tick is None and (rec >= 0.99).any():
            conv_tick = ticks - chunk + int(np.argmax(rec >= 0.99)) + 1
        if rec[-1] >= 0.999:
            break
    wall = time.perf_counter() - t0
    tick_s = gossip.gossip_interval
    return {
        "nodes": n, "killed": k, "fraction": frac,
        "rumor_slots": params.rumor_slots,
        "recall_final": float(rec_curve[-1]),
        "conv_ticks_99": conv_tick,
        "conv_seconds_99": conv_tick * tick_s if conv_tick else None,
        "false_positives_max": int(max(fp_curve)),
        "ticks_run": ticks, "wall_seconds": wall,
        # flag reads (the probe tick's one sync) plus one readback per chunk
        "host_syncs_per_tick":
            (swim.host_syncs - syncs0 + 2 * (ticks // chunk)) / ticks,
        # ticks that ran the bulk channel, and K14's launches among them
        # (every one on a card, none on the CPU)
        "bulk_ticks": swim.bulk_steps - bulk0,
        "bulk_step_launches": kernels.LAUNCHES["bulk_step"] - k14_0,
        "committed_victims": int(s.committed_dead[mask_d].sum()),
        "bulk_pending": int(s.bulk_member.sum()),
        "recall_curve": rec_curve, "fp_curve": fp_curve,
    }


def run(nodes: int = 1_000_000, fractions=(0.001, 0.01), rumor_slots=(32,),
        max_ticks: int = 4096, chunk: int = 256, seed: int = SEED,
        device=None) -> list:
    """Every (slots, fraction) row, on the card unless a device is named."""
    device = devices.resolve(device)
    gossip = GossipConfig.lan()
    rows = []
    for slots in rumor_slots:
        params = bench_params(nodes, slots, seed)
        for frac in fractions:
            rows.append(run_row(params, frac, max_ticks, chunk, seed, device,
                                gossip))
    return rows


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--fractions", type=float, nargs="+",
                    default=[0.001, FRACTION])
    ap.add_argument("--rumor-slots", type=int, nargs="+", default=[32])
    ap.add_argument("--max-ticks", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=256,
                    help="ticks between host readbacks")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "correlated.json"))
    args = ap.parse_args(argv)
    device = devices.resolve(args.device)
    where = card(device)
    rows = run(args.nodes, args.fractions, args.rumor_slots, args.max_ticks,
               args.chunk, args.seed, device)
    for row in rows:
        brief = {k: v for k, v in row.items()
                 if k not in ("recall_curve", "fp_curve")}
        print(json.dumps({"metric": "correlated_failure_recall99_s",
                          "value": row["conv_seconds_99"], "unit": "s",
                          "device": where, "detail": brief}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": where, "results": rows,
                   "gossip_interval_s": GossipConfig.lan().gossip_interval},
                  f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
