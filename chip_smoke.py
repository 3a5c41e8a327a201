#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consul_tpu_torch) on one NVIDIA card.

    python chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

  1. build: the card's name and power limit, torch/CUDA versions, and
     the kernels built from consul_tpu_torch/kernels/csrc (timed);
  2. main path: the north-star pipeline — a 1M-node serf pool, warm
     scan, kill, timed scans with the per-tick convergence monitor — run
     through `consul_tpu_torch.bench.run_convergence` with every kernel's
     launch count zeroed just before and read just after.  It must
     converge with F1 1.0, no false commits, every kernel launched, and
     in the JAX package's tick count for the same seed (measured with
     reference_ticks.py, recorded below);
  3. kernels: each kernel against its plain PyTorch twin on the card, at
     the main path's shapes (N=1M, S=U=32, G=3) and on random inputs
     (including a 40-slot table, which takes the second 32-slot pass),
     bit-equal, with kernel and plain times (median of 20 CUDA-event-
     timed runs) and the least time the card could take for the same
     work.

Prints, before the last line, one JSON object with every kernel's
numbers, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

from consul_tpu_torch import bench, kernels
from consul_tpu_torch.kernels import build
from consul_tpu_torch.models import serf, swim
from consul_tpu_torch.ops import gossip, rolls
from consul_tpu_torch.utils import prng

N = 1_000_000
# The JAX package's bench.run_convergence(n_nodes=1_000_000) on the CPU
# (seed 7, victim 123456, 200-tick scans):
# `JAX_PLATFORMS=cpu python reference_ticks.py 1000000` -> 136
REFERENCE_TICKS = 136

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): 3.35 TB/s of
# HBM3; 67 TFLOP/s float32 outside the tensor cores counts an FMA as two
# operations, i.e. 33.5e12 lane instructions/s, and the int32 pipes run
# at half the float32 lane rate: 16.75e12 integer operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# threefry2x32 per element: 20 rounds of add/rotate/xor (60), 5 key
# injections (15), counter split, key schedule, xor fold and the uniform
# mantissa trick (~10)
THREEFRY_OPS_PER_ELEMENT = 85


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main_path(dev) -> dict:
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    syncs0 = swim.host_syncs
    r = bench.run_convergence(n_nodes=N, device=dev)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    ticks_run = r["state"].swim.tick
    log(f"main path: converged={r['converged']} ticks={r['ticks']} "
        f"frac={r['frac']} wall_s={r['wall']} warm_s={r['warm_s']} "
        f"f1={r['f1']} false_commits={r['false_commits']}")
    log(f"main path: timed ticks run={r['timed_ticks_run']} ms_per_tick="
        f"{1000.0 * r['wall'] / r['timed_ticks_run']} host_syncs_per_tick="
        f"{r['host_syncs'] / r['timed_ticks_run']} (all {ticks_run} ticks: "
        f"{(swim.host_syncs - syncs0) / ticks_run} flag syncs per tick) "
        f"peak_mem_bytes={peak}")
    log(f"main path: launches={launches} (timed window: {r['launches']})")
    log("main path: sim_counters=" + json.dumps(r["sim_counters"]))
    log(f"main path: JAX reference ticks={REFERENCE_TICKS} port ticks="
        f"{r['ticks']}")
    require(r["converged"], "main path did not converge")
    require(r["ticks"] == REFERENCE_TICKS,
            f"tick count {r['ticks']} != JAX {REFERENCE_TICKS}")
    require(r["f1"] == 1.0, f"f1 {r['f1']}")
    require(r["false_commits"] == 0, f"false commits {r['false_commits']}")
    for name in kernels.KERNELS:
        require(launches[name] > 0, f"{name} never launched on the main path")
    r["all_launches"] = launches
    r["peak_mem_bytes"] = peak
    return r


def count_syncs(params, state, ticks: int = 10) -> dict:
    """Host syncs per tick, as torch's sync debug mode sees them: every
    synchronizing CUDA call warns.  A gossip-only tick must take none."""
    counts = {"probe": [0, 0], "gossip": [0, 0]}     # syncs, ticks
    out = torch.empty(1, dtype=torch.float32, device=state.swim.device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(ticks):
            kind = ("probe" if state.swim.tick % params.swim.probe_period_ticks
                    == 0 else "gossip")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state = serf.step(params, state)
                swim.believed_down_fraction(params.swim, state.swim,
                                            bench.VICTIM, out=out)
            counts[kind][0] += sum("synchroniz" in str(w.message)
                                   for w in caught)
            counts[kind][1] += 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_tick = {k: v[0] / max(v[1], 1) for k, v in counts.items()}
    log(f"host syncs per tick (sync debug mode, {ticks} ticks): {per_tick}")
    require(counts["gossip"][1] > 0 and counts["gossip"][0] == 0,
            f"gossip-only ticks synchronized: {counts}")
    return per_tick


def check_threefry(dev, launches: int) -> dict:
    key = prng.tick_key(7, 12345, 5)
    shape = (N, 3)
    n = N * 3
    got = prng.bits(key, shape, dev)
    want = prng.threefry_bits_plain(key, n, dev).reshape(shape)
    require(torch.equal(got, want), "threefry_bits (bits) != plain")
    u_got = prng.uniform(key, shape, dev)
    u_want = torch.clamp_min(prng._unit_floats(want), 0.0)
    require(torch.equal(u_got.view(torch.int32), u_want.view(torch.int32)),
            "threefry_bits (uniform) != plain")
    big = (N, 8)                      # the Vivaldi normal draw of a probe tick
    require(torch.equal(prng.bits(key, big, dev),
                        prng.threefry_bits_plain(key, N * 8, dev).reshape(big)),
            "threefry_bits [N, 8] != plain")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    ms = median_ms(lambda: kernels.launch_threefry(key, n, 1, out))
    plain_ms = median_ms(lambda: prng._unit_floats(
        prng.threefry_bits_plain(key, n, dev)))
    bytes_ = 4 * n
    ops = THREEFRY_OPS_PER_ELEMENT * n
    bound = max(bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1000.0
    return {"name": "threefry_bits", "route": "cuda",
            "source": "consul_tpu_torch/kernels/csrc/threefry.cu",
            "replaces": "consul_tpu/utils/prng.py:14",
            "launches": launches,
            "max_abs_err": float((u_got - u_want).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops / INT32_OPS_PER_S
            > bytes_ / HBM_BYTES_PER_S else "bytes",
            "library_ms": None,
            "shape": list(shape), "mode": "uniform float32"}


def _gossip_inputs(params, s, tick: int):
    n = params.n_nodes
    offs = rolls.offsets(prng.tick_key(params.seed, tick, 2), n,
                         params.gossip_nodes, s.device)
    ok = gossip.loss_mask(prng.tick_key(params.seed, tick, 5), params.p_loss,
                          n, params.gossip_nodes, s.device)
    return (offs, s.know, s.sends_left, s.up, s.up & s.member, s.r_active,
            params.retransmit_limit, ok)


def _random_gossip_inputs(dev, n: int, slots: int, g: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    know = rnd(n, slots) < 0.3
    sends = (rnd(n, slots) * 8).to(torch.int8)
    offs = torch.tensor([1, n // 3, n - 7], dtype=torch.int32, device=dev)
    return (offs, know, sends, rnd(n) < 0.95, rnd(n) < 0.95,
            rnd(slots) < 0.9, 12, rnd(n, g) < 0.99)


def check_gossip(dev, params, s, launches: int) -> dict:
    for args in (_gossip_inputs(params, s, s.tick),
                 _random_gossip_inputs(dev, N, params.rumor_slots,
                                       params.gossip_nodes),
                 _random_gossip_inputs(dev, 100_003, 40, params.gossip_nodes)):
        got = gossip.disseminate_kernel(*args)
        want = gossip.disseminate_plain(*args)
        for name in ("know", "sends_left", "newly"):
            require(torch.equal(getattr(got, name), getattr(want, name)),
                    f"gossip_disseminate {name} != plain")
        for name in ("delivered", "served", "lost"):
            require(float(getattr(got, name)) == float(getattr(want, name)),
                    f"gossip_disseminate counter {name}: "
                    f"{float(getattr(got, name))} != {float(getattr(want, name))}")
    args = _gossip_inputs(params, s, s.tick)
    ms = median_ms(lambda: gossip.disseminate_kernel(*args))
    plain_ms = median_ms(lambda: gossip.disseminate_plain(*args))
    n, slots = s.know.shape
    g = params.gossip_nodes
    bytes_ = (2 * n * slots + 4 * g + 2 * n + slots + n * g    # inputs
              + 3 * n * slots + 12)                            # outputs
    return {"name": "gossip_disseminate", "route": "cuda",
            "source": "consul_tpu_torch/kernels/csrc/gossip.cu",
            "replaces": "consul_tpu/ops/gossip.py:45",
            "launches": launches, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1000.0,
            "bound_by": "bytes", "library_ms": None,
            "shape": [n, slots, g]}


def _random_swim_state(dev, s, subject: int, n: int, u: int):
    """Random monitor inputs of [n, u] (other leaves cut to n rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    r_subject = torch.where(rnd(u) < 0.6, subject,
                            (rnd(u) * n).to(torch.int32)).to(torch.int32)
    return s.replace(
        tick=40_000,
        know=rnd(n, u) < 0.3,
        learn_tick=((rnd(n, u) * 65536) - 32768).to(torch.int16),
        up=rnd(n) < 0.97, member=rnd(n) < 0.98,
        committed_dead=torch.zeros(n, dtype=torch.bool, device=dev),
        committed_left=torch.zeros(n, dtype=torch.bool, device=dev),
        committed_inc=(rnd(n) * 2).to(torch.int32),
        bulk_member=torch.zeros(n, dtype=torch.bool, device=dev),
        bulk_cov=torch.zeros(n, dtype=torch.float32, device=dev),
        r_active=rnd(u) < 0.8, r_kind=(rnd(u) * 4).to(torch.int8),
        r_subject=r_subject, r_inc=(rnd(u) * 4).to(torch.int32),
        r_confirm=(rnd(u) * 65).to(torch.int8))


def check_monitor(dev, params, s, subject: int, launches: int) -> dict:
    n, u = s.know.shape
    for state in (s, _random_swim_state(dev, s, subject, n, u),
                  _random_swim_state(dev, s, subject, 200_003, 40)):
        got = swim.believed_down_fraction(params, state, subject)
        want = swim.believed_down_fraction_plain(params, state, subject)
        require(torch.equal(got.reshape(()).view(torch.int32),
                            want.reshape(()).view(torch.int32)),
                f"believed_down {float(got)} != plain {float(want)}")
    out = torch.empty(1, dtype=torch.float32, device=dev)
    is_dl, is_s, is_a, timeout16 = swim._monitor_slots(params, s, subject)
    ms = median_ms(lambda: kernels.launch_believed_down(
        s.know, s.learn_tick, s.up, s.member, is_dl, is_s, is_a, s.r_inc,
        timeout16, s.committed_dead, s.committed_left, s.committed_inc,
        s.bulk_member, s.bulk_cov, subject, swim._t16(s.tick), out))
    plain_ms = median_ms(lambda: swim.believed_down_fraction_plain(
        params, s, subject))
    suspect_cells = int((s.know & is_s[None, :]).sum())
    bytes_ = n * u + 2 * n + 2 * suspect_cells + 9 * u + 4
    return {"name": "believed_down", "route": "cuda",
            "source": "consul_tpu_torch/kernels/csrc/monitor.cu",
            "replaces": "consul_tpu/models/swim.py:533",
            "launches": launches,
            "max_abs_err": float((got - want).abs().max()),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1000.0,
            "bound_by": "bytes", "library_ms": None,
            "shape": [n, u], "suspect_cells": suspect_cells}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernel build: {build.last_build_seconds:.3f} s compile, "
        f"{time.perf_counter() - t0:.3f} s to load")
    for src, report in sorted(build.ptxas_report.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    r = main_path(dev)

    syncs = count_syncs(r["params"], r["state"])
    params, s = r["params"].swim, r["state"].swim
    launches = r["all_launches"]
    results = [
        check_threefry(dev, launches["threefry_bits"]),
        check_gossip(dev, params, s, launches["gossip_disseminate"]),
        check_monitor(dev, params, s, bench.VICTIM, launches["believed_down"]),
    ]
    for k in results:
        log(f"kernel {k['name']}: ms={k['ms']} plain_ms={k['plain_ms']} "
            f"bound_ms={k['bound_ms']} ({k['bound_by']}) launches="
            f"{k['launches']} library_ms=none (no single PyTorch call "
            f"computes this function)")
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": results,
              "main_path": {"ticks": r["ticks"], "wall_s": r["wall"],
                            "timed_ticks_run": r["timed_ticks_run"],
                            "host_syncs": r["host_syncs"],
                            "syncs_per_tick": syncs,
                            "peak_mem_bytes": r["peak_mem_bytes"],
                            "launches": r["all_launches"],
                            "sim_counters": r["sim_counters"]}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
