#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consul_tpu_torch) on one NVIDIA card.

    python chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

  1. build: the card's name and power limit, torch/CUDA versions, the
     kernels built from consul_tpu_torch/kernels/csrc (timed), and the
     SASS census of K1: threefry.cu compiled once per mode and its
     instructions counted (`cuobjdump -sass`), the operation count of
     each mode's bound;
  2. main path: the north-star pipeline — a 1M-node serf pool, warm
     scan, kill, timed scans with the per-tick convergence monitor — run
     through `consul_tpu_torch.bench.run_convergence` with every kernel's
     launch count zeroed just before and read just after.  It must
     converge with F1 1.0, no false commits, every kernel (and each of
     K1's uniform, exponential and randint modes, but no normal: K13
     draws observe_ring's) launched, K13 once a probe tick, and in the
     JAX package's tick count for the same seed (measured with
     reference_ticks.py, recorded below).  Phases 2-10 run while
     swim_twin_calls() counts K7-K14's plain twins on CUDA states: none
     may run;
  3. (the host syncs and device kernels per tick that this phase gated
     are the serf.scan and serf.step entries' contracts, judged in
     phase 14);
  4. kernels: each kernel against its plain PyTorch twin on the card,
     bit-equal, at the main path's shapes (N=1M, S=U=32, G=3).  K1 mode
     by mode ([N, 3] uniform and bits, [N] exponential, [N, 8] normal —
     which must be one device kernel —, [3] and [4] randint) and the
     probe round's seven draws in one launch, equal to each drawn alone.
     K2 and K3 at two states of the 1M run — mid-convergence (the first
     tick whose believed-down fraction passes 0.5, replayed from the
     seed) and the final state — and on random inputs (including a
     40-slot table, which takes the 64-bit word path).  K2 is held for
     both callers: swim (learn-tick stamp and counters fused) and events
     (`newly`, after firing an event at the final state).  It times each
     kernel's device time per call (CUDA events with the host's
     dispatch hidden behind a device-side sleep, inputs evicted from L2;
     K2's two phases apart from torch.profiler's kernel records), each
     wrapper call and each plain twin (median of CUDA-event-timed
     calls, host dispatch included), and the least time the card could
     take for the same work;
  5. oracle: the port's GossipOracle at full width (N=1M, U=32, 999,000
     joined), driven as a user would with every launch count zeroed just
     before: warmup (which must leave every leaf of the pool's state
     as it was), advance, the summary, a baseline delta and flap
     journal, three kills advanced until each reads failed, the delta and
     journal naming exactly those three, a page at offset 500,000,
     spawn, leave and a rejoin after a committed death with their
     statuses, coordinate, rtt, sort_by_rtt over 1,000 names and
     publish_sim_metrics; K4's three launches must have run.  Then K4
     against its plain twins on the card, bit-equal, on the oracle's
     state and on random states (U = 32 and 64, and U = 64 with every
     dead subject on an edge of K4's tiles, and U = 64 with dead
     subjects outside [0, N), which wrap once from [-N, 0) as JAX's
     scatter does and count nowhere else; k = 8, 256, 4096 and N,
     changed counts below and above k), each launch timed against its
     bound, its twin and the library call that computes the same, and
     the median wall time of each oracle read;
  6. nemesis: the chaos build through consul_tpu_torch.chaos's
     SwimChaosHarness — asym_degradation, loss_burst and crash_restart at
     N=1M (launch counts zeroed before each; crash_restart must
     re-converge and never commit a revived node; K2's chaos mode once
     per tick, the non-chaos exchange never), all four scenarios at N=256
     on the card and on the CPU with equal digests and flight rows (the
     JAX scenarios' size; partition_heal runs there only), and K2's chaos
     mode held bit-equal to its twin and timed (chaos_phase);
  7. correlated failures: consul_tpu_torch.correlated at N=1M, 1% killed
     (recall >= 0.999, no false positive, K5 once per tick, the bulk
     channel run, K14 once per bulk tick), K5 held bit-equal at the
     replayed mid-drain and drain-end states and on random states (U =
     16, 32, 64 and 100,003 x 40, no victims, all live, no live rows,
     column counts at and just below the 0.99 bar, dead subjects outside
     [0, N)), timed (kernel_ms, device_ms, and its instrumented build's
     stream and tail), host syncs per bulk tick, and the bench
     at N=4096 on the card and the CPU with equal curves
     (correlated_phase);
  8. federation: consul_tpu_torch.models.wan at 3 DCs x 50,000 nodes x 5
     servers, 16 rumor and event slots, driven as tools/scale_sweep.py's
     _dc_point drives it (scenarios.wan_point): an event fired at a
     non-server member of DC 0 covers every DC within 250 ticks, then DC
     2 crashed in the WAN pool reads unreachable and is committed dead
     within 1,000 ticks; the DC distance matrix is symmetric; host syncs
     per tick (none on an idle gossip-only tick), fenced ms and device
     kernels per gossip-only and probe tick; the DC series 2, 4, 8 x 128
     x 3 on the card and the CPU with equal coverage ticks.  K1, K2 and
     the top-k are held to their twins at the WAN pool's small shapes
     first (wan_phase);
  9. anti-entropy and K6: consul_tpu_torch.models.antientropy at 1M
     services over 100,000 agents (scenarios.ae_churn: one registration,
     the full push, 660 churn ticks with 1,000 agents down for 300 of
     them, a final step): in_sync_fraction 1.0, the catalog's live count
     the desired live count, K6 twice a step and once an in_sync read,
     its twins never; K6 bit-equal to its twins (the diff in its plain
     and step forms, the merge in step's and apply_push's) on the
     replayed states and on random tables (M != K, all or none pushed,
     all INVALID, every pushed id in the catalog, overflow, 2^21 rows)
     and boundary tables (interleaved equal ids, one desired row over a
     full catalog, M = 1, K = 1, odd sizes); both timed with the
     library's calls beside them (library_times) and the merge's phases
     from its instrumented build; the workload at 4,096 services on the
     card and the CPU with the same digest (ae_phase);
 10. Vivaldi: the standalone solver at 100,000 nodes, 8 dimensions, 400
     ticks (scenarios.vivaldi_converge): the median relative error under
     0.15 and under a third of the initial; the error curve, ms a tick,
     sort_by_distance's wall; at n = 4,096 the card's and the CPU's
     curves within VIVALDI_CURVE_RTOL (vivaldi_phase);
 11. the probe round and rumor origination: K7 and K8, which update
     the state they are given in place, against their twins, every leaf
     bit-equal (rtt_ms included), each kernel call on a clone of its
     input, on the main path's states, the 1M chaos and correlated states
     phases 6-7 leave, the federation's WAN pool, small pools on the card
     and random 1M states (evicting calls and joiner cells must occur);
     the leaves they write are the input's own tensors, and neither
     allocates an [N, U] block; then timed beside their bounds, the twins
     and torch.topk of the wants, K8's phases from its instrumented
     build; the main path's fenced probe and gossip-only ticks
     (probe_phase).  Every state the script reads again after a step, a
     command or a kernel that consumes it is a clone (_clone);
 12. the rest of the probe tick's detector passes: K9 (the subject maps,
     map_add, maps_convert), K10 (suspicion expiry) and K11 (the dense
     expiry around K8), which update the state they are given in place,
     and K12 (refutation, expire), all updating the state they are given
     in place, against their twins, every leaf bit-equal, each kernel
     call on a clone of its input, along whole probe ticks from the main
     path's states (the kill, mid-convergence, the end, and the first
     ticks of its replay that converted a slot, refuted and freed one),
     the correlated run's overflow tick and evicting state (stale maps),
     the 1M chaos states, the WAN pool and small pools on the card (U =
     64 among them) and random 1M states (dead rumors refuted, two slots
     of one subject refuting, no LHA, wrapped int16 ages); K9's map_add
     and maps_convert, each on a copy of its maps, return the copy's own
     tensors and allocate nothing; the leaves K10-K12 write are the
     input's own tensors, and none allocates an [N, U] block; K12's
     expire captured in a CUDA graph and replayed; then timed beside
     their bounds, the twins and, for K9, the library's calls (four full
     + scatter_reduce_ for the build, one scatter_reduce for map_add),
     K12 also at the first probe ticks that refuted and freed a slot
     (detector_phase);
 13. the Vivaldi ring observation and the bulk channel: K13 against
     observe_ring_plain, every leaf within K13_ULP_BOUND (0) ulp, on the
     main path's first probe tick (every row colocated, so the 0-ulp
     coordinates hold its fused normal draws to prng.normal's), at the
     kill, mid-convergence, its end and on random 1M states; K14 (one
     cooperative launch, in place) against _bulk_step_plain (bool leaves
     equal, float leaves within BULK_RTOL of scale, two launches on
     clones bit-equal, the state returned the clone itself, no
     allocation) on the correlated run's overflow tick and the empty
     channel it starts from, mid-drain, the first committing tick after
     it, the drain's end and random 1M states in the main and chaos
     builds (revive clamps, an empty channel); K14 replayed from a CUDA
     graph bit-equal to a launch, one device kernel and no K1 a call;
     then both timed beside their bounds, twins and wrapper calls, K14
     also on an empty channel and in the chaos build
     (vivaldi_bulk_phase);
 14. contracts: the program-contract registry
     (consul_tpu_torch/parallel/kernel_audit.py) measured at full width
     and judged by `kernel_lint` against the committed cuda records of
     KERNELBUDGET_r01.json: each entry's kernels and launches per call
     (a gossip-only tick's one K1 batch and no int64 elementwise kernel,
     a probe tick's K7-K13 launches, a summary read one K4 launch and a
     delta two, a bulk tick's K14, K5 one kernel and no allocation, K6's
     merge one kernel and three allocations), host syncs, the leaves it
     updates in place, bytes per node slot, peak bytes and allocations,
     one library load, O(page) reads, registry parity over every launch
     site, and every hand-written kernel launched by some entry
     (contracts_phase).

Prints, before the last line, one JSON object with every kernel's
numbers, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from consul_tpu_torch import (bench, chaos, correlated, host, kernels,
                              profile_tick, scenarios as workloads)
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.oracle import GossipOracle
from consul_tpu_torch.profile_tick import kernel_ms, median_ms, wall_ms
from consul_tpu_torch.kernels import build
from consul_tpu_torch.models import (antientropy, events, serf, swim,
                                     vivaldi, wan)
from consul_tpu_torch.ops import gossip, reconcile, rolls
from consul_tpu_torch.parallel import kernel_audit, kernel_lint
from consul_tpu_torch.utils import prng

N = 1_000_000
# The JAX package's bench.run_convergence(n_nodes=1_000_000) on the CPU
# (seed 7, victim 123456, 200-tick scans):
# `JAX_PLATFORMS=cpu python reference_ticks.py 1000000` -> 136
REFERENCE_TICKS = 136

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): 3.35 TB/s of
# HBM3; 67 TFLOP/s float32 outside the tensor cores counts an FMA as two
# operations, i.e. 33.5e12 32-bit lane instructions/s.  Integer work is
# held to that lane rate: the compiler issues integer adds as IMAD on the
# FMA pipes beside the INT32 pipe, and K1 measured faster than the INT32
# pipe's own 16.75e12/s allows, so that rate is no floor.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# SASS instructions per element of each K1 mode, counted in this run
# (draw_census); K2's loss draw costs what K1's uniform does
SASS_PER_ELEMENT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _clone(x):
    """A copy of a swim, serf or federation state with tensors of its own.
    On the card a probe tick or a command consumes its state (K7 and K8
    update it in place), so every state this script reads again after
    handing it to a step, a command or a kernel is cloned first."""
    if isinstance(x, wan.WanState):
        return x.replace(lan=tuple(c.clone() for c in x.lan),
                         wan=x.wan.clone())
    return x.clone()


def main_path(dev) -> dict:
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    syncs0 = swim.host_syncs
    r = bench.run_convergence(n_nodes=N, device=dev)
    launches = dict(kernels.LAUNCHES)
    draw_launches = dict(kernels.DRAW_LAUNCHES)
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
    log(f"main path: launches={launches} (timed window: {r['launches']}); "
        f"K1 launches carrying each mode: {draw_launches}")
    log("main path: sim_counters=" + json.dumps(r["sim_counters"]))
    log(f"main path: JAX reference ticks={REFERENCE_TICKS} port ticks="
        f"{r['ticks']}")
    require(r["converged"], "main path did not converge")
    require(r["ticks"] == REFERENCE_TICKS,
            f"tick count {r['ticks']} != JAX {REFERENCE_TICKS}")
    require(r["f1"] == 1.0, f"f1 {r['f1']}")
    require(r["false_commits"] == 0, f"false commits {r['false_commits']}")
    for name in kernels.MAIN_PATH + kernels.PROBE + kernels.DETECTOR \
            + ("vivaldi_ring",):
        require(launches[name] > 0, f"{name} never launched on the main path")
    require(launches["gossip_exchange_chaos"] == 0,
            "the main path ran K2's chaos mode")
    # K13 once a probe tick (K7's count: one a probe tick, phase 3), its
    # spring directions drawn inside it, so no K1 normal on the main path
    require(launches["vivaldi_ring"] == launches["probe_round"],
            f"K13 launched {launches['vivaldi_ring']} times in "
            f"{launches['probe_round']} probe ticks")
    require(launches["bulk_step"] == 0, "the main path ran the bulk channel")
    for mode in ("uniform", "exponential", "randint"):
        require(draw_launches[mode] > 0,
                f"K1 {mode} never launched on the main path")
    require(draw_launches["normal"] == 0,
            f"the main path drew {draw_launches['normal']} K1 normals (K13 "
            f"draws observe_ring's)")
    r["all_launches"] = launches
    r["draw_launches"] = draw_launches
    r["peak_mem_bytes"] = peak
    return r


def count_syncs(tick, state, tick_of, period: int, ticks: int = 10) -> dict:
    """Host syncs per probe and per gossip-only tick, as torch's sync debug
    mode sees them: every synchronizing CUDA call warns.  `tick(state, t)`
    runs tick t (the step and its per-tick monitor) and returns the state;
    `tick_of(state)` is the state's tick number."""
    counts = {"probe": [0, 0], "gossip": [0, 0]}     # syncs, ticks
    state = _clone(state)
    for t in range(ticks):
        kind = "probe" if tick_of(state) % period == 0 else "gossip"
        box: dict = {}
        with kernel_audit.counting_syncs(box):
            state = tick(state, t)
        counts[kind][0] += box["syncs"]
        counts[kind][1] += 1
    require(counts["gossip"][1] > 0, f"no gossip-only tick counted: {counts}")
    return {k: v[0] / max(v[1], 1) for k, v in counts.items()}


def device_ms(fn, names, reps: int = 20, tries: int = 3,
              make=None) -> dict:
    """Mean device ms per launch of each named kernel over `reps` calls of
    fn, from torch.profiler's kernel records: the kernel's own time,
    without the host dispatch that a CUDA-event timing of one call also
    holds when the call is host-bound, with the L2-evicting read of
    kernel_ms before each call.  With `make`, fn takes an input make()
    builds before the capture (a clone of a state fn consumes).  A
    profile whose records miss a named kernel is taken again (up to
    `tries` profiles); the kernel ran either way."""
    flush = profile_tick._flush()
    call, make = profile_tick._calls(fn, make)
    for _ in range(3):
        call(make())
    for attempt in range(tries):
        inputs = [make() for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                flush.max()
                call(x)
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for name in names:
                if name in ev.key:
                    dt = getattr(ev, "device_time_total", None)
                    if dt is None:
                        dt = ev.cuda_time_total
                    out[name] = dt / ev.count / 1000.0
        if set(out) == set(names):
            return out
        log(f"profile {attempt + 1} of {tries} saw {sorted(out)} of {names}")
    raise AssertionError(f"torch.profiler recorded none of {names} in "
                         f"{tries} profiles")


_FLUSH_KEYS: set = set()


def device_total_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Mean device ms of one call of fn: every device record
    torch.profiler takes of the call (kernels, copies, memsets) summed,
    with kernel_ms's L2-evicting read before each call and its own
    records left out.  For the library calls timed beside the kernels,
    whose kernels have no names to ask device_ms for."""
    flush = profile_tick._flush()
    if not _FLUSH_KEYS:
        flush.max()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flush.max()
            torch.cuda.synchronize()
        _FLUSH_KEYS.update(profile_tick._device_times(prof))
    for _ in range(3):
        fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.max()
                fn()
            torch.cuda.synchronize()
        us = [t for k, (t, _) in profile_tick._device_times(prof).items()
              if k not in _FLUSH_KEYS]
        if us:
            return sum(us) / reps / 1000.0
        log(f"profile {attempt + 1} of {tries} saw no device record")
    raise AssertionError(f"torch.profiler recorded no device work in "
                         f"{tries} profiles")


def library_times(fn) -> dict:
    """A library call timed as the kernels are: library_ms (kernel_ms:
    dispatch hidden, L2 evicted), library_device_ms (the profiler's
    records of the call), and library_call_ms (median_ms: dispatch
    included, L2 warm; the one figure PRs 1-13 gave)."""
    return {"library_ms": kernel_ms(fn), "library_device_ms": device_total_ms(fn),
            "library_call_ms": median_ms(fn)}


# K1's draws at N = 1M: (mode, the draw, the JAX draw it replaces).
# randint [3] is every tick's gossip offsets, [4] the probe round's; [N, 3]
# the probe round's relay legs; [N] its RTT jitter; [N, 8] the normal of
# the Vivaldi solver's observe (phase 10; observe_ring's is K13's).
K1_KEY = prng.tick_key(7, 12345, 5)
K1_DRAWS = (
    ("uniform", prng.Draw("uniform", K1_KEY, (N, 3)),
     "consul_tpu/models/swim.py:776"),
    ("exponential", prng.Draw("exponential", K1_KEY, (N,)),
     "consul_tpu/models/swim.py:757"),
    ("normal", prng.Draw("normal", K1_KEY, (N, 8)),
     "consul_tpu/models/vivaldi.py:121"),
    ("randint", prng.Draw("randint", K1_KEY, (3,), 1, N),
     "consul_tpu/ops/rolls.py:27"),
    ("randint", prng.Draw("randint", K1_KEY, (4,), 1, N),
     "consul_tpu/ops/rolls.py:27"),
    ("bits", prng.Draw("bits", K1_KEY, (N, 3)), "consul_tpu/utils/prng.py:14"),
)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between the int32 views of a and b: units in the
    last place for float32 (of one sign), the difference for int32."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def _draw_bound(draws, per_element: dict) -> tuple:
    """Least ms of K1 for these draws: the larger of the bytes written
    over the HBM rate and the SASS instructions over the lane rate."""
    n = sum(int(torch.Size(d.shape).numel()) for d in draws)
    ops = sum(per_element[d.kind] * torch.Size(d.shape).numel() for d in draws)
    bytes_ = 4 * n
    by_ops = ops / INT32_OPS_PER_S > bytes_ / HBM_BYTES_PER_S
    return (max(bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1000.0,
            "operations" if by_ops else "bytes")


def check_draws(dev, params, tick: int, per_element: dict,
                launches: dict) -> tuple:
    """K1 against its plain twin on the card, mode by mode at the main
    path's shapes and for the probe round's draws at `tick` (one launch);
    times and bounds.  Returns (the kernels-line entries, the record)."""
    timed = {}
    for mode, d, _ in K1_DRAWS:
        got = prng.draw([d], dev)[0]
        want = prng.draw_plain([d], dev)[0]
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"K1 {mode} {d.shape}: {got.dtype} {tuple(got.shape)}")
        ulp = _ulps(got, want)
        require(ulp == 0, f"K1 {mode} {d.shape} != plain: {ulp} ulp apart")
        err = float((got.double() - want.double()).abs().max())
        segs = prng.draw_segments([d], dev)[1]
        bound, by = _draw_bound([d], per_element)
        t = {"max_ulp": ulp, "max_abs_err": err,
             "ms": kernel_ms(lambda: kernels.launch_draws(segs)),
             "profiler_ms": device_ms(lambda: kernels.launch_draws(segs),
                                      ("threefry_draws_kernel",))[
                                          "threefry_draws_kernel"],
             "call_ms": median_ms(lambda: prng.draw([d], dev)),
             "plain_ms": median_ms(lambda: prng.draw_plain([d], dev), reps=5),
             "bound_ms": bound, "bound_by": by,
             "sass_per_element": per_element[mode]}
        t["share"] = t["bound_ms"] / t["ms"]
        key = f"{mode} {list(d.shape)}"
        timed[key] = t
        log(f"K1 {key}: " + json.dumps(t))
    # the probe round's draws: one launch equals the draws made alone
    draws = list(swim._probe_draws(params, tick).values())
    together = prng.draw(draws, dev)
    for d, t in zip(draws, together):
        alone = prng.draw([d], dev)[0]
        plain = prng.draw_plain([d], dev)[0]
        require(torch.equal(t.view(torch.int32), alone.view(torch.int32)),
                f"K1 multi-segment {d.kind} {d.shape} != its draw alone")
        require(torch.equal(t.view(torch.int32), plain.view(torch.int32)),
                f"K1 multi-segment {d.kind} {d.shape} != plain")
    segs = prng.draw_segments(draws, dev)[1]
    alone = [prng.draw_segments([d], dev)[1] for d in draws]
    bound, by = _draw_bound(draws, per_element)
    multi = {"segments": len(draws), "elements": sum(
        int(torch.Size(d.shape).numel()) for d in draws),
        "ms": kernel_ms(lambda: kernels.launch_draws(segs)),
        "separate_launches_ms": kernel_ms(
            lambda: [kernels.launch_draws(s) for s in alone]),
        "call_ms": median_ms(lambda: prng.draw(draws, dev)),
        "plain_ms": median_ms(lambda: prng.draw_plain(draws, dev), reps=5),
        "bound_ms": bound, "bound_by": by}
    multi["share"] = multi["bound_ms"] / multi["ms"]
    log("K1 probe-round draws, one launch: " + json.dumps(multi))
    # a normal [N, 8] is one K1 launch (the wrapper's count) and no other
    # device kernel (the profiler's records)
    normal = profile_tick.kernels_of(lambda: prng.normal(K1_KEY, (N, 8), dev))
    k1_before = kernels.LAUNCHES["threefry_draws"]
    prng.normal(K1_KEY, (N, 8), dev)
    k1 = kernels.LAUNCHES["threefry_draws"] - k1_before
    log(f"K1 normal [N, 8]: {k1} K1 launch, device kernels {normal}")
    require(k1 == 1 and all("threefry_draws_kernel" in k for k in normal),
            f"normal [N, 8] is not one K1 launch: {k1} launches, {normal}")
    entries = []
    for mode, d, replaces in K1_DRAWS:
        if mode == "bits" or (mode == "randint" and d.shape != (3,)):
            continue        # bits is not on the main path; randint [4] below
        t = timed[f"{mode} {list(d.shape)}"]
        e = {"name": f"threefry_draws.{mode}", "route": "cuda",
             "source": "consul_tpu_torch/kernels/csrc/threefry.cu",
             "replaces": replaces, "launches": launches[mode],
             "max_abs_err": t["max_abs_err"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": None,
             "call_ms": t["call_ms"], "share": t["share"],
             "profiler_ms": t["profiler_ms"],
             "max_ulp": t["max_ulp"],
             "sass_per_element": t["sass_per_element"],
             "shape": list(d.shape)}
        if mode == "randint":
            e["shape_4"] = timed["randint [4]"]
        entries.append(e)
    return entries, {"draws": timed, "probe_round_one_launch": multi,
                     "normal_kernels": normal}


def _swim_gossip_call(params, s) -> dict:
    """The swim caller's K2 arguments at state s (stamp and counters)."""
    return dict(
        offs=rolls.offsets(prng.tick_key(params.seed, s.tick, 2),
                           params.n_nodes, params.gossip_nodes, s.device),
        know=s.know, sends_left=s.sends_left, sender_ok=s.up,
        receiver_ok=s.up & s.member, slot_active=s.r_active,
        retransmit_limit=params.retransmit_limit, p_loss=params.p_loss,
        key=prng.tick_key(params.seed, s.tick, 5), learn_tick=s.learn_tick,
        tick16=swim._t16(s.tick), ctr=s.ctr, want_newly=False)


def _events_gossip_call(params, ev, up, member) -> dict:
    """The events caller's K2 arguments (newly, no stamp)."""
    p = params.events
    return dict(
        offs=rolls.offsets(prng.tick_key(p.seed, ev.tick, 3), p.n_nodes,
                           p.gossip_nodes, ev.know.device),
        know=ev.know, sends_left=ev.sends_left, sender_ok=up,
        receiver_ok=up & member, slot_active=ev.e_active,
        retransmit_limit=min(p.retransmit_limit, 127), p_loss=p.p_loss,
        key=prng.tick_key(p.seed, ev.tick, 6))


def _random_gossip_call(dev, n: int, slots: int, fanout=None,
                        seed: int = 1234) -> dict:
    """Random rows with every optional output asked for; offsets 1, N/3
    and N - 7, or with `fanout` that many drawn as a tick draws them (the
    fixed ones do not fit a pool of a few rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    know = rnd(n, slots) < 0.3
    offs = torch.tensor([1, n // 3, n - 7], dtype=torch.int32, device=dev) \
        if fanout is None else rolls.offsets(prng.tick_key(seed, 3, 2), n,
                                             fanout, dev)
    return dict(
        offs=offs,
        know=know, sends_left=(rnd(n, slots) * 8).to(torch.int8),
        sender_ok=rnd(n) < 0.95, receiver_ok=rnd(n) < 0.95,
        slot_active=rnd(slots) < 0.9, retransmit_limit=12, p_loss=0.01,
        key=(0x1234, 0xBEEF),
        learn_tick=((rnd(n, slots) * 65536) - 32768).to(torch.int16),
        tick16=-1234, ctr=rnd(5) * 1000, want_newly=True)


def _hold_gossip(call: dict, what: str) -> dict:
    got = gossip.disseminate_kernel(**call)
    want = gossip.disseminate_plain(**call)
    for name in ("know", "sends_left", "newly", "learn_tick", "ctr"):
        a, b = getattr(got, name), getattr(want, name)
        require((a is None) == (b is None), f"gossip {what}: {name} presence")
        if a is not None:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
                if a.dtype == torch.float32 else torch.equal(a, b)
            require(same, f"gossip {what}: {name} != plain")
    for name in ("delivered", "served", "lost"):
        a, b = float(getattr(got, name)), float(getattr(want, name))
        require(a == b, f"gossip {what}: counter {name} {a} != plain {b}")
    return {"delivered": float(want.delivered), "served": float(want.served),
            "lost": float(want.lost)}


def _gossip_bounds(call: dict) -> dict:
    """Least bytes and operations of K2 and its phases on these inputs
    (in the chaos mode also the [N] group and delivery rate, 6 bytes a
    row, and a draw for every same-group contact whose sender queues)."""
    n, s = call["know"].shape
    g = call["offs"].shape[0]
    word = 4 if s <= 32 else 8
    stamp = call.get("learn_tick") is not None
    want_newly = call.get("want_newly", True)
    group, node_ok = call.get("group"), call.get("node_ok")
    chaotic = (group is not None or node_ok is not None) \
        and call.get("key") is not None
    row = 2 * s + (2 * s if stamp else 0)          # know, sends(, learn)
    # contacts whose sender queues something: the loss draws needed
    serve = call["know"] & (call["sends_left"] > 0) & call["sender_ok"][:, None]
    cells = serve.sum(1)
    views = rolls.pull_multi(cells, call["offs"])
    if chaotic and group is not None:
        gviews = rolls.pull_multi(group, call["offs"])
        contacts = sum(int(((v > 0) & (gv == group)).sum())
                       for v, gv in zip(views, gviews))
    else:
        contacts = sum(int((v > 0).sum()) for v in views)
    lossy = chaotic or (call.get("key") is not None and call["p_loss"] > 0)
    draws = contacts if lossy else 0
    ops = SASS_PER_ELEMENT["uniform"] * draws
    out_newly = s if want_newly else 0
    extra = 0
    if chaotic:
        extra = (2 if group is not None else 0) + (4 if node_ok is not None
                                                   else 0)
    fn_bytes = n * (2 * row + out_newly + extra) + 2 * n + 4 * g + s
    pack_bytes = n * (2 * s + 1 + 2 * word)         # know, sends, flag; words
    exch_bytes = n * (2 * word + 1 + (row - s) + row + out_newly + extra) \
        + 4 * g + s
    def bound(b, o=0):
        by_ops = o / INT32_OPS_PER_S > b / HBM_BYTES_PER_S
        return (max(b / HBM_BYTES_PER_S, o / INT32_OPS_PER_S) * 1000.0,
                "operations" if by_ops else "bytes")
    return {"function": bound(fn_bytes, ops), "pack": bound(pack_bytes),
            "exchange": bound(exch_bytes, ops), "draws": draws,
            "function_bytes": fn_bytes}


def time_gossip(call: dict, delivered: float) -> dict:
    """K2 at one state: both launches' device time (kernel_ms), each
    phase's (profiler), the wrapper call (CUDA events, host dispatch
    included), the plain twin, and the bounds."""
    call_ms = median_ms(lambda: gossip.disseminate_kernel(**call))
    phase = device_ms(lambda: gossip.disseminate_kernel(**call),
                      ("gossip_pack_kernel", "gossip_exchange_kernel"))
    plain_ms = median_ms(lambda: gossip.disseminate_plain(**call), reps=5)
    b = _gossip_bounds(call)
    return {"function_ms": kernel_ms(lambda: gossip.disseminate_kernel(**call)),
            "call_ms": call_ms,
            "pack_ms": phase["gossip_pack_kernel"],
            "exchange_ms": phase["gossip_exchange_kernel"],
            "plain_ms": plain_ms, "function_bound_ms": b["function"][0],
            "function_bound_by": b["function"][1],
            "pack_bound_ms": b["pack"][0], "exchange_bound_ms": b["exchange"][0],
            "exchange_bound_by": b["exchange"][1], "loss_draws": b["draws"],
            "delivered": delivered}


def check_gossip(dev, params, states: dict, events_call: dict,
                 launches: dict):
    """K2 against its twin on every input set, timed at each state:
    (the two phases' entries of the kernels line, every state's times)."""
    sp = params.swim
    held = {}
    for name, s in states.items():
        held[name] = _hold_gossip(_swim_gossip_call(sp, s), f"swim {name}")
    held["events"] = _hold_gossip(events_call, "events")
    for n, slots in ((N, sp.rumor_slots), (100_003, 40)):
        _hold_gossip(_random_gossip_call(dev, n, slots), f"random {n}x{slots}")
    log(f"gossip held bit-equal: {held} (+ random {N}x{sp.rumor_slots}, "
        f"100003x40)")
    timed = {name: time_gossip(_swim_gossip_call(sp, s), held[name]["delivered"])
             for name, s in states.items()}
    timed["events"] = time_gossip(events_call, held["events"]["delivered"])
    for name, t in timed.items():
        log(f"gossip {name}: " + json.dumps(t))
    final, mid = timed["final"], timed["mid"]
    n, slots = states["final"].know.shape

    def entry(name, phase, bound_by):
        def at(t):
            return {"ms": t[f"{phase}_ms"], "bound_ms": t[f"{phase}_bound_ms"],
                    "function_ms": t["function_ms"],
                    "function_bound_ms": t["function_bound_ms"],
                    "call_ms": t["call_ms"], "plain_ms": t["plain_ms"]}
        return {"name": name, "route": "cuda",
                "source": "consul_tpu_torch/kernels/csrc/gossip.cu",
                "replaces": "consul_tpu/ops/gossip.py:45",
                "launches": launches[name], "max_abs_err": 0.0,
                "ms": final[f"{phase}_ms"], "plain_ms": final["plain_ms"],
                "bound_ms": final[f"{phase}_bound_ms"], "bound_by": bound_by,
                "library_ms": None, "function_ms": final["function_ms"],
                "function_bound_ms": final["function_bound_ms"],
                "call_ms": final["call_ms"],
                "mid": at(mid), "shape": [n, slots, params.swim.gossip_nodes]}
    return [entry("gossip_pack", "pack", "bytes"),
            entry("gossip_exchange", "exchange", final["exchange_bound_by"])], \
        timed


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


def _monitor_bound(params, s, subject: int) -> tuple:
    """Least bytes of K3 at state s: up/member, the rumor table, and the
    know rows and suspect learn ticks unless no row can change the answer."""
    n, u = s.know.shape
    is_dl, is_s, _, _ = swim._monitor_slots(params, s, subject)
    committed = bool(s.committed_dead[subject] | s.committed_left[subject])
    rows = not committed and bool((is_dl | is_s).any())
    suspect_cells = int((s.know & is_s[None, :]).sum()) if rows else 0
    bytes_ = 2 * n + 11 * u + 2 * 65 + 4 + (n * u + 2 * suspect_cells
                                              if rows else 0)
    return bytes_ / HBM_BYTES_PER_S * 1000.0, rows, suspect_cells


def check_monitor(dev, params, states: dict, subject: int,
                  launches: int) -> dict:
    n, u = states["final"].know.shape
    inputs = dict(states)
    inputs["random"] = _random_swim_state(dev, states["final"], subject, n, u)
    inputs["random40"] = _random_swim_state(dev, states["final"], subject,
                                            200_003, 40)
    err = 0.0
    for name, state in inputs.items():
        got = swim.believed_down_fraction(params, state, subject)
        want = swim.believed_down_fraction_plain(params, state, subject)
        require(torch.equal(got.reshape(()).view(torch.int32),
                            want.reshape(()).view(torch.int32)),
                f"believed_down {name}: {float(got)} != plain {float(want)}")
        err = max(err, float((got - want).abs().max()))
    out = torch.empty(1, dtype=torch.float32, device=dev)
    timed = {}
    for name, s in states.items():
        bound, rows, cells = _monitor_bound(params, s, subject)
        timed[name] = {
            "ms": kernel_ms(lambda: swim.believed_down_fraction(
                params, s, subject, out=out)),
            "call_ms": median_ms(lambda: swim.believed_down_fraction(
                params, s, subject, out=out)),
            "plain_ms": median_ms(lambda: swim.believed_down_fraction_plain(
                params, s, subject)),
            "bound_ms": bound, "reads_rows": rows, "suspect_cells": cells,
            "frac": float(swim.believed_down_fraction_plain(params, s, subject))}
        log(f"believed_down {name}: " + json.dumps(timed[name]))
    final, mid = timed["final"], timed["mid"]
    return {"name": "believed_down", "route": "cuda",
            "source": "consul_tpu_torch/kernels/csrc/monitor.cu",
            "replaces": "consul_tpu/models/swim.py:533",
            "launches": launches, "max_abs_err": err,
            "ms": final["ms"], "call_ms": final["call_ms"],
            "plain_ms": final["plain_ms"],
            "bound_ms": final["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": [n, u],
            "mid": {k: mid[k] for k in ("ms", "call_ms", "plain_ms",
                                        "bound_ms")}}


def mid_state(r: dict):
    """The 1M run's state at the first timed tick whose believed-down
    fraction passes 0.5, replayed from the same seed, and checked against
    the main path's fractions."""
    fracs = r["fracs"]
    k = next(i for i, f in enumerate(fracs) if f > 0.5)
    params, s, _ = bench.prepare(device=torch.device("cuda", 0))
    s, fr = serf.run(params, s, k + 1, bench.VICTIM)
    fr = fr.cpu().tolist()
    require(fr[-1] > 0.5 and all(f <= 0.5 for f in fr[:-1]),
            f"replay crossed 0.5 elsewhere: {fr[-3:]}")
    log(f"mid-convergence state: tick {s.swim.tick} ({k + 1} ticks after the "
        f"kill), believed-down fraction {fr[-1]}; replay equals the main "
        f"path's fractions: {fr == fracs[:k + 1]}")
    return s


def events_call_after_fire(params, s) -> dict:
    """An event fired at the final state and spread 6 ticks (K2 on the
    card), then the events caller's next K2 arguments."""
    ev = events.fire(params.events, s.events, origin=5, event_id=1)
    for _ in range(6):
        ev = events.step(params.events, ev, up=s.swim.up, member=s.swim.member)
    return _events_gossip_call(params, ev, s.swim.up, s.swim.member)


def draw_census() -> dict:
    """SASS instructions per element of each K1 mode: threefry.cu compiled
    for the mode alone (build.sass_census), its body's instructions over
    the elements a thread computes."""
    t0 = time.perf_counter()
    counts = build.sass_census("threefry.cu", "THREEFRY_CENSUS_MODE",
                               range(len(kernels.DRAW_MODES)),
                               "threefry_draws_kernel")
    per = {mode: counts[i] / kernels.DRAW_ELEMENTS_PER_THREAD
           for i, mode in enumerate(kernels.DRAW_MODES)}
    log(f"K1 SASS census ({time.perf_counter() - t0:.1f} s): instructions "
        f"per thread {counts}, per element {per}")
    return per


# ---------------------------------------------------------------------------
# phase 5: the oracle at full width, and K4
# ---------------------------------------------------------------------------

ORACLE_SIM = SimConfig(n_nodes=N, rumor_slots=32, alloc_cap=8, p_loss=0.01,
                       seed=7, n_initial=N - 1000)
ORACLE_VICTIMS = ("node1000", f"node{N // 2}", f"node{N - 1001}")


class Recorder:
    """The oracle phase's host services: what the oracle emits, the times
    it observes and the gauges it publishes."""

    def __init__(self):
        self.events, self.observed, self.gauges = [], {}, {}

    def hooks(self) -> host.Hooks:
        return host.Hooks(emit=self._emit, observe=self._observe,
                          span=self._span, registry=lambda: self)

    def _emit(self, name, labels=None, **kw):
        self.events.append((name, dict(labels or {}), kw))

    def _observe(self, name, seconds):
        self.observed.setdefault(name, []).append(seconds)

    @contextlib.contextmanager
    def _span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._observe(name, time.perf_counter() - t0)

    def set_gauge(self, name, value, labels=None):
        self.gauges[(name, tuple(sorted((labels or {}).items())))] = value


def _leaves_equal(a, b):
    """True when two serf states hold the same host mirrors and the same
    bytes in every tensor leaf; else the names of the leaves that
    differ."""
    diff = []
    for part in ("swim", "coords", "events"):
        x, y = getattr(a, part), getattr(b, part)
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, torch.Tensor):
                same = u.shape == v.shape and u.dtype == v.dtype and \
                    torch.equal(u.reshape(-1).view(torch.uint8),
                                v.reshape(-1).view(torch.uint8))
            else:
                same = u == v
            if not same:
                diff.append(f"{part}.{f.name}")
    return diff or True


def _advance_until(o, cond, what: str, step: int = 25,
                   limit: int = 1000) -> int:
    ticks = 0
    while not cond():
        require(ticks < limit, f"oracle: {what} not reached in {limit} ticks")
        o.advance(step)
        ticks += step
    return ticks


def oracle_path(dev) -> tuple:
    """The oracle driven as a user drives it, K4's counts zeroed just
    before.  Returns (the oracle, the phase's record)."""
    rec = Recorder()
    kernels.reset_launches()
    t0 = time.perf_counter()
    o = GossipOracle(GossipConfig.lan(), ORACLE_SIM, device=dev,
                     hooks=rec.hooks())
    init_s = time.perf_counter() - t0
    kept = o._state.clone()
    t0 = time.perf_counter()
    o.warmup()
    warmup_s = time.perf_counter() - t0
    unchanged = _leaves_equal(kept, o._state)
    log(f"oracle: warmup left every leaf of the pool's state unchanged: "
        f"{unchanged}")
    require(unchanged is True,
            f"oracle: warmup changed the pool's state: {unchanged}")
    o.advance(1)
    joined = ORACLE_SIM.n_initial
    summary = o.members_summary()
    require(summary == {"alive": joined, "failed": 0, "left": 0,
                        "total": joined}, f"oracle: fresh summary {summary}")
    require(o.journal_flaps() == 0, "oracle: the first journal_flaps "
            "journaled rows")
    first = o.members_delta()
    require(first["count"] == joined and first["truncated"]
            and len(first["changed"]) == 256,
            f"oracle: first delta count {first['count']}")
    for v in ORACLE_VICTIMS:
        o.kill(v)
    ticks = _advance_until(
        o, lambda: all(o.status(v) == "failed" for v in ORACLE_VICTIMS),
        "the victims' failure")
    ids = sorted(o.node_id(v) for v in ORACLE_VICTIMS)
    delta = o.members_delta()
    require(delta == {"count": 3, "changed": [(i, "failed") for i in ids],
                      "truncated": False}, f"oracle: delta {delta}")
    n_ev = len(rec.events)
    require(o.journal_flaps() == 3, "oracle: journal_flaps != 3")
    flaps = rec.events[n_ev:]
    require(sorted(e[1]["node"] for e in flaps) == sorted(ORACLE_VICTIMS)
            and all(e[0] == "serf.member.flap" and e[1]["status"] == "failed"
                    and e[2] == {"trace_id": ""} for e in flaps),
            f"oracle: flap journal {flaps}")
    page = o.members(limit=100, offset=N // 2)
    require([r["id"] for r in page] == list(range(N // 2, N // 2 + 100))
            and page[0]["status"] == "failed" and not page[0]["actually_up"]
            and all(r["status"] == "alive" for r in page[1:]),
            "oracle: page at offset N / 2")
    spawned = o.spawn()
    require(spawned == f"node{joined}" and o.status(spawned) == "alive"
            and o.members_summary()["total"] == joined + 1,
            f"oracle: spawn gave {spawned}")
    o.leave("node2000")
    require(o.status("node2000") == "left", "oracle: leave")
    vid = o.node_id(ORACLE_VICTIMS[0])
    ticks += _advance_until(
        o, lambda: bool(o._state.swim.committed_dead[vid]),
        f"the commit of {ORACLE_VICTIMS[0]}'s death")
    require(o.status(ORACLE_VICTIMS[0]) == "failed", "oracle: committed death")
    o.revive(ORACLE_VICTIMS[0])
    require(o.status(ORACLE_VICTIMS[0]) == "alive", "oracle: rejoin")
    o.advance(5)
    ticks += 5
    summary = o.members_summary()
    require(summary == {"alive": joined - 2, "failed": 2, "left": 1,
                        "total": joined + 1}, f"oracle: summary {summary}")
    coord = o.coordinate("node5")
    require(len(coord["vec"]) == 8 and all(
        math.isfinite(x) for x in coord["vec"] + [coord["error"],
                                                  coord["height"]]),
        f"oracle: coordinate {coord}")
    rtt = o.rtt("node5", "node6")
    require(math.isfinite(rtt) and rtt > 0.0, f"oracle: rtt {rtt}")
    names = [f"node{i}" for i in range(0, joined, joined // 1000)][:1000]
    order = o.sort_by_rtt("node5", names)
    at = torch.tensor([o.node_id(n) for n in order], dtype=torch.int32,
                      device=dev)
    est = vivaldi.estimate_rtt(o._state.coords, torch.full_like(at, 5), at)
    require(sorted(order) == sorted(names) and len(names) == 1000
            and bool((est[1:] >= est[:-1]).all()),
            "oracle: sort_by_rtt is not ascending in estimated RTT")
    m = o.publish_sim_metrics()
    alive_gauge = rec.gauges.get((("serf", "members", "alive"), ()))
    require(alive_gauge == m["members.alive"] and m["members.alive"] > 0,
            f"oracle: published members.alive {alive_gauge}")
    launches = dict(kernels.LAUNCHES)
    log(f"oracle path: init_s={init_s} warmup_s={warmup_s} ticks={o.tick} "
        f"({ticks} after the kills) summary={summary} launches={launches}")
    for name in kernels.MEMBERS:
        require(launches[name] > 0, f"{name} never launched by the oracle")
    calls = {
        "members_summary": wall_ms(o.members_summary),
        "members_delta(256)": wall_ms(lambda: o.members_delta(256)),
        "members(limit=100)": wall_ms(lambda: o.members(limit=100,
                                                        offset=N // 2)),
        "sort_by_rtt(1000)": wall_ms(lambda: o.sort_by_rtt("node5", names)),
        "status": wall_ms(lambda: o.status(ORACLE_VICTIMS[1])),
        "advance(1)": wall_ms(lambda: o.advance(1)),
    }
    log("oracle calls, median wall ms: " + json.dumps(calls))
    return o, {"init_s": init_s, "warmup_s": warmup_s, "ticks": o.tick,
               "summary": summary, "launches": launches, "calls_ms": calls,
               "observed": {k: len(v) for k, v in rec.observed.items()}}


def _random_members(dev, base, u: int, seed: int):
    """Random member leaves of [N] and a [u] rumor table on `base`'s rows,
    with a random provisioned mask, ids for a page and incarnations."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    n = base.member.shape[0]
    s = base.replace(
        member=rnd(n) < 0.97, committed_dead=rnd(n) < 0.02,
        committed_left=rnd(n) < 0.01, up=rnd(n) < 0.95,
        incarnation=(rnd(n) * 5).to(torch.int32),
        r_active=rnd(u) < 0.8, r_kind=(rnd(u) * 4).to(torch.int8),
        r_subject=(rnd(u) * n).to(torch.int32))
    return s, rnd(n) < 0.99


def _tile_edges(dev, base, seed: int):
    """_random_members at U = 64 with every slot an active dead rumor
    whose subject sits on an edge of K4's tiles (0, tile - 1, tile,
    2 tile - 1, ..., N - 1), some named twice."""
    s, prov = _random_members(dev, base, 64, seed)
    n, tile = base.member.shape[0], kernels.MEMBER_TILE
    edges = [0, tile - 1, tile, 2 * tile - 1, 2 * tile, n - 1, n - tile,
             (n // tile) * tile, (n // tile) * tile - 1, n // 2 - 1, n // 2]
    edges += [e + tile * j for j in range(3, 40, 7) for e in (0, tile - 1)]
    edges = [e for e in edges if 0 <= e < n][:56]
    subj = edges + edges[:8]
    subj += [edges[-1]] * (64 - len(subj))
    u = len(subj)
    return s.replace(
        r_active=torch.ones(u, dtype=torch.bool, device=dev),
        r_kind=torch.full((u,), swim.DEAD, dtype=torch.int8, device=dev),
        r_subject=torch.tensor(subj, dtype=torch.int32, device=dev)), prov


def _out_of_range(n: int) -> list:
    """Dead subjects outside [0, n): JAX's scatter wraps [-n, 0) once (-1
    names n - 1, 5 - n names 5, -n names 0) and drops the rest."""
    return [-1, n + 1, 5 - n, -n, n, -n - 1]


def _out_of_range_members(dev, base, seed: int):
    """_random_members at U = 64 whose first slots are active dead rumors
    about _out_of_range subjects."""
    s, prov = _random_members(dev, base, 64, seed)
    subj = _out_of_range(base.member.shape[0])
    k = len(subj)
    active, kind = s.r_active.clone(), s.r_kind.clone()
    subject = s.r_subject.clone()
    active[:k] = True
    kind[:k] = swim.DEAD
    subject[:k] = torch.tensor(subj, dtype=torch.int32, device=dev)
    return s.replace(r_active=active, r_kind=kind, r_subject=subject), prov


def _prev(st: torch.Tensor, flips: int, seed: int) -> torch.Tensor:
    """st with `flips` random entries moved to another status."""
    gen = torch.Generator(device=st.device)
    gen.manual_seed(seed)
    at = torch.randint(0, st.shape[0], (flips,), generator=gen,
                       device=st.device)
    prev = st.clone()
    prev[at] = ((prev[at].to(torch.int32) + 1) % 3).to(torch.int8)
    return prev


def _same(a, b, what: str, kernel: str = "K4") -> None:
    """a and b bit-equal: dtype, shape and every element (floats by their
    bits, so -0.0 and NaN payloads count)."""
    require(a.dtype == b.dtype and a.shape == b.shape,
            f"{kernel} {what}: {a.dtype} {tuple(a.shape)} vs plain "
            f"{b.dtype} {tuple(b.shape)}")
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    require(torch.equal(a, b), f"{kernel} {what} != plain: "
            f"{int((a != b).sum())} elements differ")


def check_members(dev, o) -> tuple:
    """K4 against its plain twins, bit-equal, on the oracle's state and on
    random states; each launch timed.  Returns (the kernels-line entries,
    the record)."""
    params = o.params.swim
    sw, prov = o._state.swim, o._prov_dev
    ids = torch.cat([torch.randint(0, N, (4093,), device=dev,
                                   generator=torch.Generator(device=dev)
                                   .manual_seed(5)).to(torch.int32),
                     torch.tensor([-1, N + 7, -N - 3], dtype=torch.int32,
                                  device=dev)])
    cases = {"oracle": (sw, prov)}
    for u in (32, 64):
        cases[f"random U={u}"] = _random_members(dev, sw, u, 40 + u)
    cases["random tile edges"] = _tile_edges(dev, sw, 41)
    cases["random out of range"] = _out_of_range_members(dev, sw, 42)
    held = []
    for name, (s, pv) in cases.items():
        st = swim.status_vector(params, s)
        _same(st, swim.status_vector_plain(params, s), f"{name} status")
        _same(swim.membership_counts(params, s, pv),
              swim.membership_counts_plain(params, s, pv), f"{name} counts")
        for a, b, what in zip(swim.membership_page(params, s, ids),
                              swim.membership_page_plain(params, s, ids),
                              ("status", "incarnation", "up")):
            _same(a, b, f"{name} page {what}")
        prevs = {"first": torch.full_like(st, -1)}
        if name == "oracle":
            prevs["checkpoint"] = o._status_ckpt
        else:
            prevs.update({"100 flips": _prev(st, 100, 1),
                          "50000 flips": _prev(st, 50_000, 2)})
        for pname, prev in prevs.items():
            for k in (8, 256, 4096, N):
                got = swim.membership_delta(params, s, prev, pv, k)
                want = swim.membership_delta_plain(params, s, prev, pv, k)
                for a, b, what in zip(got, want, ("status", "n_changed", "idx",
                                                  "state")):
                    _same(a, b, f"{name} {pname} k={k} delta {what}")
                held.append((name, pname, k, int(want[1])))
    below = sum(1 for h in held if h[3] < h[2])
    above = sum(1 for h in held if h[3] > h[2])
    log(f"K4 bit-equal to its plain twins: {len(held)} deltas ({below} with "
        f"n_changed below k, {above} above), status, counts and a "
        f"{ids.shape[0]}-id page on {list(cases)}")
    require(below > 0 and above > 0, "K4: n_changed never both below and "
            "above k")
    return held


def time_members(dev, o, launches: dict) -> list:
    """Each K4 launch at the oracle's state: device ms (kernel_ms), the
    plain twin's ms, the library call's (library_times) and the bound."""
    params = o.params.swim
    s, prov = o._state.swim, o._prov_dev
    n, u = s.member.shape[0], s.r_active.shape[0]
    tiles = kernels.member_tiles(n)
    table = (s.r_active, s.r_kind, s.r_subject)
    nodes = (s.member, s.committed_dead, s.committed_left)
    counts = torch.zeros(kernels.MEMBER_COUNTS, dtype=torch.int32, device=dev)
    st = torch.empty(n, dtype=torch.int8, device=dev)
    blocks = torch.empty(tiles, dtype=torch.int32, device=dev)
    prev = _prev(swim.status_vector(params, s), 100, 3)
    k = 256
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    state = torch.empty(k, dtype=torch.int8, device=dev)
    kernels.launch_members_scan(*nodes, *table, prov, prev, st, counts, blocks)
    changed = (st != prev) & prov
    n_changed = int(changed.sum())
    per_tile = torch.diff(blocks, prepend=blocks.new_zeros(1))
    tiles_read = int((per_tile > 0).sum())    # every rank < k here
    page_ids = torch.arange(N // 2, N // 2 + 128, dtype=torch.int32,
                            device=dev)
    pk = page_ids.shape[0]
    st_o = torch.empty(pk, dtype=torch.int8, device=dev)
    inc_o = torch.empty(pk, dtype=torch.int32, device=dev)
    up_o = torch.empty(pk, dtype=torch.bool, device=dev)

    def bound(bytes_):
        return bytes_ / HBM_BYTES_PER_S * 1000.0

    table_bytes = 6 * u
    rows = {
        "members_scan": dict(
            fn=lambda: kernels.launch_members_scan(*nodes, *table, prov, None,
                                                   None, counts, None),
            plain=lambda: swim.membership_counts_plain(params, s, prov),
            library=lambda: torch.bincount(st[prov].to(torch.int64),
                                           minlength=3),
            bytes=4 * n + table_bytes + 4 * kernels.MEMBER_COUNTS,
            replaces="consul_tpu/models/swim.py:1502"),
        "members_scan (delta)": dict(
            fn=lambda: kernels.launch_members_scan(*nodes, *table, prov, prev,
                                                   st, counts, blocks),
            plain=lambda: swim.status_vector_plain(params, s),
            library=None,
            bytes=5 * n + n + table_bytes + 4 * tiles + 4 * kernels.MEMBER_COUNTS,
            replaces="consul_tpu/models/swim.py:1487"),
        "members_emit": dict(
            fn=lambda: kernels.launch_members_emit(st, prev, prov, blocks, k,
                                                   idx, state, counts),
            plain=lambda: swim._top_k(changed.to(torch.int32), k),
            library=lambda: torch.nonzero(changed)[:k],
            bytes=4 * tiles + 3 * kernels.MEMBER_TILE * tiles_read + 5 * k,
            replaces="consul_tpu/models/swim.py:1525"),
        "members_page": dict(
            fn=lambda: kernels.launch_members_page(
                page_ids, *nodes, *table, s.incarnation, s.up, st_o, inc_o,
                up_o),
            plain=lambda: swim.membership_page_plain(params, s, page_ids),
            library=None,
            bytes=pk * (4 + 3 + 4 + 1) + table_bytes + pk * (1 + 4 + 1),
            replaces="consul_tpu/models/swim.py:1517"),
    }
    timed = {}
    for name, r in rows.items():
        t = {"ms": kernel_ms(r["fn"]), "plain_ms": median_ms(r["plain"]),
             **(library_times(r["library"]) if r["library"] else
                {"library_ms": None}),
             "bound_ms": bound(r["bytes"]), "bound_bytes": r["bytes"]}
        timed[name] = t
        log(f"K4 {name}: " + json.dumps(t))
    timed["members_emit"].update(n_changed=n_changed, k=k,
                                 tiles_read=tiles_read)
    timed["members_page"]["ids"] = pk
    # the plain delta whole (status + sort) against scan + emit
    timed["delta_plain_ms"] = median_ms(
        lambda: swim.membership_delta_plain(params, s, prev, prov, k))
    timed["delta_kernel_call_ms"] = median_ms(
        lambda: swim.membership_delta(params, s, prev, prov, k))
    log(f"K4 delta at k={k}, {n_changed} changed: plain "
        f"{timed['delta_plain_ms']} ms, scan + emit call "
        f"{timed['delta_kernel_call_ms']} ms")
    entries = []
    for name in ("members_scan", "members_emit", "members_page"):
        t = timed[name]
        e = {"name": name, "route": "cuda",
             "source": "consul_tpu_torch/kernels/csrc/members.cu",
             "replaces": rows[name]["replaces"], "launches": launches[name],
             "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": "bytes",
             "library_ms": t["library_ms"],
             "library_device_ms": t.get("library_device_ms"),
             "library_call_ms": t.get("library_call_ms"), "shape": [n, u]}
        if name == "members_scan":
            e["delta"] = timed["members_scan (delta)"]
        entries.append(e)
    return entries, timed


def oracle_phase(dev) -> tuple:
    """Phase 5: (K4's kernels-line entries, the phase's record)."""
    o, path = oracle_path(dev)
    held = check_members(dev, o)
    entries, timed = time_members(dev, o, path["launches"])
    o.stop()
    return entries, {"path": path, "k4_held": held, "k4": timed}



# ---------------------------------------------------------------------------
# phase 6: the nemesis build at full width, and K2's chaos mode
# ---------------------------------------------------------------------------

CHAOS_SEED = 7
CHAOS_SLOTS = 32
# the JAX scenarios' soak size: partition_heal runs here only (see
# chaos_phase) and every scenario is held card against CPU here
SCENARIO_N = 256


def _chaos_scenario(name: str, dev, n: int, slots: int, **kw) -> dict:
    """One scenario's SWIM half with every launch count zeroed just before:
    its violations, detail, flight rows, launches and wall."""
    rec = Recorder()
    kernels.reset_launches()
    t0 = time.perf_counter()
    violations, detail = chaos.SCENARIOS[name](CHAOS_SEED, n=n, slots=slots,
                                               device=dev, hooks=rec.hooks(),
                                               **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"violations": violations, "detail": detail,
            "rows": [(e[0], e[1], e[2].get("ts")) for e in rec.events],
            "launches": dict(kernels.LAUNCHES),
            "wall_s": time.perf_counter() - t0}


def _chaos_gates(name: str, r: dict) -> None:
    """A chaos run gossips through K2's chaos mode once per tick and never
    through the non-chaos exchange."""
    ticks, launches = r["detail"]["tick"], r["launches"]
    require(launches["gossip_exchange_chaos"] == ticks,
            f"chaos {name}: {launches['gossip_exchange_chaos']} chaos "
            f"exchanges in {ticks} ticks")
    require(launches["gossip_exchange"] == 0 and
            launches["gossip_pack"] == ticks,
            f"chaos {name}: launches {launches}")


def _partitioned(s, seed: int):
    """s with a seeded 25% of the nodes in partition group 1 (its degraded
    set kept)."""
    gen = torch.Generator(device=s.device)
    gen.manual_seed(seed)
    grp = (torch.rand(s.up.shape[0], generator=gen, device=s.device) < 0.25)
    return s.replace(chaos_grp=grp.to(torch.int16))


def _chaos_gossip_call(params, s) -> dict:
    call = _swim_gossip_call(params, s)
    call.update(group=s.chaos_grp, node_ok=s.chaos_ok)
    return call


def _random_chaos_call(dev, n: int, slots: int) -> dict:
    call = _random_gossip_call(dev, n, slots)
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    rnd = torch.rand(n, generator=gen, device=dev)
    call.update(group=(rnd < 0.3).to(torch.int16),
                node_ok=torch.where(rnd > 0.8, 0.55, 1.0).to(torch.float32))
    return call


def fenced_ms_per_tick(params, s, ticks: int = 50) -> float:
    """Host wall ms per tick of `ticks` swim ticks from s, fenced."""
    s = _clone(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chaos.compiled_swim_run(params, ticks)(s)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / ticks


def check_chaos_gossip(dev, params, states: dict, launches: int,
                       plain_exchange_ms: float) -> tuple:
    """K2's chaos mode against its twin, bit-equal, on 1M states and random
    inputs; timed as the other K2 rows are, beside the non-chaos exchange
    on the same state.  Returns (the kernels-line entry, the record)."""
    held = {}
    for name, s in states.items():
        held[name] = _hold_gossip(_chaos_gossip_call(params, s),
                                  f"chaos {name}")
    for n, slots in ((N, CHAOS_SLOTS), (100_003, 40)):
        _hold_gossip(_random_chaos_call(dev, n, slots),
                     f"chaos random {n}x{slots}")
    log(f"K2 chaos mode held bit-equal: {held} (+ random {N}x{CHAOS_SLOTS}, "
        f"100003x40)")
    timed = {}
    for name, s in states.items():
        call = _chaos_gossip_call(params, s)
        t = time_gossip(call, held[name]["delivered"])
        t["lost"] = held[name]["lost"]
        plain = _swim_gossip_call(params, s)
        t["non_chaos_exchange_ms"] = device_ms(
            lambda: gossip.disseminate_kernel(**plain),
            ("gossip_exchange_kernel",))["gossip_exchange_kernel"]
        timed[name] = t
        log(f"K2 chaos {name}: " + json.dumps(t))
    t = timed["degradation"]
    n, slots = states["degradation"].know.shape
    entry = {"name": "gossip_exchange_chaos", "route": "cuda",
             "source": "consul_tpu_torch/kernels/csrc/gossip.cu",
             "replaces": "consul_tpu/ops/gossip.py:82",
             "launches": launches, "max_abs_err": 0.0,
             "ms": t["exchange_ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["exchange_bound_ms"],
             "bound_by": t["exchange_bound_by"], "library_ms": None,
             "function_ms": t["function_ms"],
             "function_bound_ms": t["function_bound_ms"],
             "call_ms": t["call_ms"],
             "non_chaos_exchange_ms": t["non_chaos_exchange_ms"],
             "main_path_exchange_ms": plain_exchange_ms,
             "partitioned": {k: timed["partitioned"][k] for k in
                             ("exchange_ms", "exchange_bound_ms",
                              "non_chaos_exchange_ms", "plain_ms")},
             "shape": [n, slots, params.gossip_nodes]}
    return entry, {"held": held, "timed": timed}


def chaos_phase(dev, main_exchange_ms: float, for_phase_11: dict) -> tuple:
    """Phase 6, the nemesis build (`SimConfig(chaos=True)`, LAN gossip,
    U = 32, 1% loss, seed 7, 50-tick chunks) through the port's
    SwimChaosHarness:

      * asym_degradation's and loss_burst's SWIM halves and crash_restart's
        at N = 1M, each with every launch count zeroed just before;
        crash_restart must re-converge (recall >= 0.999, no live member
        believed down) and never commit a flap-revived node; the
        degradation and loss runs' committed deaths and violations are
        printed, not gated (the JAX package never ran its nemesis above
        256 nodes, so a 1M count has no reference);
      * partition_heal's SWIM half at the JAX scenario's soak size, N =
        256, only: this path's one cut.  Under chaos the bulk overflow is
        off, so the 25% minority must be committed node by node through
        the slot table, at most alloc_cap = 8 per probe round: 250,000
        commits at N = 1M;
      * all four SWIM halves at N = 256 on the card and on the CPU: the
        same detail, flight rows and no violations;
      * K2's chaos mode against its twin, bit-equal, on the degradation
        run's state at the end of its fault window and on that state with
        a 25% partition applied by hand, and on random inputs (U = 32 at
        N = 1M, a 40-slot table at N = 100,003); timed beside its bound
        and the non-chaos exchange.
    Returns (the kernels-line entry, the record)."""
    captured = {}
    runs = {}
    for name in ("asym_degradation", "loss_burst", "crash_restart"):
        kw = {"observe": lambda sw: captured.update(
            degradation=sw.state.clone())} \
            if name == "asym_degradation" else {}
        r = _chaos_scenario(name, dev, N, CHAOS_SLOTS, **kw)
        _chaos_gates(name, r)
        d = r["detail"]
        log(f"chaos {name} at N={N}: wall_s={r['wall_s']} ticks={d['tick']} "
            f"ms_per_tick={1000.0 * r['wall_s'] / d['tick']} committed_dead="
            f"{len(d['committed_dead'])} incarnation_sum="
            f"{d['incarnation_sum']} violations={r['violations']} "
            f"flight_rows={len(r['rows'])} launches={r['launches']}")
        runs[name] = {k: r[k] for k in ("violations", "wall_s", "launches")}
        runs[name]["detail"] = {k: (len(v) if k == "committed_dead" else v)
                                for k, v in d.items()}
    d = runs["crash_restart"]["detail"]
    require(d["recall"] >= 0.999 and d["false_positives"] == 0,
            f"chaos crash_restart at 1M did not re-converge: {d}")
    require(not any("flap-revived" in v
                    for v in runs["crash_restart"]["violations"]),
            f"chaos crash_restart: {runs['crash_restart']['violations']}")
    chaos_launches = sum(r["launches"]["gossip_exchange_chaos"]
                         for r in runs.values())

    scenarios = {}
    for name in sorted(chaos.SCENARIOS):
        card = _chaos_scenario(name, dev, SCENARIO_N, None)
        _chaos_gates(name, card)
        cpu = _chaos_scenario(name, torch.device("cpu"), SCENARIO_N, None)
        log(f"chaos {name} at N={SCENARIO_N}: card {card['detail']} "
            f"({card['wall_s']} s), cpu {cpu['detail']} ({cpu['wall_s']} s), "
            f"violations {card['violations']} / {cpu['violations']}")
        require(card["detail"] == cpu["detail"],
                f"chaos {name}: card detail != cpu detail")
        require(card["rows"] == cpu["rows"] and card["rows"],
                f"chaos {name}: flight rows differ")
        require(not card["violations"] and not cpu["violations"],
                f"chaos {name} at N={SCENARIO_N}: {card['violations']}")
        scenarios[name] = {"detail": card["detail"], "card_wall_s":
                           card["wall_s"], "cpu_wall_s": cpu["wall_s"],
                           "flight_rows": len(card["rows"])}

    params = swim.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=N, rumor_slots=CHAOS_SLOTS, p_loss=0.01, seed=CHAOS_SEED,
        chaos=True))
    states = {"degradation": captured["degradation"],
              "partitioned": _partitioned(captured["degradation"], 5)}
    for_phase_11.update({f"chaos {name}": (params, st)
                         for name, st in states.items()})
    entry, k2 = check_chaos_gossip(dev, params, states, chaos_launches,
                                   main_exchange_ms)
    per_tick = {name: fenced_ms_per_tick(params, s)
                for name, s in states.items()}
    log(f"1M chaos ticks, fenced ms per tick over 50: {per_tick}")
    return entry, {"runs_1m": runs, "scenarios_256": scenarios, "k2": k2,
                   "fenced_ms_per_tick": per_tick}


# ---------------------------------------------------------------------------
# phase 7: the correlated-failure bench at full width, and K5
# ---------------------------------------------------------------------------

CORRELATED = dict(fractions=[0.01], rumor_slots=[32], max_ticks=4096,
                  chunk=256, seed=7)
# tools/correlated_failures.py's row at N = 1M, 1%, 32 slots in the JAX
# package's BENCH_correlated.json (predates that package's last fixes)
JAX_CONV_TICKS_99 = 634


def _random_mass_state(dev, base, n: int, u: int, seed: int,
                       victims: bool = True, live: str = "random"):
    """Random K5 inputs of [n, u]: every subject of the rumor table drawn
    from 8 nodes (duplicates across slots), a third of the slots dead or
    left, columns known by 98.5-100% of the rows (around the 0.99 bar),
    a bulk channel with coverage around 0.99; ~1% victims, or none.
    `live`: "random" (~98.5% of the rows live), "all" (every row up and
    a member) or "none" (every row down: n_live is clamped to 1)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    subjects = (rnd(8) * n).to(torch.int32)
    col_p = 0.985 + 0.015 * rnd(u)
    bulk = rnd(n) < 0.01
    know = rnd(n, u) < col_p[None, :]
    up, member = rnd(n) < 0.99, rnd(n) < 0.995
    if live != "random":
        up = torch.full_like(up, live == "all")
        member = member | up
    s = base.replace(
        know=know, up=up, member=member,
        committed_dead=rnd(n) < 0.001, committed_left=rnd(n) < 0.0005,
        bulk_member=bulk,
        bulk_cov=torch.where(bulk, 0.985 + 0.01 * rnd(n), 0.0),
        r_active=rnd(u) < 0.9, r_kind=(rnd(u) * 4).to(torch.int8),
        r_subject=subjects[(rnd(u) * 8).to(torch.int64)])
    mask = (rnd(n) < 0.01) if victims else torch.zeros(n, dtype=torch.bool,
                                                       device=dev)
    return s, mask


def _at_bar_state(dev, base, seed: int):
    """Every row of `base` live (n_live = N = 1M) and two dead slots whose
    columns hold exactly c = 990,000 rows (float32(c) / float32(n_live)
    == 0.99f: at the bar, detected) and c - 1 (just below it), naming two
    victims; the other slots as _random_mass_state's."""
    n = base.member.shape[0]
    s, mask = _random_mass_state(dev, base, n, base.know.shape[1], seed,
                                 live="all")
    c = (99 * n) // 100
    require(np.float32(c) / np.float32(n) == np.float32(0.99)
            and np.float32(c - 1) / np.float32(n) < np.float32(0.99),
            f"K5 at the bar: {c} / {n} is not the bar")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    know, kind, subj = s.know.clone(), s.r_kind.clone(), s.r_subject.clone()
    for slot, holders in ((0, c), (1, c - 1)):
        perm = torch.randperm(n, generator=gen, device=dev)
        col = torch.zeros(n, dtype=torch.bool, device=dev)
        col[perm[:holders]] = True
        know[:, slot] = col
    victims = mask.nonzero().flatten()
    kind[:2] = swim.DEAD
    subj[0] = victims[0].to(torch.int32)
    subj[1] = victims[1].to(torch.int32)
    active = s.r_active.clone()
    active[:2] = True
    return s.replace(know=know, r_kind=kind, r_subject=subj,
                     r_active=active), mask


def _out_of_range_mass(dev, base, seed: int):
    """_random_mass_state at base's size with four dead slots known by
    every row about subjects outside [0, N): -1 (names N - 1), N + 1
    (nobody), a victim's id - N (the victim) and -N - 1 (nobody)."""
    n, u = base.know.shape
    s, mask = _random_mass_state(dev, base, n, u, seed)
    victim = int(mask.nonzero()[0])
    subj = [-1, n + 1, victim - n, -n - 1]
    k = len(subj)
    know, active = s.know.clone(), s.r_active.clone()
    kind, subject = s.r_kind.clone(), s.r_subject.clone()
    know[:, :k] = True
    active[:k] = True
    kind[:k] = swim.DEAD
    subject[:k] = torch.tensor(subj, dtype=torch.int32, device=dev)
    return s.replace(know=know, r_active=active, r_kind=kind,
                     r_subject=subject), mask


def _hold_mass(params, s, mask, what: str) -> tuple:
    got = swim.mass_detection_stats(params, s, mask)
    want = swim.mass_detection_stats_plain(params, s, mask)
    require(torch.equal(got[0].reshape(()).view(torch.int32),
                        want[0].reshape(()).view(torch.int32))
            and int(got[1]) == int(want[1]),
            f"mass_detect {what}: ({float(got[0])}, {int(got[1])}) != plain "
            f"({float(want[0])}, {int(want[1])})")
    return float(want[0]), int(want[1])


def _near_bar(s) -> int:
    """Active dead/left slots whose live coverage is within [0.9, 0.995)."""
    live = s.up & s.member
    cov = (s.know & live[:, None]).sum(0).float() / live.sum().clamp_min(1)
    dl = s.r_active & ((s.r_kind == swim.DEAD) | (s.r_kind == swim.LEFT))
    return int((dl & (cov >= 0.9) & (cov < 0.995)).sum())


def correlated_phase(dev, for_phase_11: dict) -> tuple:
    """Phase 7, the correlated-failure bench at N = 1M, 1% (10,000
    victims), 32 slots, seed 7, 256-tick chunks, at most 4096 ticks (the
    JAX tool's row) through `consul_tpu_torch.correlated`, every launch
    count zeroed just before: recall >= 0.999 and no false positive, K5
    once per tick, the bulk channel run; K5 against its twin on the 1M
    states mid-drain (a dead/left slot near the bar) and at the drain's
    end, and on random states, timed; the bench at N = 4096 on
    the card and on the CPU with the same curves.  Returns (the
    kernels-line entry, the record)."""
    kernels.reset_launches()
    row = correlated.run(nodes=N, device=dev, **CORRELATED)[0]
    launches = dict(kernels.LAUNCHES)
    brief = {k: v for k, v in row.items() if not k.endswith("_curve")}
    log(f"correlated at N={N}: " + json.dumps(brief))
    log(f"correlated conv_ticks_99: port {row['conv_ticks_99']}, the JAX "
        f"package's BENCH_correlated.json {JAX_CONV_TICKS_99} (not a gate)")
    log(f"correlated launches: {launches}")
    require(row["recall_final"] >= 0.999,
            f"correlated recall {row['recall_final']}")
    require(row["false_positives_max"] == 0,
            f"correlated false positives {row['false_positives_max']}")
    require(launches["mass_detect"] == row["ticks_run"],
            f"K5 launched {launches['mass_detect']} times in "
            f"{row['ticks_run']} ticks")
    require(row["bulk_ticks"] > 0, "the bulk channel never ran")
    require(launches["bulk_step"] == row["bulk_ticks"]
            == row["bulk_step_launches"],
            f"K14 launched {launches['bulk_step']} times in "
            f"{row['bulk_ticks']} bulk ticks")

    # the bench replayed from the seed, tick by tick, to the first tick
    # whose recall reaches 0.5 (the end of the drain: the bulk commits land
    # together, so recall jumps from near 0 to ~0.98 there), keeping the
    # first state whose bulk channel is busy while a dead/left slot sits
    # near the 0.99 bar (mid-drain); the replay must give the bench's
    # recall curve
    params = correlated.bench_params(N, seed=CORRELATED["seed"])
    end = next(i for i, r in enumerate(row["recall_curve"]) if r >= 0.5) + 1
    s, mask = correlated.start(params, CORRELATED["fractions"][0],
                               CORRELATED["seed"], dev)
    curve, at_bar = [], None
    for _ in range(end):
        s, rec, _ = correlated.run_chunk(params, s, 1, mask)
        curve.append(float(rec[0]))
        if at_bar is None and bool(s.bulk_member.any()) and _near_bar(s) > 0:
            at_bar = s.clone()
    require(curve == row["recall_curve"][:end],
            "the replay left the bench's recall curve")
    require(at_bar is not None, "no replayed tick had a busy bulk channel "
            "and a dead/left slot near the bar")
    require(bool(s.bulk_member.any()), "the bulk channel is empty at the "
            "drain's end")
    states = {"near_bar": {"tick": at_bar.tick, "near_bar_slots":
                           _near_bar(at_bar), "bulk_members":
                           int(at_bar.bulk_member.sum())},
              "drain_end": {"tick": s.tick, "near_bar_slots": _near_bar(s),
                            "bulk_members": int(s.bulk_member.sum())}}
    for_phase_11.update({"correlated near_bar": (params, at_bar),
                         "correlated drain_end": (params, s)})
    held = {"near_bar": _hold_mass(params, at_bar, mask, "near the bar"),
            "drain_end": _hold_mass(params, s, mask, "at the drain's end")}
    for name, n, u, victims, live in (
            ("random U=32", N, 32, True, "random"),
            ("random no victims", N, 32, False, "random"),
            ("random U=64", N, 64, True, "random"),
            ("random 100003x40", 100_003, 40, True, "random"),
            ("random U=16", N, 16, True, "random"),
            ("random all live", N, 32, True, "all"),
            ("random no live rows", N, 32, True, "none")):
        cut = s if n == N else s.replace(
            **{f: getattr(s, f)[:n] for f in swim.TENSOR_FIELDS
               if getattr(s, f).shape[:1] == (N,)})
        rs, rm = _random_mass_state(dev, cut, n, u, seed=len(held),
                                    victims=victims, live=live)
        held[name] = _hold_mass(params, rs, rm, name)
    bs, bm = _at_bar_state(dev, s, seed=len(held))
    held["counts at the bar"] = _hold_mass(params, bs, bm, "at the bar")
    os_, om = _out_of_range_mass(dev, s, seed=len(held))
    held["out-of-range subjects"] = _hold_mass(params, os_, om,
                                               "out-of-range subjects")
    live_b = bs.up & bs.member
    cov_b = (bs.know[:, :2] & live_b[:, None]).sum(0).tolist()
    require(cov_b == [990_000, 989_999] and int(live_b.sum()) == N,
            f"K5 at the bar: columns {cov_b}")
    require(held["random no victims"][0] == 0.0,
            f"K5 with no victims read recall {held['random no victims'][0]}")
    log(f"K5 held bit-equal: {held}; replayed states: {states}")

    # least bytes at the drain's end: the live rows' know, the six [N]
    # bool leaves, the [U] table, the outputs, and bulk_cov only where a
    # bulk subject is not committed yet, as the 32-byte sectors holding one
    live = s.up & s.member
    n_live = int(live.sum())
    u = s.know.shape[1]
    need = s.bulk_member & ~s.committed_dead & ~s.committed_left
    cov_sectors = int(torch.unique(need.nonzero().flatten() // 8).numel())
    bytes_ = n_live * u + 6 * N + 32 * cov_sectors + 6 * u + 8
    out = (torch.empty(1, dtype=torch.float32, device=dev),
           torch.empty(1, dtype=torch.int32, device=dev))
    call = lambda: swim.mass_detection_stats(params, s, mask, out=out)  # noqa: E731
    t = {"call_ms": kernel_ms(call),
         "ms": device_ms(call, ("mass_detect_kernel",))["mass_detect_kernel"],
         "wrapper_ms": median_ms(call),
         "plain_ms": median_ms(lambda: swim.mass_detection_stats_plain(
             params, s, mask)),
         "bound_ms": bytes_ / HBM_BYTES_PER_S * 1000.0, "bound_bytes": bytes_,
         "bulk_cov_sectors": cov_sectors}
    t["phases"] = k5_phase_ms(params, s, mask)
    log("K5 mass_detect: " + json.dumps(t))
    rec = torch.empty(10, dtype=torch.float32, device=dev)
    fps = torch.empty(10, dtype=torch.int32, device=dev)

    def bulk_tick(st, i):
        st = swim.step(params, st)
        swim.mass_detection_stats(params, st, mask,
                                  out=(rec[i:i + 1], fps[i:i + 1]))
        return st

    syncs = count_syncs(bulk_tick, s, lambda st: st.tick,
                        params.probe_period_ticks)
    log(f"bulk path host syncs per tick (sync debug mode, 10 ticks): {syncs}")
    bulk_ms = fenced_ms_per_tick(params, s)
    log(f"1M tick with the bulk channel active: {bulk_ms} ms (fenced, 50 "
        f"ticks from the drain's end)")
    small = dict(CORRELATED, max_ticks=1024)
    card = correlated.run(nodes=4096, device=dev, **small)[0]
    cpu = correlated.run(nodes=4096, device="cpu", **small)[0]
    log(f"correlated at N=4096: card conv {card['conv_ticks_99']} recall "
        f"{card['recall_final']}, cpu conv {cpu['conv_ticks_99']} recall "
        f"{cpu['recall_final']}, {card['ticks_run']} ticks")
    require(card["recall_curve"] == cpu["recall_curve"]
            and card["fp_curve"] == cpu["fp_curve"]
            and card["conv_ticks_99"] == cpu["conv_ticks_99"],
            "correlated at N=4096: card and cpu curves differ")

    entry = {"name": "mass_detect", "route": "cuda",
             "source": "consul_tpu_torch/kernels/csrc/detect.cu",
             "replaces": "consul_tpu/models/swim.py:1578",
             "launches": launches["mass_detect"], "max_abs_err": 0.0,
             "ms": t["ms"], "call_ms": t["call_ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "phases": t["phases"], "shape": [N, u]}
    return entry, {"row": brief, "launches": launches, "k5_held": held,
                   "k5": t, "k5_states": states, "bulk_syncs": syncs,
                   "bulk_tick_ms": bulk_ms,
                   "n4096": {"conv_ticks_99": card["conv_ticks_99"],
                             "ticks_run": card["ticks_run"]}}


K5_PHASES = ("stream", "tail")


def k5_phase_ms(params, s, mask, reps: int = 10) -> dict:
    """Median ms of each phase of K5 at one state, from its instrumented
    build's %globaltimer stamps: the stream until the last block arrives,
    then the last block's tail."""
    with _instrumented("detect.cu", "DETECT_PHASE_TIMES", "mass_detect"):
        return _phase_ms("mass_detect", kernels.MASS_STAMP_AT, K5_PHASES,
                         lambda _: swim.mass_detection_stats(params, s, mask),
                         lambda: None, reps)


# ---------------------------------------------------------------------------
# phase 8: federation at 3 DCs x 50k, and the WAN pool's small shapes
# ---------------------------------------------------------------------------

WAN_SHAPE = (3, 50_000, 5)          # DCs, nodes per DC, servers per DC
# tools/scale_sweep.py's DC series at 128 nodes x 3 servers, beside the
# coverage ticks the JAX package's WANSCALE_r01.json holds for it (a 2-D
# mesh run on the CPU: printed, not gated)
WAN_SERIES = ((2, 10), (4, 15), (8, 15))


def check_small_shapes(dev) -> dict:
    """K1, K2 and swim._top_k against their twins at the federation's
    shapes, before anything is timed: K1's randint at spans of n - 1 <= 23
    (the WAN pools' gossip offsets and other_nodes), K2 at U = 16 and 8 on
    pools of 6, 15, 128 and 50,000 rows (fewer rows than a warp in the
    first two) with fanouts 3 and 4, and the top-k at N < k."""
    draws = 0
    for n in (2, 6, 9, 15, 24):
        for shape in ((3,), (4,), (n,), (n, 3)):
            for lo in (0, 1):
                d = prng.Draw("randint", prng.tick_key(7, n, 2), shape, lo, n)
                got = prng.draw([d], dev)[0]
                require(torch.equal(got, prng.draw_plain([d], dev)[0]),
                        f"K1 randint [{lo}, {n}) {shape} != plain")
                draws += 1
        got = prng.other_nodes(prng.tick_key(7, n, 8), n, (n,), dev)
        want = prng.other_nodes(prng.tick_key(7, n, 8), n, (n,), "cpu")
        require(torch.equal(got.cpu(), want), f"other_nodes n={n}")
    gossip_held = {}
    for n, slots, fanout in ((6, 8, 4), (6, 16, 4), (15, 16, 4), (15, 8, 4),
                             (24, 16, 4), (128, 8, 3), (50_000, 16, 3)):
        call = _random_gossip_call(dev, n, slots, fanout, seed=n + slots)
        gossip_held[f"N={n} U={slots} G={fanout}"] = _hold_gossip(
            call, f"N={n} U={slots}")
    top = 0
    for n, k in ((6, 8), (15, 16), (15, 8), (9, 9)):
        x = torch.randint(0, 3, (n,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(n + k))
        got = swim._top_k(x.to(dev), k)
        want = swim._top_k(x, k)
        require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                f"_top_k N={n} k={k}: card != cpu")
        top += 1
    log(f"small shapes held: K1 randint {draws} draws, K2 {gossip_held}, "
        f"top-k {top}")
    return {"k1_randint_draws": draws, "k2": gossip_held, "top_k": top}


def _tick_profile(step, s, kind_of, ticks: int = 10):
    """Fenced host ms and device kernels (torch.profiler, a tick each) per
    tick kind, over `ticks` ticks of each kind from s."""
    ms = {"gossip": [], "probe": []}
    st = _clone(s)
    while min(len(v) for v in ms.values()) < ticks:
        kind = kind_of(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) * 1000.0)
    seen = {"gossip": [], "probe": []}
    st = _clone(s)
    while min(len(v) for v in seen.values()) < ticks:
        kind = kind_of(st)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = step(st)
            torch.cuda.synchronize()
        ops = profile_tick._device_ops(prof)
        seen[kind].append(sum(v for k, v in ops.items()
                              if not k.startswith(("Memcpy", "Memset"))))
    return {kind: {"fenced_ms_median": sorted(ms[kind])[len(ms[kind]) // 2],
                   "fenced_ms": ms[kind][:ticks],
                   "kernels_per_tick": sum(seen[kind][:ticks]) / ticks}
            for kind in ms}


def wan_phase(dev, for_phase_11: dict) -> dict:
    """Phase 8, federation (models/wan.py) at BASELINE.json's 3 DCs x 50k
    nodes, 5 servers a DC, 16 rumor and event slots, 1% loss, seed 7, as
    tools/scale_sweep.py:_dc_point drives it, every launch count zeroed
    just before: event 7 fired at node 49,999 of DC 0 (no server) must
    cover every DC within 250 ticks; DC 2 crashed in the WAN pool must
    read unreachable and be committed dead within 1,000 ticks; the DC
    distance matrix is symmetric.  Then host syncs per tick (none on a
    gossip-only tick with every event table idle; the bridge's one read a
    tick with an event in flight), fenced ms and device kernels per
    gossip-only and probe tick, and the DC series 2, 4, 8 x 128 x 3 on the
    card and the CPU with equal coverage ticks.  K1, K2 and the top-k are
    held first at the WAN pool's small shapes."""
    small = check_small_shapes(dev)
    d, n, sp = WAN_SHAPE
    kernels.reset_launches()
    reads0, syncs0 = wan.host_syncs, swim.host_syncs
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, s, row = workloads.wan_point(d, n, sp, dev)
    cover_s = time.perf_counter() - t0
    s, part = workloads.wan_partition(params, s, 2)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    reads = wan.host_syncs - reads0
    log(f"federation {d} x {n} x {sp}: coverage {row}; partition {part}; "
        f"bridge reads {reads}, probe-flag reads {swim.host_syncs - syncs0}; "
        f"peak_mem_bytes={peak}; launches {launches}; setup+warm+coverage "
        f"wall {cover_s} s")
    require(row["convergence_ticks"] > 0,
            f"federation: event 7 did not cover every DC in 250 ticks: {row}")
    require(part["reachable_ticks"] >= 0 and part["committed_ticks"] >= 0,
            f"federation: DC 2's partition not detected in 1000 ticks: {part}")
    for name in ("threefry_draws", "gossip_pack", "gossip_exchange"):
        require(launches[name] > 0, f"{name} never launched on the WAN path")
    require(reads > 0, "the bridge never read its tables")
    for_phase_11["wan pool"] = (params.wan.swim, s.wan.swim.clone())
    dist = wan.dc_distance_matrix(params, s)
    require(bool(torch.isfinite(dist).all())
            and torch.allclose(dist, dist.T, rtol=1e-4, atol=0),
            f"dc_distance_matrix not symmetric: {dist.tolist()}")
    log(f"dc_distance_matrix (s): {dist.tolist()}")

    require(not any(any(c.events.active_host) for c in (*s.lan, s.wan)),
            "an event slot is still active after the partition")
    period = params.lan.swim.probe_period_ticks
    tick_of = lambda st: st.lan[0].swim.tick  # noqa: E731
    step = lambda st, _=None: wan.step(params, st)  # noqa: E731
    idle = count_syncs(step, s, tick_of, period)
    require(idle["gossip"] == 0, f"federation: idle gossip-only ticks "
            f"synchronized: {idle}")
    per_tick = _tick_profile(step, s, lambda st: "probe" if tick_of(st)
                             % period == 0 else "gossip")
    flying = wan.fire_event(params, s, 1, n - 2, 8)
    in_flight = count_syncs(step, flying, tick_of, period)
    log(f"federation host syncs per tick (sync debug mode, 10 ticks): idle "
        f"{idle}, event in flight {in_flight}; per tick {per_tick}")

    series = []
    for dcs, jax_ticks in WAN_SERIES:
        card = workloads.wan_point(dcs, 128, 3, dev)[2]
        cpu = workloads.wan_point(dcs, 128, 3, torch.device("cpu"))[2]
        log(f"federation {dcs} x 128 x 3: card {card['convergence_ticks']} "
            f"ticks ({card['converge_wall_s']} s), cpu "
            f"{cpu['convergence_ticks']} ({cpu['converge_wall_s']} s); the "
            f"JAX package's WANSCALE_r01.json {jax_ticks} (not a gate)")
        require(card["convergence_ticks"] == cpu["convergence_ticks"] > 0,
                f"federation {dcs} x 128: card {card} != cpu {cpu}")
        series.append({"n_dcs": dcs, "card": card["convergence_ticks"],
                       "cpu": cpu["convergence_ticks"], "jax_file": jax_ticks,
                       "card_wall_s": card["converge_wall_s"],
                       "cpu_wall_s": cpu["converge_wall_s"]})
    return {"coverage": row, "partition": part, "launches": launches,
            "bridge_reads": reads, "peak_mem_bytes": peak,
            "dc_distance_s": dist.tolist(), "syncs_idle": idle,
            "syncs_event_in_flight": in_flight, "per_tick": per_tick,
            "series_128": series, "small_shapes": small}


# ---------------------------------------------------------------------------
# phase 9: anti-entropy at 1M services, and K6
# ---------------------------------------------------------------------------

# 100,000 agents with 10 services each in a 2^20-row table; the
# reference's 1-minute full sync at a tick a second, scaled x11 for 100k
# agents (660 ticks); 1,000 re-registrations and 100 deregistrations a
# tick; agents 0-999 down for ticks 100-399
AE_CHURN = workloads.Churn(n_agents=100_000, capacity=1_048_576,
                           services=1_000_000)
# the card-against-CPU run: 4,096 services over 256 agents (120 ticks)
AE_SMALL = workloads.Churn(n_agents=256, capacity=4608, services=4096,
                           reregister=8, deregister=1, down_agents=3,
                           down_from=20, down_to=80)
AE_HELD_TICKS = {"mid_churn": 50, "agents_down": 200}


@contextlib.contextmanager
def _twin_calls():
    """Counts calls of K6's plain twins while the block runs."""
    calls = {"diff_sorted_plain": 0, "merge_plain": 0}
    saved = {name: getattr(reconcile, name) for name in calls}

    def counting(name):
        def fn(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return fn

    for name in calls:
        setattr(reconcile, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(reconcile, name, fn)


def _hold_k6(d_ids, d_ver, d_node, a_ids, a_ver, a_node, push, drop, due,
             what: str) -> dict:
    """K6 against its twin on one table pair, every output leaf and row:
    the diff in its plain form and in the step's (masked by `due` at the
    rows' owners), the merge in step's form (node columns, drop) and in
    apply_push's (neither)."""
    dk = reconcile.diff_sorted_kernel(d_ids, d_ver, a_ids, a_ver)
    dp = reconcile.diff_sorted_plain(d_ids, d_ver, a_ids, a_ver)
    _same(dk.push, dp.push, f"diff push ({what})", "K6")
    _same(dk.drop, dp.drop, f"diff drop ({what})", "K6")
    step = (due, d_node, a_node)
    sk = reconcile.diff_sorted_kernel(d_ids, d_ver, a_ids, a_ver, *step)
    sp = reconcile.diff_sorted_plain(d_ids, d_ver, a_ids, a_ver, *step)
    _same(sk.push, sp.push, f"step diff push ({what})", "K6")
    _same(sk.drop, sp.drop, f"step diff drop ({what})", "K6")
    for form, args in (("step", (d_node, a_node, drop)),
                       ("apply_push", (None, None, None))):
        dn, an, dr = args
        mk = reconcile.merge_kernel(d_ids, d_ver, dn, a_ids, a_ver, an, push,
                                    dr)
        mp = reconcile.merge_plain(d_ids, d_ver, dn, a_ids, a_ver, an, push,
                                   dr)
        for leaf in ("ids", "ver", "node"):
            g, w = getattr(mk, leaf), getattr(mp, leaf)
            require((g is None) == (w is None), f"K6 merge {leaf} presence")
            if g is not None:
                _same(g, w, f"merge {form} {leaf} ({what})", "K6")
    inv = reconcile.INVALID_ID
    return {"m": d_ids.numel(), "k": a_ids.numel(),
            "valid_desired": int((d_ids != inv).sum()),
            "valid_catalog": int((a_ids != inv).sum()),
            "pushed": int((push & (d_ids != inv)).sum()),
            "dropped": int(drop.sum()) if drop is not None else 0,
            "diff_push": int(dp.push.sum()), "diff_drop": int(dp.drop.sum()),
            "step_push": int(sp.push.sum()), "step_drop": int(sp.drop.sum())}


def _k6_tables(dev, m, k, vd, va, shared, p_push, p_drop, seed):
    """Random sorted tables: vd valid desired ids, va catalog ids of which
    a `shared` part are desired ids, INVALID tails, random payloads on
    every row (tails included; the nodes are owners in [0, AE agents)),
    random masks, and a random `due` over the agents."""
    rng = np.random.default_rng(seed)
    d_valid = np.sort(rng.choice(2 ** 30, vd, replace=False)) if vd else \
        np.empty(0, np.int64)
    n_shared = min(int(shared * min(vd, va)), va)
    take = rng.choice(d_valid, n_shared, replace=False) if n_shared else \
        np.empty(0, np.int64)
    fresh = np.setdiff1d(rng.choice(2 ** 30, 2 * (va - n_shared) + 16,
                                    replace=False), d_valid)
    a_valid = np.sort(np.concatenate([take, rng.permutation(fresh)[:va - n_shared]]))
    agents = AE_CHURN.n_agents

    def table(rows, valid):
        ids = np.full(rows, reconcile.INVALID_ID, np.int32)
        ids[:len(valid)] = valid
        return [torch.from_numpy(x).to(dev) for x in (
            ids, rng.integers(0, 9, rows).astype(np.int32),
            rng.integers(0, agents, rows).astype(np.int32))]

    d, a = table(m, d_valid), table(k, a_valid)
    push = torch.from_numpy(rng.random(m) < p_push).to(dev)
    drop = torch.from_numpy(rng.random(k) < p_drop).to(dev)
    due = torch.from_numpy(rng.random(agents) < 0.7).to(dev)
    return d, a, push, drop, due


M20, M21 = 1 << 20, 1 << 21
# (M, K, valid desired, valid catalog, shared part, push rate, drop rate);
# the boundary tables put equal ids at every split a tile can make:
# "interleaved" holds one id set in both tables (the merge alternates
# desired and catalog rows of equal ids), then a lone desired row over a
# catalog with no INVALID row, one row on either side, and odd sizes
K6_RANDOM = {
    "M != K": (700_001, M20, 600_000, 900_000, 0.5, 0.5, 0.3),
    "every row pushed": (M20, M20, 900_000, 800_000, 0.5, 1.0, 0.0),
    "none pushed": (M20, M20, 900_000, 800_000, 0.5, 0.0, 0.3),
    "all INVALID": (M20, M20, 0, 0, 0.0, 0.5, 0.5),
    "every pushed id in the catalog": (M20, M20, 500_000, 500_000, 1.0, 1.0,
                                       0.0),
    "overflow (valid rows > K)": (M20, M20 // 2, 1_000_000, 500_000, 0.1,
                                  1.0, 0.0),
    "2^21 rows": (M21, M21, 1_900_000, 1_800_000, 0.7, 0.5, 0.1),
    "interleaved": (M20, M20, 1_000_000, 1_000_000, 1.0, 0.5, 0.3),
    "one desired over a full catalog": (M20, M20, 1, M20, 1.0, 1.0, 0.3),
    "M = 1": (1, M20, 1, 900_000, 1.0, 1.0, 0.3),
    "K = 1": (M20, 1, 900_000, 1, 1.0, 0.5, 0.0),
    "M = 1,000,003, K = 999,983": (1_000_003, 999_983, 950_000, 900_000,
                                   0.7, 0.5, 0.2),
}


def _diff_bytes(d_ids, d_ver, a_ids, a_ver) -> int:
    """Least bytes of the diff on these tables: every id, the versions of
    the ids present in both tables, the two masks."""
    inv = reconcile.INVALID_ID
    hits = int((torch.isin(d_ids, a_ids) & (d_ids != inv)).sum())
    m, k = d_ids.numel(), a_ids.numel()
    return 4 * (m + k) + 8 * hits + (m + k)


def _step_diff_bytes(d_ids, d_ver, a_ids, a_ver, due, d_node, a_node) -> int:
    """Least bytes of the diff in the step's form: the plain form's, the
    owner of every row the plain masks set, and the due flags of those
    owners."""
    dp = reconcile.diff_sorted_plain(d_ids, d_ver, a_ids, a_ver)
    owners = torch.cat([d_node[dp.push], a_node[dp.drop]])
    return (_diff_bytes(d_ids, d_ver, a_ids, a_ver) + 4 * owners.numel()
            + torch.unique(owners).numel())


def _merge_bytes(m: int, k: int) -> int:
    """Least bytes of the merge in step's form: every id and mask, the
    version and node of the K rows that land in the output, the output."""
    return 5 * (m + k) + 8 * k + 12 * k


K6_PHASES = ("classify", "barrier", "scatter")


def k6_phase_ms(merge, reps: int = 10) -> dict:
    """Median ms of each phase of the merge, from its instrumented build's
    %globaltimer stamps: phase 1 until its slowest block, the grid barrier
    and the totals' read, phase 2 until its slowest block."""
    with _instrumented("reconcile.cu", "MERGE_PHASE_TIMES", "reconcile_merge"):
        return _phase_ms("reconcile_merge", kernels.MERGE_STAMP_AT, K6_PHASES,
                         lambda _: merge(), lambda: None, reps)


def time_k6(params, s, up) -> tuple:
    """Both K6 launches at one replayed state (the diff in both forms):
    device ms (kernel_ms: dispatch hidden, L2 evicted; device_ms: the
    profiler's records), the merge's device kernels and allocations a
    call and its phases, wrapper call ms, twin ms, the library's calls
    (library_times: the diff's two searchsorted calls; one stable sort
    for the merge) and bounds."""
    _, due, push, drop = antientropy.sync_masks(params, s, up)
    cols = (s.d_ids, s.d_ver, s.a_ids, s.a_ver)
    step_cols = (*cols, due, s.d_node, s.a_node)
    diff = lambda: reconcile.diff_sorted_kernel(*cols)  # noqa: E731
    diff_step = lambda: reconcile.diff_sorted_kernel(*step_cols)  # noqa: E731
    merge = lambda: reconcile.merge_kernel(  # noqa: E731
        s.d_ids, s.d_ver, s.d_node, s.a_ids, s.a_ver, s.a_node, push, drop)
    m, k = s.d_ids.numel(), s.a_ids.numel()
    db, sb = _diff_bytes(*cols), _step_diff_bytes(*step_cols)
    mb = _merge_bytes(m, k)
    t_diff = {"ms": kernel_ms(diff),
              "device_ms": device_ms(diff, ("diff_kernel",))["diff_kernel"],
              "call_ms": median_ms(diff),
              "plain_ms": median_ms(lambda: reconcile.diff_sorted_plain(*cols),
                                    reps=5),
              # the whole diff: a search each way (diff_sorted_plain's two)
              **library_times(lambda: (
                  torch.searchsorted(s.a_ids, s.d_ids),
                  torch.searchsorted(s.d_ids, s.a_ids))),
              "bound_ms": db / HBM_BYTES_PER_S * 1000.0, "bound_bytes": db,
              "step": {
                  "ms": kernel_ms(diff_step),
                  "device_ms": device_ms(diff_step,
                                         ("diff_kernel",))["diff_kernel"],
                  "call_ms": median_ms(diff_step),
                  "plain_ms": median_ms(lambda: reconcile.diff_sorted_plain(
                      *step_cols), reps=5),
                  "bound_ms": sb / HBM_BYTES_PER_S * 1000.0,
                  "bound_bytes": sb}}
    t_merge = {"ms": kernel_ms(merge),
               "device_ms": device_ms(merge, ("merge_kernel",))["merge_kernel"],
               "phase_ms": k6_phase_ms(merge),
               "call_ms": median_ms(merge),
               "plain_ms": median_ms(lambda: reconcile.merge_plain(
                   s.d_ids, s.d_ver, s.d_node, s.a_ids, s.a_ver, s.a_node,
                   push, drop), reps=5),
               **library_times(lambda: torch.sort(
                   torch.cat([s.d_ids, s.a_ids]), stable=True)),
               "bound_ms": mb / HBM_BYTES_PER_S * 1000.0, "bound_bytes": mb}
    return t_diff, t_merge


def _spread(xs) -> dict:
    xs = sorted(xs)
    q = lambda f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
    return {"median": q(0.5), "p10": q(0.1), "p90": q(0.9), "min": xs[0],
            "max": xs[-1], "n": len(xs)}


def ae_phase(dev) -> tuple:
    """Phase 9, anti-entropy (models/antientropy.py) at BASELINE.json's
    1M services: AEParams(n_agents=100_000, capacity=1_048_576,
    sync_interval_ticks=60, seed=7), every service registered in one
    command in random order, one step pushing them all, 660 churn ticks
    (one scaled interval) with agents 0-999 down for ticks 100-399, a
    final step with everyone up; every launch count zeroed just before
    and the twins' calls counted: in_sync_fraction 1.0, the catalog's
    live count the desired live count, K6 twice a step and once an
    in_sync_fraction, the twins never.  Then K6 against its twin,
    bit-equal, on the replayed first-push, mid-churn and agents-down
    states and on random tables; both launches timed at the mid-churn
    state; the workload at 4,096 services on the card and the CPU with
    the same digest.  Returns (the two kernels-line entries, the
    record)."""
    params = AE_CHURN.params
    held_states = {}
    wanted = {v: name for name, v in AE_HELD_TICKS.items()}

    def keep(label, s, up):
        if label == "first_push" or label in wanted:
            held_states[wanted.get(label, label)] = (s, up)

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with _twin_calls() as twins:
        r = workloads.ae_churn(AE_CHURN, dev, keep=keep)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    brief = {k: v for k, v in r.items()
             if k not in ("state", "step_ms", "register_ms", "deregister_ms")}
    times = {"step_ms": _spread(r["step_ms"][1:-1]),
             "first_push_step_ms": r["step_ms"][0],
             "final_step_ms": r["step_ms"][-1],
             "register_1m_ms": r["register_ms"][0],
             "register_ms": _spread(r["register_ms"][1:]),
             "deregister_ms": _spread(r["deregister_ms"])}
    log(f"anti-entropy at {AE_CHURN.services} services: {brief}; wall {wall} "
        f"s; launches {launches}; twin calls {twins}; peak_mem_bytes={peak}")
    log("anti-entropy fenced ms: " + json.dumps(times))
    require(r["in_sync"] == 1.0, f"anti-entropy in_sync {r['in_sync']}")
    require(r["catalog_live"] == r["desired_live"] == r["desired_rows"],
            f"anti-entropy: catalog {r['catalog_live']} rows, desired "
            f"{r['desired_live']} live ({r['desired_rows']} rows)")
    require(launches["reconcile_diff"] == r["steps"] + r["in_sync_calls"]
            and launches["reconcile_merge"] == r["steps"],
            f"K6 launches {launches} for {r['steps']} steps")
    require(twins == {"diff_sorted_plain": 0, "merge_plain": 0},
            f"K6's twins ran on the card: {twins}")
    require(launches["threefry_draws"] == r["steps"] + 1,
            f"K1 launches {launches['threefry_draws']}: want one a step and "
            f"the stagger")

    held = {}
    for name, (s, up) in held_states.items():
        _, due, push, drop = antientropy.sync_masks(params, s, up)
        held[name] = _hold_k6(s.d_ids, s.d_ver, s.d_node, s.a_ids, s.a_ver,
                              s.a_node, push, drop, due, f"replayed {name}")
    for i, (name, shape) in enumerate(sorted(K6_RANDOM.items())):
        d, a, push, drop, due = _k6_tables(dev, *shape, seed=100 + i)
        held[name] = _hold_k6(*d, *a, push, drop, due, name)
        if name == "M != K":      # the step's own masks on these tables
            diff = reconcile.diff_sorted_plain(d[0], d[1], a[0], a[1])
            held["M != K, the diff's masks"] = _hold_k6(
                *d, *a, diff.push, diff.drop, due,
                "M != K, the diff's masks")
    log(f"K6 held bit-equal: {json.dumps(held)}")

    s, up = held_states["mid_churn"]
    t_diff, t_merge = time_k6(params, s, up)
    log(f"K6 reconcile_diff: {json.dumps(t_diff)}")
    log(f"K6 reconcile_merge: {json.dumps(t_merge)}")
    log(f"K6 device ms against the bound: diff {t_diff['device_ms']} / "
        f"{t_diff['bound_ms']} (step form {t_diff['step']['device_ms']} / "
        f"{t_diff['step']['bound_ms']}; the two searchsorted calls "
        f"{t_diff['library_device_ms']}), merge {t_merge['device_ms']} / "
        f"{t_merge['bound_ms']} (phases {t_merge['phase_ms']})")

    card = workloads.ae_churn(AE_SMALL, dev, digest=True)
    cpu = workloads.ae_churn(AE_SMALL, torch.device("cpu"), digest=True)
    log(f"anti-entropy at {AE_SMALL.services} services: card {card['digest']} "
        f"in_sync {card['in_sync']}, cpu {cpu['digest']} in_sync "
        f"{cpu['in_sync']}, {card['steps']} steps")
    require(card["digest"] == cpu["digest"] and card["in_sync"] == 1.0,
            "anti-entropy at 4096 services: card and cpu digests differ")

    entries = []
    for name, t, replaces in (
            ("reconcile_diff", t_diff, "consul_tpu/ops/reconcile.py:28"),
            ("reconcile_merge", t_merge,
             "consul_tpu/models/antientropy.py:157")):
        entries.append({"name": name, "route": "cuda",
                        "source": "consul_tpu_torch/kernels/csrc/reconcile.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": 0.0, "ms": t["ms"],
                        "device_ms": t["device_ms"],
                        "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": "bytes",
                        "library_ms": t["library_ms"],
                        "library_device_ms": t["library_device_ms"],
                        "library_call_ms": t["library_call_ms"],
                        "shape": [s.d_ids.numel(), s.a_ids.numel()]})
    entries[0]["step_form"] = t_diff["step"]
    entries[1]["phase_ms"] = t_merge["phase_ms"]
    return entries, {"run": brief, "wall_s": wall, "launches": launches,
                     "twin_calls": twins, "peak_mem_bytes": peak,
                     "times": times, "k6_held": held, "k6_diff": t_diff,
                     "k6_merge": t_merge,
                     "small": {"digest": card["digest"],
                               "steps": card["steps"]}}


# ---------------------------------------------------------------------------
# phase 10: the standalone Vivaldi solver at 100k nodes
# ---------------------------------------------------------------------------

VIVALDI_N = 100_000
# card against CPU at n = 4,096: the error curves agree within this
# relative gap.  The port and the JAX package, two float implementations,
# stay within 1e-5 of scale of each other tick by tick on the CPU
# (tests/test_torch_vivaldi.py), the spring relaxation contracts such
# gaps rather than growing them, and the median reads many pairs.
VIVALDI_CURVE_RTOL = 1e-3


def vivaldi_phase(dev) -> dict:
    """Phase 10, the standalone Vivaldi solver (VivaldiParams(n_nodes=
    100_000, dims=8, seed=7), true coordinates uniform(PRNGKey(7)) x 60
    ms, 400 sim_step ticks, as tests/test_vivaldi.py:_converge builds
    them), every launch count zeroed just before: the median relative
    error under 0.15 and under a third of the initial; K1 once for the
    true coordinates, three times a tick and twice an error read.  The error every 50 ticks, fenced ms a
    tick and sort_by_distance(0)'s wall are recorded; at n = 4,096 the
    card's and the CPU's curves agree within VIVALDI_CURVE_RTOL."""
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    r = workloads.vivaldi_converge(VIVALDI_N, device=dev)
    launches = dict(kernels.LAUNCHES)
    draw_launches = dict(kernels.DRAW_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    sort_ms = wall_ms(lambda: vivaldi.sort_by_distance(r["state"], 0))
    ms_tick = 1000.0 * r["wall_s"] / r["ticks"]
    reads = 1 + len(r["curve"])
    log(f"vivaldi at n={VIVALDI_N}: err0 {r['err0']} curve {r['curve']} "
        f"fenced ms per tick {ms_tick} sort_by_distance(0) {sort_ms} ms "
        f"launches {launches} peak_mem_bytes={peak}")
    require(r["err"] < 0.15 and r["err"] < r["err0"] / 3,
            f"vivaldi: error {r['err']} (initial {r['err0']})")
    require(launches["threefry_draws"] == 1 + 3 * r["ticks"] + 2 * reads,
            f"vivaldi: K1 launches {launches['threefry_draws']}")
    card = workloads.vivaldi_converge(4096, device=dev)
    cpu = workloads.vivaldi_converge(4096, device=torch.device("cpu"))
    gap = max(abs(a[1] - b[1]) / b[1] for a, b in zip(card["curve"],
                                                      cpu["curve"]))
    log(f"vivaldi at n=4096: card {card['curve']}, cpu {cpu['curve']}, "
        f"largest relative gap {gap}")
    require(card["err0"] == cpu["err0"] and gap <= VIVALDI_CURVE_RTOL,
            f"vivaldi at n=4096: card and cpu curves differ by {gap}")
    return {"err0": r["err0"], "curve": r["curve"], "ms_per_tick": ms_tick,
            "wall_s": r["wall_s"], "sort_by_distance_ms": sort_ms,
            "launches": launches, "draw_launches": draw_launches,
            "peak_mem_bytes": peak,
            "n4096": {"card": card["curve"], "cpu": cpu["curve"],
                      "gap": gap}}


# ---------------------------------------------------------------------------
# phase 11: the probe round (K7) and rumor origination (K8)
# ---------------------------------------------------------------------------

# device kernels a main-path probe tick ran while K10 was two launches
# (profile_tick's count on an NVIDIA H100 80GB HBM3 at 700 W), and the
# most a probe tick may run now (K10 one cooperative launch)
# the plain twins of K7-K12 and K14 in models/swim.py, and K13's in
# models/vivaldi.py
SWIM_TWINS = ("_probe_pass_plain", "_probe_round_plain", "_originate_plain",
              "_maps_plain", "_map_add_plain", "_maps_convert_plain",
              "_suspicion_expiry_plain", "_dense_suspicion_expiry_plain",
              "_refutation_plain", "_expire_plain", "_bulk_step_plain")
VIVALDI_TWINS = ("observe_ring_plain",)


def _on_card(args) -> bool:
    """Whether a twin's call carries CUDA tensors: its first state or
    tensor argument decides."""
    for x in args:
        if isinstance(x, swim.SwimState):
            return x.know.is_cuda
        if isinstance(x, vivaldi.VivaldiState):
            return x.coords.is_cuda
        if isinstance(x, torch.Tensor):
            return x.is_cuda
    return False


@contextlib.contextmanager
def swim_twin_calls():
    """Counts calls of K7-K14's plain twins on CUDA states while the block
    runs (CPU states, as the card-against-CPU runs make, take them by
    design)."""
    twins = [(swim, name) for name in SWIM_TWINS] \
        + [(vivaldi, name) for name in VIVALDI_TWINS]
    calls = {name: 0 for _, name in twins}
    saved = {name: (mod, getattr(mod, name)) for mod, name in twins}

    def counting(name):
        def fn(*a, **k):
            calls[name] += int(_on_card(a))
            return saved[name][1](*a, **k)
        return fn

    for mod, name in twins:
        setattr(mod, name, counting(name))
    try:
        yield calls
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_originate():
    """swim._originate is its twin while the block runs: the plain side of
    a hold of a K8 caller (_dense_suspicion_expiry, rejoin, leave)."""
    saved = swim._originate
    swim._originate = swim._originate_plain
    try:
        yield
    finally:
        swim._originate = saved


def _state(x, y, kernel: str, what: str) -> None:
    """Two swim states bit-equal, leaf by leaf and host mirror by mirror."""
    require(x.tick == y.tick and x.bulk_live == y.bulk_live,
            f"{kernel} {what}: host mirrors differ")
    for f in swim.TENSOR_FIELDS:
        _same(getattr(x, f), getattr(y, f), f"{what} {f}", kernel)


def _eviction(s, want) -> tuple:
    """(evicting, slots it releases) of _originate on s and want."""
    live = s.up & s.member
    cov = (s.know & live[:, None]).sum(0).float() \
        / live.sum().clamp_min(1).float()
    evicting = bool((want > 0).sum() > (~s.r_active).sum())
    done = s.r_active & (cov >= 0.995) & (s.r_kind != swim.SUSPECT)
    return evicting, int(done.sum()) if evicting else 0


def _same_storage(x, y, fields, kernel: str, what: str) -> None:
    """The in-place proof: each leaf of y is x's own tensor."""
    for f in fields:
        require(getattr(y, f).data_ptr() == getattr(x, f).data_ptr(),
                f"{kernel} {what}: {f} is not the input's tensor (in place)")


def hold_originate(params, s, want, kind: int, row_subject, what: str):
    """K8 against its twin on one call, K8 on a clone of s: every state
    leaf and the (subjects, slots, ok) of the allocation bit-equal,
    padding rows of the top-A included, and the rows, committed leaves and
    table the clone's own tensors.  Returns (evicting, slots released)."""
    x = s.clone()
    got = swim._originate(params, x, want, kind, x.incarnation, row_subject)
    ref = swim._originate_plain(params, s, want, kind, s.incarnation,
                                row_subject)
    _state(got[0], ref[0], "K8", what)
    _same_storage(x, got[0], swim.ORIGINATE_INPLACE, "K8", what)
    for a, b, name in zip(got[1], ref[1], ("subjects", "slots", "ok")):
        _same(a, b, f"{what} {name}", "K8")
    return _eviction(s, want)


def _random_want(n: int, dev, seed: int, p: float):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hit = torch.rand(n, generator=gen, device=dev) < p
    val = torch.randint(1, 3, (n,), generator=gen, device=dev)
    return torch.where(hit, val, 0).to(torch.int32)


def hold_probe(params, s, what: str, callers: bool = False) -> dict:
    """K7 and K8 against their twins on one state, every leaf bit-equal
    (rtt_ms too: both take torch's IEEE sqrt on the card), each kernel
    call on a clone of its input (the kernels update it in place; the
    twins are pure): the probe pass alone, its in-place leaves the clone's
    own tensors; K8 on its wants as a suspect round and as a dead one, on
    random wants of 1 and 2 (ties, more wanters than slots), on a single
    wanter and on none; the whole round.  With `callers`, also the dense
    expiry and rejoin/leave of the probe round's first target (K8's other
    callers) against the same calls with the twin."""
    maps = swim._maps(params, s)
    drawn = swim._probe_inputs(params, s)
    x = s.clone()
    got = swim._probe_pass(params, x, maps, drawn)
    ref = swim._probe_pass_plain(params, s, maps, drawn)
    _state(got[0], ref[0], "K7", what)
    _same_storage(x, got[0], swim.PROBE_INPLACE, "K7", what)
    _same(got[1], ref[1], f"{what} want", "K7")
    _same(got[2], ref[2], f"{what} row_subject", "K7")
    _same(got[3].rtt_ms, ref[3].rtt_ms, f"{what} rtt_ms", "K7")
    _same(got[3].acked, ref[3].acked, f"{what} acked", "K7")
    require(int(got[3].shift) == int(ref[3].shift), f"K7 {what} shift")
    s1, want, rows = ref[0], ref[1], ref[2]
    n = params.n_nodes
    dev = s.device
    one = torch.zeros(n, dtype=torch.int32, device=dev)
    one[n // 3] = 1
    evictions = [
        hold_originate(params, s1, want, swim.SUSPECT, rows, f"{what} suspect"),
        hold_originate(params, s1, want, swim.DEAD, rows, f"{what} dead"),
        hold_originate(params, s1, _random_want(n, dev, n, 0.01), swim.ALIVE,
                       rows, f"{what} random wants"),
        hold_originate(params, s1, one, swim.LEFT, rows, f"{what} one wanter"),
        hold_originate(params, s1, torch.zeros_like(want), swim.SUSPECT, rows,
                       f"{what} no wanter")]
    a = swim._probe_round(params, s.clone(), profile_tick.copy_maps(maps))
    b = swim._probe_round_plain(params, s, maps)
    _state(a[0], b[0], "K7+K8", what)
    for x, y, name in zip(a[2], b[2], ("suspect_of", "dead_of", "left_of",
                                       "alive_val")):
        _same(x, y, f"{what} {name}", "K7+K8")
    _same(a[1].rtt_ms, b[1].rtt_ms, f"{what} rtt_ms", "K7+K8")
    _same(a[1].acked, b[1].acked, f"{what} acked", "K7+K8")
    if callers:
        node = int(drawn["offs"][0]) % n
        kd = swim._dense_suspicion_expiry(params, s1.clone(), got[3].shift,
                                          maps)
        kr = swim.rejoin(params, s.clone(), node)
        kl = swim.leave(params, s.clone(), node)
        with plain_originate():
            # K11's launches still update s1 in place, and the twin's s1
            # shares its unchanged leaves with s
            pd = swim._dense_suspicion_expiry(params, s1.clone(), got[3].shift,
                                              maps)
            pr = swim.rejoin(params, s, node)
            pl = swim.leave(params, s, node)
        _state(kd, pd, "K8", f"{what} dense expiry")
        _state(kr, pr, "K8", f"{what} rejoin({node})")
        _state(kl, pl, "K8", f"{what} leave({node})")
    return {"tick": s.tick, "n": n, "u": params.rumor_slots,
            "failed": int((rows >= 0).sum()), "wanted": int((want > 0).sum()),
            "joined": int((ref[0].know & ~s.know).sum()),
            "evicting_calls": sum(e[0] for e in evictions),
            "released_slots": sum(e[1] for e in evictions)}


def _peak_growth(grown: dict, name: str, fn):
    """fn(), with grown[name] = how far the peak of
    torch.cuda.memory_allocated rose above its level before the call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    grown[name] = torch.cuda.max_memory_allocated() - base
    return out


def _no_block(x, ptrs: dict, grown: dict, what: str, which: str) -> dict:
    """Every leaf of x still the tensor of `ptrs`, and no call in `grown`
    allocated an [N, U] block (N * U bytes, the smallest [N, U] leaf)."""
    rows_bytes = x.know.numel()
    for f in swim.TENSOR_FIELDS:
        require(getattr(x, f).data_ptr() == ptrs[f],
                f"{what}: {f} left its tensor across {which}")
    log(f"{what}: bytes allocated at the peak of each call {grown} "
        f"(an [N, U] bool is {rows_bytes})")
    for name, b in grown.items():
        require(b < rows_bytes, f"{what}: {name} allocated {b} bytes, an "
                f"[N, U] block is {rows_bytes}")
    return {"peak_growth_bytes": grown, "nu_bytes": rows_bytes}


def no_row_allocation(params, s, what: str) -> dict:
    """K7 then K8 on a clone of s on the card, as a probe round runs them:
    the leaves they write are the clone's own tensors, and neither call
    allocates an [N, U] block (the peak of torch.cuda.memory_allocated
    across each call grows by less than N * U bytes, the smallest [N, U]
    leaf: their fresh outputs are [N] and [A])."""
    x = s.clone()
    maps = swim._maps(params, x)
    drawn = swim._probe_inputs(params, x)
    grown = {}
    ptrs = {f: getattr(x, f).data_ptr() for f in swim.TENSOR_FIELDS}
    s1, want, rows, _ = _peak_growth(grown, "K7", lambda: swim._probe_pass(
        params, x, maps, drawn))
    s2, _ = _peak_growth(grown, "K8", lambda: swim._originate(
        params, s1, want, swim.SUSPECT, s1.incarnation, rows))
    return _no_block(s2, ptrs, grown, what, "K7 and K8")


def _random_probe_state(dev, params, s, seed: int):
    """Random leaves for K7/K8 of s's shape: rumors of every kind about a
    few subjects (duplicates across slots), knowledge, learn ticks around
    the timeouts, running timers, committed nodes, bulk members, LHA
    scores, and the chaos leaves."""
    n, u = s.know.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    ints = lambda lo, hi, *shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev)
    tick = 40_000 + 5 * seed
    up, member = rnd(n) < 0.97, rnd(n) < 0.98
    # suspicions about crashed members, whose probes fail: joiner cells
    subjects = (~up & member).nonzero().flatten()[:12].to(torch.int32)
    amax = max(params.awareness_max, 1)
    return s.replace(
        tick=tick, up=up, member=member,
        incarnation=ints(0, 4, n).to(torch.int32),
        coords=rnd(n, 2) * 30.0,
        committed_dead=rnd(n) < 0.01, committed_left=rnd(n) < 0.005,
        committed_inc=ints(0, 3, n).to(torch.int32),
        r_active=rnd(u) < 0.8, r_kind=ints(0, 4, u).to(torch.int8),
        r_subject=subjects[ints(0, 12, u)], r_inc=ints(0, 4, u).to(torch.int32),
        r_start=(tick - ints(0, 200, u)).to(torch.int32),
        r_confirm=ints(0, 65, u).to(torch.int8),
        r_coverage=rnd(u),
        know=rnd(n, u) < torch.where(rnd(u) < 0.3, 0.998, 0.3)[None, :],
        learn_tick=(swim._t16(tick) - ints(0, 80, n, u)).to(torch.int16),
        sends_left=ints(0, params.retransmit_limit + 1, n, u).to(torch.int8),
        sus_start=torch.where(rnd(n) < 0.05, tick - ints(0, 60, n),
                              -1).to(torch.int32),
        sus_confirm=ints(0, 65, n).to(torch.int8),
        sus_count=ints(0, 3, n).to(torch.int32),
        bulk_member=rnd(n) < 0.01, awareness=ints(0, amax, n).to(torch.int8),
        chaos_grp=(rnd(n) < 0.3).to(torch.int16),
        chaos_ok=torch.where(rnd(n) < 0.1, 0.6, 1.0).to(torch.float32),
        ctr=rnd(swim.CTR_N) * 1000.0)


def _pool_states(dev, gossip, sim, kills, ticks: int, every: int = 3):
    """Probe-tick states of a small pool run on the card (K7 and K8 inside)
    with `kills` crashed at tick 5."""
    params = swim.make_params(gossip, sim)
    s = swim.init_state(params, device=dev)
    out = []
    for t in range(ticks):
        if t == 5:
            for v in kills:
                s = swim.kill(s, v)
        if t > 5 and s.tick % params.probe_period_ticks == 0:
            out.append(s.clone())
        s = swim.step(params, s)
    return params, out[::every]


def _probe_bytes(params, s, maps, ref) -> int:
    """Least bytes of K7 on s, written in place, given the twin's result
    `ref` (state, want, row_subject, obs): per prober its know row, the
    32-byte learn_tick sector of the target's suspect slot where it knows
    the slot, its draws, coords, the [N] leaves read at the target and the
    fresh [N] outputs (want, row_subject, rtt, acked: 13 bytes); the
    sectors of the timers, awareness and joiner cells that change."""
    n, u = s.know.shape
    k = params.indirect_checks
    draws = 4 * (2 + (params.awareness_max > 0) + 3 * k)
    leaves = 5 + 4 + 16 + 9 + (params.awareness_max > 0) \
        + (6 if params.chaos else 0)
    ss = rolls.pull(maps[0], ref[3].shift)
    known = (ss >= 0) & swim._row_gather(s.know, torch.where(ss < u, ss, -1))
    out = ref[0]
    changed = _written(*[(getattr(s, f), getattr(out, f))
                         for f in swim.PROBE_INPLACE if f != "ctr"])
    return n * (u + draws + 8 + leaves + 13) + 32 * int(known.sum()) + changed


def _originate_bytes(s, want, row_subject, evicting: bool, ref) -> int:
    """Least bytes of K8 given the twin's state `ref`: want and
    row_subject, the [U] table, with an eviction know and up/member; the
    sectors of the rows and committed leaves it changes."""
    n, u = s.know.shape
    changed = _written(*[(getattr(s, f), getattr(ref, f))
                         for f in swim.ORIGINATE_INPLACE[:6]])
    return 8 * n + 40 * u + ((u + 2) * n if evicting else 0) + changed


# originate.cu's kStamps: the phase stamps of its instrumented build
K8_STAMPS = 192
K8_PHASES = ("select", "merge_decide", "barrier", "evict", "seed")


@contextlib.contextmanager
def _instrumented(source: str, macro: str, entry: str):
    """The kernel library's `entry` taken from csrc/`source` built alone
    with -D`macro` while the block runs (the wrapper, its checks and its
    count unchanged): K8's and K14's phase-time builds."""
    lib = ctypes.CDLL(str(build.variant(source, macro)))
    fn = getattr(lib, entry)
    fn.argtypes = kernels.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    base = kernels.library()

    class Swap:
        def __getattr__(self, name):
            return fn if name == entry else getattr(base, name)

    kernels._lib = Swap()
    try:
        yield
    finally:
        kernels._lib = base


def _phase_ms(scratch_key: str, first: int, phases, call, make,
              reps: int) -> dict:
    """Median ms of each phase from an instrumented build's %globaltimer
    stamps, scratch words first .. first + len(phases) of the kernel's
    scratch (zeroed before each call); a phase whose end was not stamped
    (an early return) reads None."""
    dev = torch.device("cuda", 0)
    n = len(phases)
    runs = []
    for _ in range(reps + 1):
        x = make()
        call(x)                     # the scratch exists after one call
        sc = kernels._scratch[(dev, scratch_key)]
        x = make()
        sc[first:first + n + 1].zero_()
        torch.cuda.synchronize()
        call(x)
        torch.cuda.synchronize()
        t = sc[first:first + n + 1].tolist()
        runs.append([(t[k + 1] - t[k]) / 1e6 if t[k] and t[k + 1] else None
                     for k in range(n)])
    out = {}
    for k, name in enumerate(phases):
        col = [r[k] for r in runs[1:]]
        out[name] = None if None in col else sorted(col)[len(col) // 2]
    return out


def k8_phase_ms(call, make, reps: int = 10) -> dict:
    """Median ms of each phase of K8 on make()'s input (clones), from its
    instrumented build's %globaltimer stamps: the select until its
    slowest block, the global merge and decision in the last block, the
    grid barrier, the eviction's coverage count, decision and barrier (0
    without one), the seed until its slowest block."""
    with _instrumented("originate.cu", "ORIGINATE_PHASE_TIMES", "originate"):
        return _phase_ms("originate", K8_STAMPS, K8_PHASES, call, make, reps)


def time_probe(params, s, what: str) -> dict:
    """K7 and K8 timed at one state: device ms (torch.profiler's kernel
    records, L2 evicted), the wrapper call, the twins, the bounds, and
    torch.topk of the wants beside K8's select (library_times).  Each
    kernel call gets a clone of its input, made outside the timed
    window."""
    maps = swim._maps(params, s)
    drawn = swim._probe_inputs(params, s)
    ref7 = swim._probe_pass_plain(params, s, maps, drawn)
    s1, want, rows, _ = ref7
    ref8 = swim._originate_plain(params, s1, want, swim.SUSPECT,
                                 s1.incarnation, rows)[0]
    k7 = lambda x: swim._probe_pass(params, x, maps, drawn)  # noqa: E731
    k8 = lambda x: swim._originate(params, x, want, swim.SUSPECT,  # noqa: E731
                                   x.incarnation, rows)
    evicting, released = _eviction(s1, want)
    b7 = _probe_bytes(params, s, maps, ref7)
    b8 = _originate_bytes(s1, want, rows, evicting, ref8)
    t = {"k7_ms": device_ms(k7, ("probe_round_kernel",),
                            make=s.clone)["probe_round_kernel"],
         "k7_call_ms": median_ms(k7, make=s.clone),
         "k7_plain_ms": median_ms(lambda: swim._probe_pass_plain(
             params, s, maps, drawn), reps=5),
         "k7_bound_ms": b7 / HBM_BYTES_PER_S * 1000.0, "k7_bound_bytes": b7,
         "k8_ms": device_ms(k8, ("originate_kernel",),
                            make=s1.clone)["originate_kernel"],
         "k8_call_ms": median_ms(k8, make=s1.clone),
         "k8_plain_ms": median_ms(lambda: swim._originate_plain(
             params, s1, want, swim.SUSPECT, s1.incarnation, rows), reps=5),
         "k8_bound_ms": b8 / HBM_BYTES_PER_S * 1000.0, "k8_bound_bytes": b8,
         "k8_phase_ms": k8_phase_ms(k8, s1.clone),
         "k8_evicting": evicting, "k8_released": released,
         **{k.replace("library", "topk"): v for k, v in library_times(
             lambda: torch.topk(want, params.alloc_cap)).items()}}
    log(f"K7/K8 timed at {what}: " + json.dumps(t))
    return t


def fenced_main_ticks(params, s, ticks: int = 50) -> dict:
    """Fenced host ms per probe and gossip-only tick of the main path
    (serf.step and its monitor call) from s."""
    out = torch.empty(1, dtype=torch.float32, device=s.swim.device)
    period = params.swim.probe_period_ticks
    walls = {"probe": [], "gossip": []}
    s = _clone(s)
    for _ in range(ticks):
        kind = "probe" if s.swim.tick % period == 0 else "gossip"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = serf.step(params, s)
        swim.believed_down_fraction(params.swim, s.swim, bench.VICTIM,
                                    out=out)
        torch.cuda.synchronize()
        walls[kind].append((time.perf_counter() - t0) * 1000.0)
    return {k: {"median": sorted(v)[len(v) // 2], "mean": sum(v) / len(v),
                "ticks": len(v)} for k, v in walls.items()}


def probe_phase(dev, main: dict, states: dict) -> tuple:
    """Phase 11: K7 and K8 against their twins on the card, then timed.
    The holds: the main path at the kill, at the first probe round with a
    suspect rumor, mid-convergence and at its end (with the dense expiry,
    rejoin and leave as K8 callers); the 1M chaos states of phase 6 (a
    degraded set, a 25% partition); the correlated run's 1M states of
    phase 7 (evicting: more wanters than free slots, covered dead slots
    released); the federation's WAN pool (15 nodes, U = 16); small pools
    on the card at the WAN config (N = 15, U = 16 and N = 6, U = 8); pools
    in the modes no phase reaches (the deterministic degraded set, no LHA
    and no relays, U = 64 with 40 slots a round); random 1M states in the
    main, degraded and chaos configs.  K7 and K8 are timed at the main
    path's first-suspicion and final states and at the evicting state.
    Returns (the kernels-line entries, the record)."""
    params = main["params"]
    p = params.swim
    held = {}
    t0 = time.perf_counter()
    # the main path replayed from the seed to its first suspect rumor
    _, s, _ = bench.prepare(device=dev)
    at_kill = s.swim.clone()
    first = None
    for _ in range(200):
        s = serf.step(params, s)
        sw = s.swim
        if sw.tick % p.probe_period_ticks == 0 and bool(
                (sw.r_active & (sw.r_kind == swim.SUSPECT)).any()):
            first = sw
            break
    require(first is not None, "no suspect rumor in 200 ticks after the kill")
    main_states = {"at_kill": at_kill, "first_suspicion": first,
                   "mid": states["mid"][1], "final": states["final"][1]}
    for name, st in main_states.items():
        held[f"main {name}"] = hold_probe(p, st, f"main {name}", callers=True)
    for name in ("chaos degradation", "chaos partitioned",
                 "correlated near_bar", "correlated drain_end", "wan pool"):
        hp, st = states[name]
        held[name] = hold_probe(hp, st, name, callers=name.startswith("wan"))
    for name, gossip, sim, kills in (
            ("wan 15x16", GossipConfig.wan(),
             SimConfig(n_nodes=15, rumor_slots=16, p_loss=0.01, seed=3), (4,)),
            ("wan 6x8", GossipConfig.wan(),
             SimConfig(n_nodes=6, rumor_slots=8, p_loss=0.01, seed=4), (2,)),
            ("degraded 4096", GossipConfig.lan(),
             SimConfig(n_nodes=4096, rumor_slots=32, p_loss=0.01, seed=5,
                       degraded_frac=0.1, degraded_loss=0.3), (9, 77, 500)),
            ("no LHA, no relays 4096", dataclasses.replace(
                GossipConfig.lan(), awareness_max_multiplier=0,
                indirect_checks=0),
             SimConfig(n_nodes=4096, rumor_slots=32, p_loss=0.05, seed=6),
             (9, 77)),
            ("U=64 A=40 4096", GossipConfig.lan(),
             SimConfig(n_nodes=4096, rumor_slots=64, alloc_cap=40,
                       p_loss=0.01, seed=8), tuple(range(0, 4096, 41)))):
        hp, sts = _pool_states(dev, gossip, sim, kills, 120)
        for i, st in enumerate(sts):
            held[f"{name} #{i}"] = hold_probe(hp, st, f"{name} #{i}",
                                              callers=i % 3 == 0)
    for name, hp in (("main", p),
                     ("degraded", dataclasses.replace(
                         p, degraded_frac=0.1, degraded_loss=0.3)),
                     ("chaos", dataclasses.replace(p, chaos=True))):
        st = _random_probe_state(dev, hp, at_kill, seed=len(held))
        held[f"random 1M {name}"] = hold_probe(hp, st, f"random 1M {name}",
                                               callers=True)
    evicting = sum(h["evicting_calls"] for h in held.values())
    released = sum(h["released_slots"] for h in held.values())
    log(f"K7/K8 held bit-equal on {len(held)} states in "
        f"{time.perf_counter() - t0:.1f} s; K8 calls that evicted "
        f"{evicting}, slots released {released}")
    for name, h in held.items():
        log(f"  {name}: {json.dumps(h)}")
    require(held["correlated near_bar"]["evicting_calls"] > 0,
            "no K8 hold on the correlated state evicted")
    require(released > 0, "no K8 hold released a slot")
    require(sum(h["joined"] for h in held.values()) > 0,
            "no K7 hold seeded a joiner cell")
    in_place = {"first_suspicion": no_row_allocation(p, first,
                                                     "first_suspicion"),
                "evicting": no_row_allocation(*states["correlated near_bar"],
                                              "correlated near_bar")}

    timed = {"first_suspicion": time_probe(p, first, "first_suspicion"),
             "final": time_probe(p, main_states["final"], "final"),
             "evicting": time_probe(*states["correlated near_bar"],
                                    "correlated near_bar")}
    ticks = fenced_main_ticks(params, main["state"])
    log(f"main path fenced ms per tick (50 ticks from the final state): "
        f"{json.dumps(ticks)}")
    t = timed["first_suspicion"]
    launches = main["all_launches"]
    shape = [p.n_nodes, p.rumor_slots, p.indirect_checks]
    entries = [
        {"name": "probe_round", "route": "cuda",
         "source": "consul_tpu_torch/kernels/csrc/probe.cu",
         "replaces": "consul_tpu/models/swim.py:698",
         "launches": launches["probe_round"], "max_abs_err": 0.0,
         "ms": t["k7_ms"], "call_ms": t["k7_call_ms"],
         "plain_ms": t["k7_plain_ms"], "bound_ms": t["k7_bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": shape},
        {"name": "originate", "route": "cuda",
         "source": "consul_tpu_torch/kernels/csrc/originate.cu",
         "replaces": "consul_tpu/models/swim.py:605",
         "launches": launches["originate"], "max_abs_err": 0.0,
         "ms": t["k8_ms"], "call_ms": t["k8_call_ms"],
         "plain_ms": t["k8_plain_ms"], "bound_ms": t["k8_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "topk_ms": t["topk_ms"], "topk_device_ms": t["topk_device_ms"],
         "topk_call_ms": t["topk_call_ms"],
         "evicting_ms": timed["evicting"]["k8_ms"],
         "evicting_bound_ms": timed["evicting"]["k8_bound_ms"],
         "shape": [p.n_nodes, p.rumor_slots, p.alloc_cap]}]
    return entries, {"held": held, "timed": timed, "fenced_main_ticks": ticks,
                     "in_place": in_place}


# ---------------------------------------------------------------------------
# phase 12: the rest of the probe tick's detector passes (K9-K12)
# ---------------------------------------------------------------------------

MAP_NAMES = ("suspect_of", "dead_of", "left_of", "alive_val")
# kernels-line entry: (device kernels, source, the JAX function it replaces)
DETECTOR_ENTRIES = {
    "subject_maps": (("subject_maps_kernel",), "maps.cu",
                     "consul_tpu/models/swim.py:392"),
    "map_add": (("map_add_kernel",), "maps.cu",
                "consul_tpu/models/swim.py:414"),
    "maps_convert": (("maps_convert_kernel",), "maps.cu",
                     "consul_tpu/models/swim.py:422"),
    "suspicion_expiry": (("expiry_kernel",), "expiry.cu",
                         "consul_tpu/models/swim.py:900"),
    "dense_expiry": (("dense_pre_kernel", "dense_post_kernel"), "dense.cu",
                     "consul_tpu/models/swim.py:965"),
    "refutation": (("refutation_kernel",), "refute.cu",
                   "consul_tpu/models/swim.py:1086"),
    "expire": (("expire_kernel",), "refute.cu",
               "consul_tpu/models/swim.py:1267"),
}


def _maps_same(got, ref, what: str) -> None:
    for x, y, name in zip(got, ref, MAP_NAMES):
        if y is not None:
            _same(x, y, f"{what} {name}", "K9")


def _refuting(before, after) -> tuple:
    """(slots refuted, of them dead rumors, subjects with two or more) of
    a _refutation from `before` to `after`."""
    need = before.r_active & (after.r_kind == swim.ALIVE) \
        & (before.r_kind != swim.ALIVE)
    subj = before.r_subject[need]
    twice = int((torch.bincount(subj.long()) >= 2).sum()) if subj.numel() else 0
    return (int(need.sum()), int((need & (before.r_kind == swim.DEAD)).sum()),
            twice)


def hold_refutation(params, s, what: str):
    """K12's refutation against its twin on s, the kernel on a clone of s:
    every leaf bit-equal, and the leaves it writes the clone's own
    tensors.  Returns the twin's result."""
    x = s.clone()
    got = swim._refutation(params, x)
    ref = swim._refutation_plain(params, s)
    _state(got, ref, "K12 refutation", what)
    _same_storage(x, got, swim.REFUTE_INPLACE, "K12 refutation", what)
    return ref


def hold_expire(params, s, what: str):
    """K12's expire against its twin on s, the kernel on a clone of s:
    every leaf bit-equal, and the leaves it writes the clone's own
    tensors.  Returns the twin's result."""
    x = s.clone()
    got = swim._expire(params, x)
    ref = swim._expire_plain(params, s)
    _state(got, ref, "K12 expire", what)
    _same_storage(x, got, swim.FREE_INPLACE, "K12 expire", what)
    return ref


def hold_detector(params, s, what: str) -> dict:
    """K9-K12 against their twins along the probe tick from s (a probe-tick
    state), every output leaf bit-equal, each pass on the twin's input of
    the tick: the maps (K9's build), the probe round's map_add of K8's
    allocation, the slot expiry (K10), maps_convert of its conversions,
    the dense expiry (K11 around K8; its twin with K8's twin), the
    refutation and expire (K12); K12 also on s itself.  K9's updates run
    on a copy of their maps (the rows of one [4, N] block, as _maps
    writes them) and K10-K12 on a clone of their input, whose maps or
    leaves they must write in place (what they return is the copy's own
    tensors), K9's updates with no allocation.  Returns what the tick
    exercised: among it the slots the probe round's origination evicted
    and how many map entries differ from maps rebuilt from the table
    (stale by design after an eviction)."""
    ref = swim._maps_plain(params, s)
    maps = swim._maps(params, s)
    _maps_same(maps, ref, f"{what} maps")
    drawn = swim._probe_inputs(params, s)
    s0, want, rows, obs = swim._probe_pass(params, s.clone(), maps, drawn)
    s1, alloc = swim._originate(params, s0.clone(), want, swim.SUSPECT,
                                s0.incarnation, rows)
    evicted = int((s0.r_active & ((s1.r_subject != s0.r_subject)
                                  | (s1.r_kind != s0.r_kind)
                                  | ~s1.r_active)).sum())
    grown = {}
    kmap = ref[0].clone()
    added = _peak_growth(grown, "map_add", lambda: swim._map_add(kmap, *alloc))
    require(added is kmap, f"K9 {what}: map_add returned a new map")
    _same(added, swim._map_add_plain(ref[0], *alloc), f"{what} map_add",
          "K9")
    maps1 = (added, *ref[1:])
    x10 = s1.clone()
    s2, conv = swim._suspicion_expiry(params, x10)
    p2, pconv = swim._suspicion_expiry_plain(params, s1)
    _state(s2, p2, "K10", what)
    _same_storage(x10, s2, swim.EXPIRY_INPLACE, "K10", what)
    _same(conv, pconv, f"{what} convert", "K10")
    kmaps = profile_tick.copy_maps(maps1)
    maps2 = _peak_growth(grown, "maps_convert", lambda: swim._maps_convert(
        kmaps, s2, conv))
    require(all(a is b for a, b in zip(maps2, kmaps)),
            f"K9 {what}: maps_convert returned new maps")
    _maps_same(maps2, swim._maps_convert_plain(maps1, s2, conv),
               f"{what} maps_convert")
    require(not any(grown.values()),
            f"K9 {what}: its updates allocated {grown} bytes")
    stale = sum(int((x != y).sum())
                for x, y in zip(maps2, swim._maps_plain(params, s2)))
    x11 = s2.clone()
    s3 = swim._dense_suspicion_expiry(params, x11, obs.shift, maps2)
    with plain_originate():
        p3 = swim._dense_suspicion_expiry_plain(params, s2, obs.shift, maps2)
    _state(s3, p3, "K11", what)
    _same_storage(x11, s3, swim.DENSE_INPLACE + swim.ORIGINATE_INPLACE,
                  "K11", what)
    s4 = hold_refutation(params, s3, what)
    s5 = hold_expire(params, s4, what)
    for base, name in ((s, "raw"), (s2, "after K10")):
        hold_expire(params, hold_refutation(params, base, f"{what} {name}"),
                    f"{what} {name}")
    refuted, dead_refuted, twice = _refuting(s3, s4)
    return {"tick": s.tick, "n": params.n_nodes, "u": params.rumor_slots,
            "chaos": params.chaos, "converted": int(conv.sum()),
            "dense_dead": int((s2.r_active & (s2.r_kind == swim.SUSPECT)
                               & (s3.r_kind == swim.DEAD)).sum()),
            "dense_originated": int((s3.r_active & ~s2.r_active).sum()),
            "overflow": int((s3.bulk_member & ~s2.bulk_member).sum()),
            "refuted": refuted, "dead_refuted": dead_refuted,
            "refuted_twice": twice,
            "freed": int((s4.r_active & ~s5.r_active).sum()),
            "committed": int((s5.committed_dead != s4.committed_dead).sum()
                             + (s5.committed_left != s4.committed_left).sum()
                             + (s5.committed_inc != s4.committed_inc).sum()),
            "evicted": evicted, "stale_map_entries": stale}


def no_expiry_allocation(params, s, what: str) -> dict:
    """The probe round, then K10, the dense expiry (K11 around K8), K12's
    refutation and its expire on a clone of s on the card, as a probe tick
    runs them: the leaves they write are the clone's own tensors, and none
    of them allocates an [N, U] block (their fresh outputs are [U], [2, N],
    [3] and K8's [A]; K12 allocates nothing)."""
    x = s.clone()
    x, obs, maps = swim._probe_round(params, x, swim._maps(params, x))
    grown = {}
    ptrs = {f: getattr(x, f).data_ptr() for f in swim.TENSOR_FIELDS}
    x, conv = _peak_growth(grown, "K10", lambda: swim._suspicion_expiry(
        params, x))
    maps = _peak_growth(grown, "K9 maps_convert", lambda: swim._maps_convert(
        maps, x, conv))
    x = _peak_growth(grown, "K11+K8", lambda: swim._dense_suspicion_expiry(
        params, x, obs.shift, maps))
    x = _peak_growth(grown, "K12 refutation", lambda: swim._refutation(
        params, x))
    x = _peak_growth(grown, "K12 expire", lambda: swim._expire(params, x))
    return _no_block(x, ptrs, grown, what, "K10-K12")


def capture_expire(params, s) -> dict:
    """K12's expire (one cooperative launch) captured in a CUDA graph on a
    clone of s, then replayed: the capture must take the cooperative
    launch, and the replay's state is bit-equal to the twin's (a captured
    probe tick needs its cooperative launches, ROADMAP queue B)."""
    swim._expire(params, s.clone())   # its scratch is made before capture
    x = s.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        swim._expire(params, x)
    graph.replay()
    torch.cuda.synchronize()
    ref = swim._expire_plain(params, s)
    _state(x, ref, "K12 expire", "graph replay")
    freed = int((s.r_active & ~ref.r_active).sum())
    log(f"K12 expire captured in a CUDA graph and replayed at tick "
        f"{s.tick}: bit-equal to its twin, {freed} slots freed")
    return {"tick": s.tick, "freed": freed}


def _random_detector_state(dev, params, s, seed: int):
    """_random_probe_state's leaves (of s's shape), with what K9-K12 branch
    on: crashed subjects whose dense timers expired long ago (dead
    conversions, and wants that overflow the A slots), live subjects that
    know their own suspect and dead rumors (refutations; slots 0 and 1 are
    a suspect and a dead rumor of one live subject, both refuting), slots
    past their windows at full coverage (frees and commits), and learn
    ticks 0-300 ticks old (the Lifeguard timeouts at 1M are 125-725), 1% of
    them 33,000-60,000 ticks old, an age the int16 difference wraps to a
    negative one."""
    r = _random_probe_state(dev, params, s, seed)
    n, u = r.know.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    ints = lambda lo, hi, *shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev)
    tick = r.tick
    live = r.up & r.member
    crashed = (~r.up & r.member).nonzero().flatten()[:8].to(torch.int32)
    alive = live.nonzero().flatten()[:8].to(torch.int32)
    subjects = torch.cat([crashed, alive])
    r_subject = subjects[ints(0, subjects.numel(), u)]
    r_subject[0] = r_subject[1] = alive[0]
    r_kind = r.r_kind.clone()
    r_kind[0], r_kind[1] = swim.SUSPECT, swim.DEAD
    r_active = r.r_active.clone()
    r_active[:2] = True
    incarnation = r.incarnation.clone()
    r_inc = r.r_inc.clone()
    r_inc[:2] = incarnation[alive[0].long()] + torch.tensor(
        [1, 0], dtype=torch.int32, device=dev)
    know = r.know.clone()
    know[alive.long()[:, None], torch.arange(u, device=dev)[None, :]] = True
    sus_start = r.sus_start.clone()
    sus_start[crashed.long()] = tick - 5000
    sus_start = torch.where((rnd(n) < 0.03) & (sus_start < 0),
                            tick - ints(0, 400, n), sus_start).to(torch.int32)
    age = torch.where(rnd(n, u) < 0.01, ints(33_000, 60_000, n, u),
                      ints(0, 300, n, u))
    learn = (swim._t16(tick) - age) % 65536
    learn = torch.where(learn >= 32768, learn - 65536, learn).to(torch.int16)
    return r.replace(r_subject=r_subject.to(torch.int32), r_kind=r_kind,
                     r_active=r_active, r_inc=r_inc.to(torch.int32),
                     know=know, sus_start=sus_start, learn_tick=learn,
                     bulk_heard=rnd(n) * 100.0, bulk_cov=rnd(n))


def _replay_events(params, s, ticks: int) -> dict:
    """The main path's probe-tick states from s for `ticks` ticks, keeping
    the first one whose tick converted a suspect slot (K10), converted one
    through the dense timers (K11), refuted (K12) and freed a slot: the
    passes are spied on through their wrappers (a host read each, outside
    any timed window)."""
    p = params.swim
    seen: dict = {}
    events = {}
    saved = {name: getattr(swim, name) for name in (
        "_suspicion_expiry", "_dense_suspicion_expiry", "_refutation",
        "_expire")}

    def spy_expiry(pp, st):
        out = saved["_suspicion_expiry"](pp, st)
        seen["convert"] = bool(out[1].any())
        return out

    def spy_dense(pp, st, shift, maps):
        suspect = st.r_active & (st.r_kind == swim.SUSPECT)   # before K8
        out = saved["_dense_suspicion_expiry"](pp, st, shift, maps)
        seen["dense"] = bool((suspect & (out.r_kind == swim.DEAD)).any())
        return out

    def spy_refute(pp, st):
        kind = st.r_kind.clone()    # K12 rewrites the table in place
        out = saved["_refutation"](pp, st)
        seen["refute"] = bool((out.r_kind != kind).any())
        return out

    def spy_expire(pp, st):
        active = st.r_active.clone()
        out = saved["_expire"](pp, st)
        seen["free"] = bool((active & ~out.r_active).any())
        return out

    spies = {"_suspicion_expiry": spy_expiry,
             "_dense_suspicion_expiry": spy_dense, "_refutation": spy_refute,
             "_expire": spy_expire}
    try:
        for name, fn in spies.items():
            setattr(swim, name, fn)
        for _ in range(ticks):
            before = s.clone()
            seen.clear()
            s = serf.step(params, s)
            for event, hit in seen.items():
                if hit and event not in events:
                    events[event] = before.swim
    finally:
        for name, fn in saved.items():
            setattr(swim, name, fn)
    return events


def _sector_bytes(changed: torch.Tensor, elem: int) -> int:
    """32 bytes for each 32-byte sector, of a tensor of `elem`-byte
    elements laid out row-major, that holds a True of `changed`."""
    flat = changed.reshape(-1)
    per = 32 // elem
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return 32 * int(flat.view(-1, per).any(1).sum())


def _written(*pairs) -> int:
    """Bytes an update in place writes: the sectors where each output
    differs from its input."""
    return sum(_sector_bytes(new != old, old.element_size())
               for old, new in pairs)


TABLE_BYTES = 14   # a slot's active, kind, subject, inc and start


def _dense_stamps(params, s, maps) -> tuple:
    """The slots K11 converts on s and the known cells of their columns
    (the twin's exp_u and sel)."""
    active = s.sus_start >= 0
    age = s.tick - s.sus_start
    refute = active & s.up & s.member & (age >= params.probe_period_ticks)
    expired = active & ~refute & (age >= swim._timeouts(params, s.sus_confirm)) \
        & s.member
    subj = s.r_subject.long()
    exp_u = s.r_active & (s.r_kind == swim.SUSPECT) & expired[subj] \
        & (maps[1][subj] < 0) & ~s.committed_dead[subj]
    return exp_u, exp_u[None, :] & s.know


def _detector_bytes(params, s, which: str, out, *extra) -> int:
    """Least bytes of each K9-K12 entry on s, given its result `out`: each
    input the result depends on read once, whole (a [U] gather: one
    32-byte sector a gathered subject), outputs written in place (only
    the 32-byte sectors whose values change, by _written), nothing
    between launches.  subject_maps builds its four maps, written whole.
    map_add reads its ok pairs and the map at their subjects;
    maps_convert the converting slots and both maps at their subjects.
    suspicion_expiry reads know, up/member and the learn_tick sector of
    each live row that knows a suspect slot, and gathers committed_inc.
    dense_expiry (its pre and post launches; K8 apart) reads the timers,
    up/member, committed dead/left, bulk_member, bulk_heard and the three
    maps (26 bytes a node), and know where a slot converts.  Each launch
    alone (the sharded entries): dense_pre reads the timers, up/member,
    committed_dead, bulk_member and the three maps (21 bytes a node) and
    know where a slot converts, writes want and row_subject whole (8) and
    the stamps; dense_post reads want, the dead and left maps, up/member,
    committed dead/left, the bulk leaves' member and heard and the timers
    (26 bytes a node) and K8's pairs, and writes the sectors of the timers
    and bulk leaves that change.  refutation
    gathers know, up, member, incarnation and awareness at the refutable
    slots' subjects and reads every node's score (with Lifeguard's
    awareness_max > 0: the clamp covers every node).  expire reads know
    and up/member and gathers the committed leaves at the freed slots'
    subjects."""
    n, u = s.know.shape
    table = TABLE_BYTES * u
    if which == "subject_maps":
        return 16 * n + table
    if which == "map_add":
        base, (_, _, ok) = extra
        return 9 * ok.numel() + 32 * int(ok.sum()) + _written((base, out))
    if which == "maps_convert":
        maps, conv = extra
        return 5 * u + 64 * int(conv.sum()) \
            + _written((maps[0], out[0]), (maps[1], out[1]))
    if which == "suspicion_expiry":
        live = s.up & s.member
        suspect = s.r_active & (s.r_kind == swim.SUSPECT)
        rows = int(((s.know & suspect[None, :]).any(1) & live).sum())
        o = out[0]
        return (u + 2) * n + 32 * rows + table + 32 * int(suspect.sum()) \
            + u + _written((s.know, o.know), (s.learn_tick, o.learn_tick),
                           (s.sends_left, o.sends_left), (s.r_kind, o.r_kind),
                           (s.r_start, o.r_start))
    if which in ("dense_expiry", "dense_pre", "dense_post"):
        exp_u, sel = _dense_stamps(params, s, extra[0])
        stamped = _sector_bytes(sel & (s.learn_tick != swim._t16(s.tick)), 2) \
            + _sector_bytes(sel & (s.sends_left != params.retransmit_limit), 1)
        know = u * n if bool(exp_u.any()) else 0
        post = _written(
            (s.sus_start, out.sus_start), (s.sus_confirm, out.sus_confirm),
            (s.bulk_member, out.bulk_member),
            (s.bulk_heard, out.bulk_heard), (s.bulk_cov, out.bulk_cov))
        if which == "dense_pre":
            return 29 * n + know + table + u + stamped
        if which == "dense_post":
            return 26 * n + 9 * params.alloc_cap + 5 * u + post
        return 26 * n + know + table + u + stamped + post
    if which == "refutation":
        refutable = s.r_active & ((s.r_kind == swim.SUSPECT)
                                  | (s.r_kind == swim.DEAD))
        scores = n if params.awareness_max > 0 else 0
        return table + 5 * 32 * int(refutable.sum()) + scores + _written(
            (s.incarnation, out.incarnation), (s.awareness, out.awareness),
            (s.know, out.know), (s.learn_tick, out.learn_tick),
            (s.sends_left, out.sends_left), (s.r_kind, out.r_kind),
            (s.r_inc, out.r_inc), (s.r_start, out.r_start))
    if which == "expire":
        freed = int((s.r_active & ~out.r_active).sum())
        return (u + 2) * n + table + 3 * 32 * freed + _written(
            (s.know, out.know), (s.sends_left, out.sends_left),
            (s.committed_dead, out.committed_dead),
            (s.committed_left, out.committed_left),
            (s.committed_inc, out.committed_inc),
            (s.r_active, out.r_active), (s.r_coverage, out.r_coverage))
    raise ValueError(which)


def time_detector(params, s, only=None) -> dict:
    """K9-K12 (or the entries named in `only`) timed at one state, each
    pass on its input of the probe tick from s (expire after the twin's
    refutation): device ms (torch.profiler's kernel records, L2 evicted;
    multi-kernel entries summed), the wrapper call and the twin (CUDA
    events, dispatch included), the bound, and the library's calls for
    subject_maps (a torch.full and a scatter_reduce_ for each of the four
    maps) and map_add (one scatter_reduce of the origination's pairs).
    K12's entries also give the slots that refute and that are freed."""
    maps = swim._maps(params, s)
    drawn = swim._probe_inputs(params, s)
    s1, want, rows, obs = swim._probe_pass(params, s.clone(), maps, drawn)
    s1, alloc = swim._originate(params, s1, want, swim.SUSPECT,
                                s1.incarnation, rows)
    s2, conv = swim._suspicion_expiry(params, s1.clone())
    maps2 = swim._maps_convert(profile_tick.copy_maps(maps), s2, conv)
    s3 = swim._dense_suspicion_expiry(params, s2.clone(), obs.shift, maps2)
    s4 = swim._refutation_plain(params, s3)
    calls = {
        "subject_maps": (lambda: swim._maps(params, s),
                         lambda: swim._maps_plain(params, s), s, ()),
        # K9's updates, K10 and K11 (with K8 inside) update their input in
        # place: a copy a call
        "map_add": (lambda m: swim._map_add(m, *alloc),
                    lambda: swim._map_add_plain(maps[0], *alloc), s,
                    (maps[0], alloc), maps[0].clone),
        "maps_convert": (lambda m: swim._maps_convert(m, s2, conv),
                         lambda: swim._maps_convert_plain(maps, s2, conv),
                         s2, (maps, conv),
                         lambda: profile_tick.copy_maps(maps)),
        "suspicion_expiry": (lambda st: swim._suspicion_expiry(params, st),
                             lambda: swim._suspicion_expiry_plain(params, s1),
                             s1, (), s1.clone),
        "dense_expiry": (lambda st: swim._dense_suspicion_expiry(
            params, st, obs.shift, maps2), lambda: swim.
            _dense_suspicion_expiry_plain(params, s2, obs.shift, maps2), s2,
            (maps2,), s2.clone),
        "refutation": (lambda st: swim._refutation(params, st),
                       lambda: swim._refutation_plain(params, s3), s3, (),
                       s3.clone),
        "expire": (lambda st: swim._expire(params, st),
                   lambda: swim._expire_plain(params, s4), s4, (),
                   s4.clone)}
    if only is not None:
        calls = {k: v for k, v in calls.items() if k in only}
    # the library's build: per map a torch.full and a scatter_reduce_ of
    # the masked table (index and value vectors made outside the timing)
    u = params.rumor_slots
    slots_u = torch.arange(u, dtype=torch.int32, device=s.device)
    scatters = []
    for kind, vals in ((swim.SUSPECT, slots_u), (swim.DEAD, slots_u),
                       (swim.LEFT, slots_u),
                       (swim.ALIVE, s.r_inc * u + slots_u)):
        mask = s.r_active & (s.r_kind == kind)
        scatters.append((torch.where(mask, s.r_subject, 0).long(),
                         torch.where(mask, vals, -1)))

    def library_maps():
        return [torch.full((params.n_nodes,), -1, dtype=torch.int32,
                           device=s.device).scatter_reduce_(0, i, v, "amax")
                for i, v in scatters]

    _maps_same(library_maps(), swim._maps_plain(params, s),
               "subject_maps library calls")
    subjects, slots, ok = alloc
    pair_subj = torch.where(ok, subjects, 0).long()
    pair_val = torch.where(ok, slots, -1)
    library = {
        "subject_maps": library_maps,
        "map_add": lambda: maps[0].scatter_reduce(0, pair_subj, pair_val,
                                                  "amax", include_self=True)}
    _same(library["map_add"](), swim._map_add(maps[0].clone(), *alloc),
          "map_add library call", "K9")
    out = {}
    for name, (call, plain, at, extra, *make) in calls.items():
        make = make[0] if make else None
        names = DETECTOR_ENTRIES[name][0]
        phases = device_ms(call, names, make=make)
        b = _detector_bytes(params, at, name,
                            call(make()) if make else call(), *extra)
        out[name] = {
            "ms": sum(phases.values()),
            "phase_ms": phases if len(phases) > 1 else None,
            "call_ms": median_ms(call, make=make),
            "plain_ms": median_ms(plain, reps=5),
            "bound_ms": b / HBM_BYTES_PER_S * 1000.0, "bound_bytes": b,
            **(library_times(library[name]) if name in library
               else {"library_ms": None})}
        if name == "refutation":
            out[name]["refuted"] = _refuting(s3, s4)[0]
        if name == "dense_expiry":
            # each launch alone, for the sharded entries
            for part in ("pre", "post"):
                out[name][f"{part}_bound_ms"] = _detector_bytes(
                    params, at, f"dense_{part}", call(make()), *extra) \
                    / HBM_BYTES_PER_S * 1000.0
        if name == "expire":
            out[name]["freed"] = int((s4.r_active
                                      & ~swim._expire_plain(params, s4)
                                      .r_active).sum())
        log(f"{name} timed at tick {s.tick}: " + json.dumps(out[name]))
    return out


def _correlated_overflow_state(dev) -> tuple:
    """The correlated bench (1M, 1%, seed 7) replayed from the seed to the
    last probe tick before its bulk channel gains members: that tick's
    dense expiry seeds the overflow."""
    params = correlated.bench_params(N, seed=CORRELATED["seed"])
    s, mask = correlated.start(params, CORRELATED["fractions"][0],
                               CORRELATED["seed"], dev)
    last = None
    for _ in range(2000):
        if s.tick % params.probe_period_ticks == 0:
            last = s.clone()
        s, _, _ = correlated.run_chunk(params, s, 1, mask)
        if bool(s.bulk_member.any()):
            return params, last
    raise AssertionError("the correlated replay never seeded the bulk channel")


def detector_phase(dev, main: dict, states: dict) -> tuple:
    """Phase 12: K9-K12 against their twins on the card along whole probe
    ticks, then timed.  The holds: the main path at the kill, mid-
    convergence and its end, and the first probe ticks of its replay that
    converted a suspect slot (K10), converted one through the dense timers
    (K11), refuted a false suspicion and freed a slot; the correlated run
    at the tick whose dense expiry seeds the bulk channel and at the
    evicting mid-drain state (stale maps); the 1M chaos states (overflow
    off); the federation's WAN pool and small pools on the card (N = 15,
    U = 16, N = 6, U = 8 and a lossy 4,096-node pool at U = 64, the
    64-bit slot words); random 1M states in the main, chaos and
    no-LHA configs (dead rumors refuted, two slots of one subject, wrapped
    int16 ages).  Returns (the kernels-line entries, the record)."""
    params = main["params"]
    p = params.swim
    held = {}
    t0 = time.perf_counter()
    _, s, _ = bench.prepare(device=dev)
    at_kill = s.swim.clone()
    events = _replay_events(params, s, 300)
    log(f"main path replay: first probe ticks with each event: "
        f"{ {k: v.tick for k, v in events.items()} }")
    for name in ("convert", "refute", "free"):
        require(name in events, f"the main path replay never saw {name}")
    for name, st in (("at_kill", at_kill), ("mid", states["mid"][1]),
                     ("final", states["final"][1]),
                     *[(f"first {k}", v) for k, v in events.items()]):
        held[f"main {name}"] = hold_detector(p, st, f"main {name}")
    cp, overflow = _correlated_overflow_state(dev)
    held["correlated overflow"] = hold_detector(cp, overflow,
                                                "correlated overflow")
    for name in ("correlated near_bar", "correlated drain_end",
                 "chaos degradation", "chaos partitioned", "wan pool"):
        hp, st = states[name]
        held[name] = hold_detector(hp, st, name)
    for name, gossip, sim, kills in (
            ("wan 15x16", GossipConfig.wan(),
             SimConfig(n_nodes=15, rumor_slots=16, p_loss=0.01, seed=3), (4,)),
            ("wan 6x8", GossipConfig.wan(),
             SimConfig(n_nodes=6, rumor_slots=8, p_loss=0.01, seed=4), (2,))):
        hp, sts = _pool_states(dev, gossip, sim, kills, 150)
        for i, st in enumerate(sts):
            held[f"{name} #{i}"] = hold_detector(hp, st, f"{name} #{i}")
    for name, hp in (("main", p), ("chaos", dataclasses.replace(p, chaos=True)),
                     ("no LHA", dataclasses.replace(p, awareness_max=0))):
        st = _random_detector_state(dev, hp, at_kill, seed=len(held))
        held[f"random 1M {name}"] = hold_detector(hp, st, f"random 1M {name}")
    # a lossy pool at U = 64 (the 64-bit slot words), after the random
    # states, whose seeds count the holds before them
    hp, sts = _pool_states(dev, GossipConfig.lan(), SimConfig(
        n_nodes=4096, rumor_slots=64, p_loss=0.05, seed=5), (7, 9, 11), 150)
    for i, st in enumerate(sts):
        name = f"lan 4096x64 #{i}"
        held[name] = hold_detector(hp, st, name)
    totals = {k: sum(h[k] for h in held.values()) for k in (
        "converted", "dense_dead", "dense_originated", "overflow", "refuted",
        "dead_refuted", "refuted_twice", "freed", "committed",
        "stale_map_entries")}
    log(f"K9-K12 held bit-equal on {len(held)} states in "
        f"{time.perf_counter() - t0:.1f} s; totals {json.dumps(totals)}")
    for name, h in held.items():
        log(f"  {name}: {json.dumps(h)}")
    for k, v in totals.items():
        require(v > 0, f"no K9-K12 hold exercised {k}")
    require(held["correlated overflow"]["overflow"] > 0,
            "the correlated overflow state seeded no bulk member")
    require(any(h["evicted"] and h["stale_map_entries"]
                for h in held.values()),
            "no hold ran K10-K12 behind maps an eviction left stale")
    require(all(h["overflow"] == 0 for h in held.values() if h["chaos"]),
            "a chaos hold seeded the bulk channel")
    in_place = {name: no_expiry_allocation(hp, st, name) for name, hp, st in (
        ("main mid", p, states["mid"][1]),
        ("main first convert", p, events["convert"]),
        ("main first refute", p, events["refute"]),
        ("main first free", p, events["free"]),
        ("correlated overflow", cp, overflow))}
    captured = capture_expire(p, events["free"])

    timed = time_detector(p, states["mid"][1])
    # K12 where it refutes and where it frees: the main path's first
    # probe ticks with each event
    k12 = ("refutation", "expire")
    at_event = {"refuting": time_detector(p, events["refute"], only=k12),
                "freeing": time_detector(p, events["free"], only=k12)}
    require(at_event["refuting"]["refutation"]["refuted"] > 0
            and at_event["freeing"]["expire"]["freed"] > 0,
            f"the timed event states refuted "
            f"{at_event['refuting']['refutation']['refuted']} and freed "
            f"{at_event['freeing']['expire']['freed']} slots")
    launches = main["all_launches"]
    entries = []
    for name, (_, src, replaces) in DETECTOR_ENTRIES.items():
        t = timed[name]
        count = launches[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"consul_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": count, "max_abs_err": 0.0,
            "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "library_device_ms": t.get("library_device_ms"),
            "library_call_ms": t.get("library_call_ms"),
            "shape": [p.n_nodes, p.rumor_slots]})
        for event, at in at_event.items():
            if name in at:
                entries[-1][event] = {k: at[name][k] for k in (
                    "ms", "call_ms", "bound_ms", "refuted", "freed")
                    if k in at[name]}
    return entries, {"held": held, "totals": totals, "timed": timed,
                     "timed_at_events": at_event, "in_place": in_place,
                     "expire_graph_capture": captured}


# ---------------------------------------------------------------------------
# phase 13: the Vivaldi ring observation (K13) and the bulk channel (K14)
# ---------------------------------------------------------------------------

VIVALDI_FIELDS = ("coords", "height", "error", "adj_window", "adjustment")
# K13 against its twin: every leaf within this many ulp.  Its elementwise
# steps are explicitly rounded in the twin's order, and its two reductions
# (the squared norm over D = 8, the window sum over W = 20) follow torch's
# CUDA inner-reduction order at these widths (shuffle offsets bw/2 .. 1,
# as torch 2.11 on an NVIDIA H100 80GB HBM3 reduces them), so the bound is
# 0: bit-equal.
K13_ULP_BOUND = 0
# K14's float leaves against its twin: max|kernel - twin| <= BULK_RTOL *
# max|twin| (the two float sums are summed in the kernel's own order; an
# ulp of `removed` is an absolute error on every heard count)
BULK_RTOL = 1e-5
# K13's tiled form (the serf pool's D = 8, W = 20; other widths run
# vivaldi_ring_kernel)
K13_KERNELS = ("vivaldi_tile_kernel",)
K14_KERNELS = ("bulk_kernel",)
# bulk.cu's kStamps (kResults * 2048): the phase stamps of its instrumented
# build, and its phases: each pass until its slowest block, each barrier
# with the totals every block reads after it
K14_STAMPS = 5 * 2048
K14_PHASES = ("count", "barrier1", "supply", "barrier2", "advance", "barrier3",
              "commit")
BULK_FLOATS = ("bulk_heard", "bulk_cov")
BULK_BOOLS = ("bulk_member", "committed_dead")


def _probe_obs(params, s) -> tuple:
    """(s, obs): the serf state at the first probe tick from s on, and
    that tick's probe observations."""
    while True:
        _, obs = swim.step_with_obs(params.swim, s.swim.clone())
        if obs is not None:
            return s, obs
        s = serf.step(params, s)


def _colocated(c, shift) -> torch.Tensor:
    """Rows whose ring peer sits at their coordinates (the twin's test)."""
    return ~(vivaldi._norm(c.coords - rolls.pull(c.coords, shift)) > 1.0e-9)


def hold_ring(vp, c, shift, rtt_ms, acked, what: str,
              all_colocated: bool = False) -> dict:
    """K13 against observe_ring_plain on one observation, every leaf
    within K13_ULP_BOUND ulp.  The twin's colocated rows take their spring
    directions from prng.normal's [N, D] draw of the same key, and K13
    draws them inside itself: with `all_colocated` (a fresh pool's first
    probe tick, every coordinate 0) every acked row's new coordinates are
    its draw times a force over its norm, so their 0-ulp hold on every row
    that moved holds the fused draws to prng.normal's.  K13 runs on a
    clone of c, whose window and adjustment it must write in place; the
    peak allocation across the call stays below an [N, W] block (its
    fresh outputs are the [N, D] coordinates and the [N] height and error;
    in a pool so small that those, rounded up to the allocator's 512-byte
    granules, reach an [N, W] block, it stays within them)."""
    x = c.clone()
    grown = {}
    got = _peak_growth(grown, "K13", lambda: vivaldi.observe_ring(
        vp, x, shift, rtt_ms, acked))
    ref = vivaldi.observe_ring_plain(vp, c, shift, rtt_ms, acked)
    for f in vivaldi.RING_INPLACE:
        require(getattr(got, f).data_ptr() == getattr(x, f).data_ptr(),
                f"K13 {what}: {f} is not the input's tensor (in place)")
    window_bytes = c.adj_window.numel() * 4
    fresh = sum(-(-t.numel() * 4 // 512) * 512
                for t in (got.coords, got.height, got.error))
    require(grown["K13"] < window_bytes or grown["K13"] <= fresh,
            f"K13 {what}: allocated {grown['K13']} bytes, an [N, W] block is "
            f"{window_bytes} (its fresh outputs {fresh})")
    require(got.adj_index == ref.adj_index == c.adj_index + 1,
            f"K13 {what}: adj_index {got.adj_index}")
    ulps = {f: _ulps(getattr(got, f), getattr(ref, f)) for f in VIVALDI_FIELDS}
    require(max(ulps.values()) <= K13_ULP_BOUND,
            f"K13 {what}: {ulps} ulp from its twin (bound {K13_ULP_BOUND})")
    colocated = _colocated(c, shift)
    n = int(colocated.sum())
    moved = int(((got.coords != c.coords).any(1) & colocated).sum())
    if all_colocated:
        require(n == c.coords.shape[0], f"K13 {what}: {n} rows colocated")
        require(ulps["coords"] == 0 and moved > 0,
                f"K13 {what}: the drawn directions moved {moved} rows, "
                f"{ulps['coords']} ulp from prng.normal's")
    return {"adj_index": c.adj_index, "ulps": ulps, "colocated": n,
            "colocated_moved": moved, "acked": int(acked.sum()),
            "peak_growth_bytes": grown["K13"], "fresh_bytes": fresh,
            "window_bytes": window_bytes,
            "max_abs_err": max(float((getattr(got, f) - getattr(ref, f))
                                     .abs().max()) for f in VIVALDI_FIELDS)}


def _random_ring(dev, seed: int, n: int = N, d: int = 8, w: int = 20,
                 adj_index: int = 47):
    """Random K13 inputs: coords of tens of ms with 1% of the rows
    colocated with their ring peer, heights, errors and a window as a run
    leaves them, RTTs with zeros (floored), 80% acked, a wrapping column."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    shift = 1 + int(rnd(1) * (n - 1))
    coords = torch.randn(n, d, generator=gen, device=dev) * 0.02
    rows = (rnd(n) < 0.01).nonzero().flatten()
    coords[(rows + shift) % n] = coords[rows]
    c = vivaldi.VivaldiState(
        coords=coords, height=rnd(n) * 1e-3 + 1e-5,
        error=rnd(n) * 1.4 + 0.05,
        adj_window=torch.randn(n, w, generator=gen, device=dev) * 1e-4,
        adj_index=adj_index, adjustment=torch.zeros(n, device=dev))
    rtt_ms = torch.where(rnd(n) < 0.05, 0.0, rnd(n) * 50)
    return (c, torch.tensor(shift, dtype=torch.int32, device=dev), rtt_ms,
            rnd(n) < 0.8)


def _bulk_tick(params, s) -> tuple:
    """(the state the tick from s hands the bulk step, None when the
    channel is idle; the state after the tick)."""
    seen = []
    real = swim._bulk_step
    # K14 updates the state it is handed in place: keep a copy
    swim._bulk_step = lambda p, st: (seen.append(st.clone()), real(p, st))[1]
    try:
        nxt = swim.step(params, s.clone())
    finally:
        swim._bulk_step = real
    return (seen[0] if seen else None), nxt


def _near_commit_bar(ref) -> int:
    """Members of the twin's output whose coverage lies within 2 ulp of
    the 0.995 bar (where a sum's last ulp can flip a commit)."""
    bar = torch.tensor(0.995, dtype=torch.float32, device=ref.bulk_cov.device)
    d = (ref.bulk_cov.view(torch.int32) - bar.view(torch.int32)).abs()
    return int((d <= 2).sum())


def hold_bulk(params, s, what: str) -> dict:
    """K14 against _bulk_step_plain on s, each launch on a clone of s
    (after a warm launch): the bool leaves equal, the float leaves within
    BULK_RTOL of scale, a second launch bit-equal to the first, the state
    returned the clone itself with every leaf its own tensor (in place),
    no allocation."""
    swim._bulk_step(params, s.clone())
    x, y = s.clone(), s.clone()
    grown = {}
    got = _peak_growth(grown, "K14", lambda: swim._bulk_step(params, x))
    again = swim._bulk_step(params, y)
    ref = swim._bulk_step_plain(params, s)
    require(got is x, f"K14 {what}: returned a new state")
    require(grown["K14"] == 0, f"K14 {what}: allocated {grown['K14']} bytes")
    for f in BULK_BOOLS:
        diff = int((getattr(got, f) != getattr(ref, f)).sum())
        require(diff == 0, f"K14 {what}: {f} differs from its twin at {diff} "
                f"nodes ({_near_commit_bar(ref)} covers within 2 ulp of "
                f"0.995; tick {s.tick})")
        require(torch.equal(getattr(got, f), getattr(again, f)),
                f"K14 {what}: two launches disagree on {f}")
    errs, ulps = {}, {}
    for f in BULK_FLOATS:
        a, b = getattr(got, f), getattr(ref, f)
        errs[f] = float((a - b).abs().max())
        ulps[f] = _ulps(a, b)
        scale = float(b.abs().max())
        require(errs[f] <= BULK_RTOL * max(scale, 1e-30),
                f"K14 {what}: {f} {errs[f]} from its twin at scale {scale}")
        require(torch.equal(a.view(torch.int32), getattr(again, f)
                            .view(torch.int32)),
                f"K14 {what}: two launches disagree on {f}")
    for f in swim.TENSOR_FIELDS:
        if f not in BULK_FLOATS + BULK_BOOLS:
            _same(getattr(got, f), getattr(s, f), f"{what} {f}", "K14")
    v = int(s.bulk_member.sum())
    return {"tick": s.tick, "chaos": params.chaos, "members": v,
            "commits": int((ref.committed_dead & ~s.committed_dead).sum()),
            "heard_over_v": int((s.bulk_heard > max(v, 1)).sum()),
            "ulps": ulps, "max_abs_err": max(errs.values()),
            "near_bar": _near_commit_bar(ref),
            "peak_growth_bytes": grown["K14"]}


def capture_bulk(params, s, what: str) -> dict:
    """K14 (one cooperative launch) captured in a CUDA graph on a clone of
    s and replayed: the replay's leaves bit-equal to an uncaptured launch
    on another clone."""
    swim._bulk_step(params, s.clone())    # its scratch is made before capture
    x, y = s.clone(), s.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        swim._bulk_step(params, x)
    graph.replay()
    swim._bulk_step(params, y)
    torch.cuda.synchronize()
    _state(x, y, "K14", f"{what} graph replay")
    log(f"K14 captured in a CUDA graph and replayed at tick {s.tick} "
        f"({what}): bit-equal to an uncaptured launch")
    return {"tick": s.tick, "members": int(s.bulk_member.sum())}


def _random_bulk(dev, base, seed: int, members: float = 0.01,
                 heard_over: float = 1.0, chaos: bool = False):
    """Random K14 inputs of base's shape: `members` of the nodes in the
    channel (mostly down), heard counts up to heard_over * V, coverage
    with a third of the members within 0.005 under the commit bar, the
    nemesis build's groups and rates."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = base.up.shape[0]
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    bm = rnd(n) < members
    v = max(int(bm.sum()), 1)
    cov = torch.where(rnd(n) < 0.33, 0.99 + 0.0049 * rnd(n), rnd(n))
    s = base.replace(
        up=(rnd(n) < 0.99) & ~(bm & (rnd(n) < 0.9)),
        member=rnd(n) < 0.995, committed_dead=rnd(n) < 0.001,
        bulk_member=bm, bulk_heard=rnd(n) * v * heard_over,
        bulk_cov=torch.where(bm, cov, 0.0), bulk_live=True)
    if chaos:
        s = s.replace(chaos_grp=(rnd(n) < 0.25).to(torch.int16),
                      chaos_ok=torch.where(rnd(n) < 0.1, 0.55, 1.0))
    return s


def _ring_bytes(c, ref, n_colocated: int) -> tuple:
    """K13's least bytes given the twin's result `ref` (inputs read once,
    the coordinates, height, error and adjustment written once, whole;
    the window in place: the 32-byte sectors whose values change, by
    _written) and its operations: the normal draws of the colocated rows
    at K1's SASS count per element."""
    n, d = c.coords.shape
    w = c.adj_window.shape[1]
    reads = 4 * n * d + 4 * 3 * n + n + 4 * n * w
    writes = 4 * n * d + 4 * 3 * n + _written((c.adj_window, ref.adj_window))
    ops = n_colocated * d * SASS_PER_ELEMENT["normal"]
    return reads + writes, ops


def _bulk_bytes(params, s, out) -> tuple:
    """K14's least bytes on s, given its result `out`: on an empty channel
    bulk_member alone; else bulk_member, up, member and bulk_heard read
    once, whole (the nemesis build's groups and rates too), bulk_cov only
    in the sectors of members (cov' is 0 elsewhere), committed_dead not at
    all (an OR with done); the four outputs written in place (only the
    32-byte sectors that change, by _written).  And the same with fresh
    copies: six leaves read and four written whole, 22 bytes a node."""
    n = s.up.shape[0]
    if not bool(s.bulk_member.any()):
        return n, 12 * n + 10 * n
    chaos = 6 * n if params.chaos else 0
    least = 7 * n + _sector_bytes(s.bulk_member, 4) + chaos \
        + _written(*((getattr(s, f), getattr(out, f))
                     for f in BULK_FLOATS + BULK_BOOLS))
    return least, 12 * n + chaos + 10 * n


def time_ring(vp, c, shift, rtt_ms, acked) -> dict:
    """K13 timed at one observation: device ms (torch.profiler, L2
    evicted), the CUDA-event time with dispatch hidden, the wrapper call
    and the twin (dispatch included), the bound.  Each kernel call gets
    a clone of c (it writes the window in place), made outside the
    timed window."""
    call = lambda x: vivaldi.observe_ring(vp, x, shift, rtt_ms, acked)  # noqa: E731
    n_col = int(_colocated(c, shift).sum())
    plain = lambda: vivaldi.observe_ring_plain(  # noqa: E731
        vp, c, shift, rtt_ms, acked)
    b, ops = _ring_bytes(c, plain(), n_col)
    by_bytes = b / HBM_BYTES_PER_S * 1000.0
    by_ops = ops / INT32_OPS_PER_S * 1000.0
    t = {"ms": device_ms(call, K13_KERNELS, make=c.clone)[K13_KERNELS[0]],
         "event_ms": kernel_ms(call, make=c.clone),
         "call_ms": median_ms(call, make=c.clone),
         "plain_ms": median_ms(plain, reps=5),
         "bound_ms": max(by_bytes, by_ops),
         "bound_by": "operations" if by_ops > by_bytes else "bytes",
         "bound_bytes": b, "bound_ops": ops, "colocated": n_col}
    t["share"] = t["bound_ms"] / t["ms"]
    return t


def k14_phase_ms(params, s, reps: int = 10) -> dict:
    """Median ms of each phase of K14 on clones of s, from its instrumented
    build's %globaltimer stamps (None past the count on an empty
    channel)."""
    with _instrumented("bulk.cu", "BULK_PHASE_TIMES", "bulk_step"):
        return _phase_ms("bulk_step", K14_STAMPS, K14_PHASES,
                         lambda x: swim._bulk_step(params, x), s.clone, reps)


def time_bulk(params, s) -> dict:
    """K14 timed at one state, each call on a clone of s made outside the
    timed window (it updates the state in place): device ms
    (torch.profiler, L2 evicted), the CUDA-event time with dispatch
    hidden, the wrapper call and the twin (dispatch included), the bound,
    and its phases from the instrumented build."""
    call = lambda x: swim._bulk_step(params, x)  # noqa: E731
    b, b_copy = _bulk_bytes(params, s, call(s.clone()))
    t = {"ms": device_ms(call, K14_KERNELS, make=s.clone)[K14_KERNELS[0]],
         "event_ms": kernel_ms(call, make=s.clone),
         "call_ms": median_ms(call, make=s.clone),
         "plain_ms": median_ms(lambda: swim._bulk_step_plain(params, s),
                               reps=5),
         "bound_ms": b / HBM_BYTES_PER_S * 1000.0, "bound_bytes": b,
         "bound_with_copy_ms": b_copy / HBM_BYTES_PER_S * 1000.0,
         "bound_with_copy_bytes": b_copy, "members": int(s.bulk_member.sum()),
         "phase_ms": k14_phase_ms(params, s)}
    t["share"] = t["bound_ms"] / t["ms"]
    return t


def vivaldi_bulk_phase(dev, main: dict, states: dict,
                       k14_launches: int) -> tuple:
    """Phase 13: K13 and K14 against their twins on the card, then timed.
    K13's holds: the main path's first probe tick from init_state (every
    row colocated: the fused draws held through the coordinates), at
    the kill, mid-convergence and its end, random 1M states, random 100k
    states at other widths (D = 3, W = 7; D = 16, W = 32), a 15-node pool
    (fewer rows than a tile) and a ragged last tile (N = 1,000,129).
    K14's:
    the correlated run's overflow tick (the bulk step's input on the tick
    whose dense expiry seeds the channel, and that tick's starting state,
    whose channel is empty), mid-drain, its first committing tick after
    that and the drain's end, and random 1M states in the main and chaos
    builds (a revive clamp, an empty channel); its graph replay and
    kernels a call.  Returns (the kernels-line entries, the record)."""
    params = main["params"]
    vp = params.vivaldi
    t0 = time.perf_counter()
    ring = {}
    fresh = serf.init_state(params, device=dev)
    _, kill_state, _ = bench.prepare(device=dev)
    timing_obs = None
    for name, st in (("first probe tick", fresh), ("at_kill", kill_state),
                     ("mid", states["serf mid"][1]),
                     ("final", states["serf final"][1])):
        st, obs = _probe_obs(params, st)
        ring[f"main {name}"] = hold_ring(
            vp, st.coords, obs.shift, obs.rtt_ms, obs.acked, f"main {name}",
            all_colocated=name == "first probe tick")
        if name == "mid":
            timing_obs = (st.coords, obs.shift, obs.rtt_ms, obs.acked)
        if name == "first probe tick":
            colocated_obs = (st.coords, obs.shift, obs.rtt_ms, obs.acked)
    for seed, adj in ((1, 47), (2, 0), (3, 999)):
        c, shift, rtt_ms, acked = _random_ring(dev, seed, adj_index=adj)
        ring[f"random 1M #{seed}"] = hold_ring(vp, c, shift, rtt_ms, acked,
                                               f"random 1M #{seed}")
    # other widths take K13's plain form, which reads them from its
    # arguments; pools of fewer rows than a tile (the WAN pool's 15) and a
    # ragged last tile take the tiled form
    for seed, n, d, w in ((3, 100_000, 3, 7), (16, 100_000, 16, 32),
                          (15, 15, 8, 20), (129, 1_000_129, 8, 20)):
        name = f"random {n} D={d} W={w}"
        wp = vivaldi.VivaldiParams(n_nodes=n, dims=d, adjustment_window=w,
                                   seed=7)
        ring[name] = hold_ring(wp, *_random_ring(dev, seed, n, d, w), name)
    log(f"K13 held on {len(ring)} states in {time.perf_counter() - t0:.1f} s")
    for name, h in ring.items():
        log(f"  {name}: {json.dumps(h)}")

    t0 = time.perf_counter()
    bulk = {}
    # the probe tick whose dense expiry seeds the channel runs its first
    # bulk step; the state it starts from has an empty channel
    cp, before = _correlated_overflow_state(dev)
    bulk["overflow tick's input (empty)"] = hold_bulk(cp, before,
                                                      "empty channel")
    inp, _ = _bulk_tick(cp, before)
    require(inp is not None, "the overflow tick ran no bulk step")
    bulk["overflow tick"] = hold_bulk(cp, inp, "overflow tick")
    near_bar = states["correlated near_bar"][1]
    inp, s = _bulk_tick(cp, near_bar)
    require(inp is not None, "mid-drain ran no bulk step")
    bulk["mid-drain"] = hold_bulk(cp, inp, "mid-drain")
    for _ in range(4096):
        inp, nxt = _bulk_tick(cp, s)
        if inp is not None and bool((inp.bulk_member & ~nxt.bulk_member).any()):
            break
        s = nxt
    require(inp is not None, "no committing bulk tick after mid-drain")
    bulk["first committing tick"] = hold_bulk(cp, inp, "first committing tick")
    # the state profile_tick times the bulk pass at
    timed_state = correlated.mid_drain(cp, dev)
    bulk["mid-drain (coverage 0.5)"] = hold_bulk(cp, timed_state,
                                                 "mid-drain (coverage 0.5)")
    inp, _ = _bulk_tick(cp, states["correlated drain_end"][1])
    require(inp is not None, "the drain's end ran no bulk step")
    bulk["drain end"] = hold_bulk(cp, inp, "drain end")
    chaos_p = dataclasses.replace(cp, chaos=True)
    for name, bp, kw in (
            ("random 1M", cp, {}),
            ("random 1M commits", cp, dict(members=0.05)),
            ("random 1M revive clamp", cp, dict(heard_over=1.5)),
            ("random 1M empty", cp, dict(members=0.0)),
            ("random 1M chaos", chaos_p, dict(chaos=True)),
            ("random 1M chaos revive clamp", chaos_p,
             dict(chaos=True, heard_over=1.5))):
        rs = _random_bulk(dev, near_bar, seed=len(bulk), **kw)
        bulk[name] = hold_bulk(bp, rs, name)
    log(f"K14 held on {len(bulk)} states in {time.perf_counter() - t0:.1f} s")
    for name, h in bulk.items():
        log(f"  {name}: {json.dumps(h)}")
    require(bulk["first committing tick"]["commits"] > 0,
            "the committing tick's hold committed nothing")
    require(bulk["overflow tick's input (empty)"]["members"] == 0
            and bulk["random 1M empty"]["members"] == 0,
            "no hold had an empty channel")
    require(any(h["heard_over_v"] for h in bulk.values()),
            "no hold clamped a heard count above V")
    require(any(h["chaos"] and h["commits"] for h in bulk.values()),
            "no chaos hold committed")
    captured = {"mid-drain": capture_bulk(cp, timed_state, "mid-drain"),
                "empty": capture_bulk(cp, before, "empty channel")}
    # one device kernel a call: the clone a call takes is a copy, not a
    # kernel, and K1 draws nothing for it
    k1_0 = kernels.LAUNCHES["threefry_draws"]
    per_call = profile_tick.kernels_of(lambda: swim._bulk_step(
        cp, timed_state.clone()))
    log(f"K14 device kernels a call: {per_call}")
    require(list(per_call) == [k for k in per_call if K14_KERNELS[0] in k]
            and sum(per_call.values()) == 1,
            f"K14 ran {per_call}, want one {K14_KERNELS[0]}")
    require(kernels.LAUNCHES["threefry_draws"] == k1_0,
            "a K14 call launched K1")

    timed = {"vivaldi_ring": time_ring(vp, *timing_obs),
             "vivaldi_ring all colocated": time_ring(vp, *colocated_obs),
             "bulk_step": time_bulk(cp, timed_state),
             "bulk_step empty": time_bulk(cp, before),
             "bulk_step chaos": time_bulk(chaos_p, _random_bulk(
                 dev, near_bar, seed=99, chaos=True))}
    for name, t in timed.items():
        log(f"{name} timed: " + json.dumps(t))
    t13, t14 = timed["vivaldi_ring"], timed["bulk_step"]
    entries = [
        {"name": "vivaldi_ring", "route": "cuda",
         "source": "consul_tpu_torch/kernels/csrc/vivaldi.cu",
         "replaces": "consul_tpu/models/vivaldi.py:162",
         "launches": main["all_launches"]["vivaldi_ring"],
         "max_abs_err": max(h["max_abs_err"] for h in ring.values()),
         "ms": t13["ms"], "call_ms": t13["call_ms"],
         "plain_ms": t13["plain_ms"], "bound_ms": t13["bound_ms"],
         "bound_by": t13["bound_by"], "library_ms": None,
         "max_ulp": max(max(h["ulps"].values()) for h in ring.values()),
         "ms_all_colocated": timed["vivaldi_ring all colocated"]["ms"],
         "shape": list(timing_obs[0].coords.shape)
         + [timing_obs[0].adj_window.shape[1]]},
        {"name": "bulk_step", "route": "cuda",
         "source": "consul_tpu_torch/kernels/csrc/bulk.cu",
         "replaces": "consul_tpu/models/swim.py:1184",
         "launches": k14_launches,
         "launches_path": "correlated (phase 7)",
         "max_abs_err": max(h["max_abs_err"] for h in bulk.values()),
         "ms": t14["ms"], "call_ms": t14["call_ms"],
         "plain_ms": t14["plain_ms"], "bound_ms": t14["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "bound_with_copy_ms": t14["bound_with_copy_ms"],
         "phase_ms": t14["phase_ms"],
         "empty_ms": timed["bulk_step empty"]["ms"],
         "empty_bound_ms": timed["bulk_step empty"]["bound_ms"],
         "chaos_ms": timed["bulk_step chaos"]["ms"],
         "chaos_bound_ms": timed["bulk_step chaos"]["bound_ms"],
         "shape": [N, cp.gossip_nodes]}]
    return entries, {"ring_held": ring, "bulk_held": bulk, "timed": timed,
                     "bulk_graph_capture": captured,
                     "bulk_kernels_per_call": per_call}


# ---------------------------------------------------------------------------
# phase 14: the program contracts of every registered entry point
# ---------------------------------------------------------------------------

def contracts_phase(dev) -> dict:
    """Phase 14: kernel_lint's check of the registry
    (parallel/kernel_audit.py) at full width against the committed cuda
    records of KERNELBUDGET_r01.json: every entry's contracts hold,
    registry parity holds over every launch site, and every hand-written
    kernel is launched by some entry's measured calls.  Logs one line an
    entry."""
    t0 = time.perf_counter()
    r = kernel_lint.check(dev)
    for name, rec in r["records"].items():
        forms = {form: {"kernels": f["device_kernels"],
                        "launches": sum(v for k, v in f["launches"].items()
                                        if "." not in k),
                        "syncs": f["syncs"], "flag_syncs": f["flag_syncs"],
                        "peak_MB": f["peak_bytes"] / 1e6,
                        "allocations": f["allocations"],
                        "in_place": f["inplace"]["leaves"]}
                 for form, f in rec["forms"].items()}
        log(f"contract {name}: bytes/slot {rec['bytes_per_slot']}, page "
            f"{rec['page_elements']}, " + json.dumps(forms))
    summary = {k: v for k, v in r.items() if k not in ("records", "verdicts")}
    summary["seconds"] = time.perf_counter() - t0
    log("kernel_lint: " + json.dumps(summary))
    require(r["coverage"] is not None and r["coverage"]["ok"],
            f"hand-written kernels no entry launched: {r['coverage']}")
    require(r["ok"], f"kernel_lint --check failed: violations "
            f"{r['violations']}, refused {r['refused']}, parity "
            f"{r['parity']}")
    return {**summary, "records": r["records"]}


# ---------------------------------------------------------------------------
# phase 15: the node-sharded pool, K2-K4 over block tables
# ---------------------------------------------------------------------------

# 2^20 nodes: L = N / B stays a multiple of K4's 4,096-node tiles for B
# up to 256 (the ragged case is held at N = 1,000,000 below)
SHARD_N = 1 << 20
SHARD_BLOCKS = 4
SHARD_SCALING = (1, 2, 4)
SHARD_SIM = SimConfig(n_nodes=SHARD_N, rumor_slots=32, alloc_cap=8,
                      p_loss=0.01, seed=7, shard_blocks=SHARD_BLOCKS)
SHARD_VICTIM = 123_457
SHARD_FIRE_TICK = 31      # a gossip tick (LAN probe period 5)


def _shard_mesh(devs):
    from consul_tpu_torch.parallel import mesh as meshlib
    return meshlib.make_mesh(devs)


def _gossip_tick_pool(dev, chaos_build: bool = False):
    """The unsharded port at full width to a gossip tick with rumors in
    flight: 20 ticks, a kill, ticks to SHARD_FIRE_TICK, then (serf) a user
    event fired.  (params, state): serf params and ClusterState, or with
    `chaos_build` swim params (chaos=True) and a SwimState whose pool is
    cut into two partition groups with a degraded tenth."""
    import dataclasses as dc
    if chaos_build:
        p = swim.make_params(GossipConfig.lan(),
                             dc.replace(SHARD_SIM, chaos=True))
        s = swim.run(p, swim.init_state(p, device=dev), 20)[0]
        s = swim.kill(s, SHARD_VICTIM)
        gen = torch.Generator(device=dev)
        gen.manual_seed(17)
        r = torch.rand(SHARD_N, generator=gen, device=dev)
        s = s.replace(chaos_grp=(r < 0.25).to(torch.int16),
                      chaos_ok=torch.where(r > 0.9, 0.6, 1.0).to(
                          torch.float32))
        s = swim.run(p, s, SHARD_FIRE_TICK - s.tick)[0]
        return p, s
    p = serf.make_params(GossipConfig.lan(), SHARD_SIM)
    s, _ = serf.run(p, serf.init_state(p, device=dev), 20)
    s = s.replace(swim=swim.kill(s.swim, SHARD_VICTIM))
    s, _ = serf.run(p, s, SHARD_FIRE_TICK - s.swim.tick, SHARD_VICTIM)
    s = serf.fire_event(p, s, 5, 1)
    return p, s


def _flat(x):
    """A sharded leaf (or state) back on one device, for comparing only."""
    from consul_tpu_torch.parallel import mesh as meshlib
    return meshlib.unshard_state(x)


def _same_state(a, b, what: str) -> None:
    """Two states (serf or swim, unsharded) bit-equal in every leaf."""
    if isinstance(a, serf.ClusterState):
        diff = _leaves_equal(a, b)
    else:
        diff = [f for f in swim.TENSOR_FIELDS
                if not torch.equal(getattr(a, f).reshape(-1).view(torch.uint8),
                                   getattr(b, f).reshape(-1).view(torch.uint8))]
        if not diff:
            diff = a.tick == b.tick and a.bulk_live == b.bulk_live or ["tick"]
    require(diff is True, f"{what}: leaves differ: {diff}")


def _blocks_equal(a, b, what: str) -> None:
    from consul_tpu_torch.parallel.mesh import Blocks
    require((a is None) == (b is None), f"{what}: presence")
    if a is None:
        return
    if isinstance(a, Blocks):
        for i, (x, y) in enumerate(zip(a.parts, b.parts)):
            _same(x, y, f"{what} block {i}", "sharded")
    else:
        _same(a, b, what, "sharded")


def _sharded_gossip_call(sw_params, s, chaos_mode: bool = False) -> dict:
    """The swim caller's K2 arguments at a sharded state."""
    return dict(
        offs=swim.tick_offsets(prng.tick_key(sw_params.seed, s.tick, 2),
                               sw_params.n_nodes, sw_params.gossip_nodes,
                               s.up),
        know=s.know, sends_left=s.sends_left, sender_ok=s.up,
        receiver_ok=swim._both(s.up, s.member), slot_active=s.r_active,
        retransmit_limit=sw_params.retransmit_limit,
        p_loss=sw_params.p_loss, key=prng.tick_key(sw_params.seed, s.tick, 5),
        learn_tick=s.learn_tick, tick16=swim._t16(s.tick), ctr=s.ctr,
        want_newly=False,
        group=s.chaos_grp if chaos_mode else None,
        node_ok=s.chaos_ok if chaos_mode else None)


def _sharded_events_call(params, ev, up, member) -> dict:
    p = params.events
    return dict(
        offs=swim.tick_offsets(prng.tick_key(p.seed, ev.tick, 3), p.n_nodes,
                               p.gossip_nodes, ev.know),
        know=ev.know, sends_left=ev.sends_left, sender_ok=up,
        receiver_ok=swim._both(up, member), slot_active=ev.e_active,
        retransmit_limit=min(p.retransmit_limit, 127), p_loss=p.p_loss,
        key=prng.tick_key(p.seed, ev.tick, 6))


def _hold_sharded_gossip(call: dict, what: str) -> dict:
    got = gossip.disseminate_blocks_kernel(**call)
    want = gossip.disseminate_blocks_plain(**call)
    for name in ("know", "sends_left", "newly", "learn_tick"):
        _blocks_equal(getattr(got, name), getattr(want, name),
                      f"gossip {what} {name}")
    if want.ctr is not None:
        _same(got.ctr.home, want.ctr.home, f"gossip {what} ctr", "sharded")
    for name in ("delivered", "served", "lost"):
        a, b = float(getattr(got, name)), float(getattr(want, name))
        require(a == b, f"sharded gossip {what}: {name} {a} != plain {b}")
    return {"delivered": float(want.delivered), "served": float(want.served),
            "lost": float(want.lost)}


def _random_sharded_call(dev, m, n: int, slots: int, seed: int) -> dict:
    """_random_gossip_call's rows cut into the mesh's blocks, with a chaos
    partition and rate."""
    from consul_tpu_torch.parallel import mesh as meshlib
    call = _random_gossip_call(dev, n, slots, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    r = torch.rand(n, generator=gen, device=dev)
    call["group"] = (r < 0.3).to(torch.int16)
    call["node_ok"] = torch.where(r > 0.8, 0.7, 1.0).to(torch.float32)
    out = {}
    for k, v in call.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == n:
            out[k] = meshlib.shard_state(v, m, n)
        elif isinstance(v, torch.Tensor):
            out[k] = meshlib.Replicated.of(v, m.distinct)
        else:
            out[k] = v
    return out


def _sharded_oracles(dev, params, state, m):
    """Two oracles over one pool: the unsharded port and the sharded one
    (GossipOracle(mesh=m)), both holding `state` (N - 1,000 provisioned)
    and a delta checkpoint with 5,000 members moved to another status."""
    from consul_tpu_torch.parallel import mesh as meshlib
    sim = dataclasses.replace(SHARD_SIM, n_initial=SHARD_N - 1000)
    prov = torch.arange(SHARD_N, device=dev) < SHARD_N - 1000
    ref = GossipOracle(sim=sim, device=dev)
    ref._state = state.clone()
    ref._provisioned = prov.cpu().numpy()
    ref._prov_dev = prov.clone()
    ref._status_ckpt = _prev(serf.status_vector(params, state), 5000, 9)
    sh = GossipOracle(sim=sim, mesh=m)
    sh._state = meshlib.shard_state(state.clone(), m)
    sh._provisioned = prov.cpu().numpy()
    sh._prov_dev = meshlib.shard_state(prov, m, SHARD_N)
    sh._status_ckpt = meshlib.shard_state(ref._status_ckpt, m, SHARD_N)
    return ref, sh


def _oracle_reads(o) -> dict:
    """Every read the sharded oracle answers, each as its host value."""
    names = [f"node{i}" for i in range(0, SHARD_N - 1000, 997)][:1000]
    return {
        "members": o.members(limit=100),
        "members_offset": o.members(limit=64, offset=SHARD_N // 2 - 7),
        "summary": o.members_summary(),
        "status": [o.status(f"node{i}") for i in (0, SHARD_VICTIM,
                                                  SHARD_N // 2,
                                                  SHARD_N - 1001)],
        "delta": o.members_delta(256),
        "delta_again": o.members_delta(256),
        "coordinate": [o.coordinate(f"node{i}") for i in (3, SHARD_N - 1001)],
        "sort_by_rtt": o.sort_by_rtt("node11", names),
        "shard_metrics": o.shard_metrics(),
        "believed_down": o.believed_down_fraction(f"node{SHARD_VICTIM}"),
    }


def _random_k4_state(dev, sw, seed: int):
    """The state's rumor table and committed leaves drawn at random (dead
    subjects in and outside [0, N), a tenth committed dead, left or not a
    member) for K4's holds."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    n, u = sw.member.shape[0], sw.r_active.shape[0]
    subj = (rnd(u) * 2.2 * n - 0.6 * n).to(torch.int32)
    return sw.replace(
        member=rnd(n) > 0.05, committed_dead=rnd(n) < 0.05,
        committed_left=rnd(n) < 0.03,
        r_active=rnd(u) < 0.8, r_kind=(rnd(u) * 4).to(torch.int8),
        r_subject=subj, incarnation=(rnd(n) * 9).to(torch.int32))


def _hold_sharded_reads(params, sw, m, prov, seed: int, what: str) -> int:
    """K4 (scan, combine, emit, page) and K3 over the blocks of sw against
    the per-block twins and the unsharded kernels, bit-equal.  Returns the
    deltas held."""
    from consul_tpu_torch.parallel import mesh as meshlib
    n = sw.member.shape[0]
    sh = meshlib.shard_state(sw, m)
    bprov = meshlib.shard_state(prov, m, n)
    st = swim.status_vector(params, sw)
    _same(_flat(swim.status_vector(params, sh)), st, f"{what} status",
          "sharded K4")
    _same(_flat(swim.status_vector_blocks_plain(params, sh)), st,
          f"{what} status twin", "sharded K4")
    counts = swim.membership_counts(params, sw, prov)
    _same(swim.membership_counts(params, sh, bprov), counts, f"{what} counts",
          "sharded K4")
    _same(swim.membership_counts_blocks_plain(params, sh, bprov), counts,
          f"{what} counts twin", "sharded K4")
    gen = torch.Generator(device=sw.member.device)
    gen.manual_seed(seed)
    ids = torch.cat([torch.randint(0, n, (4093,), generator=gen,
                                   device=sw.member.device).to(torch.int32),
                     torch.tensor([-1, n + 7, -n - 3, n - 1, 0],
                                  dtype=torch.int32,
                                  device=sw.member.device)])
    want = swim.membership_page(params, sw, ids)
    for got in (swim.membership_page(params, sh, ids),
                swim.membership_page_blocks_plain(params, sh, ids)):
        for a, b, f in zip(got, want, ("status", "incarnation", "up")):
            _same(a, b, f"{what} page {f}", "sharded K4")
    held = 0
    for pname, prev in (("first", torch.full_like(st, -1)),
                        ("100 flips", _prev(st, 100, seed)),
                        ("50000 flips", _prev(st, 50_000, seed + 1))):
        bprev = meshlib.shard_state(prev, m, n)
        for k in (8, 256, 4096):
            want = swim.membership_delta(params, sw, prev, prov, k)
            for got in (swim.membership_delta(params, sh, bprev, bprov, k),
                        swim.membership_delta_blocks_plain(params, sh, bprev,
                                                           bprov, k)):
                _same(_flat(got[0]), want[0], f"{what} {pname} k={k} status",
                      "sharded K4")
                for a, b, f in zip(got[1:], want[1:],
                                   ("n_changed", "idx", "state")):
                    _same(a, b, f"{what} {pname} k={k} {f}", "sharded K4")
            held += 1
    return held


def _hold_sharded_monitor(params, sw, m, subjects, what: str) -> None:
    from consul_tpu_torch.parallel import mesh as meshlib
    sh = meshlib.shard_state(sw, m)
    for subject in subjects:
        want = swim.believed_down_fraction(params, sw, subject)
        for got in (swim.believed_down_fraction(params, sh, subject),
                    swim.believed_down_fraction_blocks_plain(params, sh,
                                                             subject)):
            _same(got.reshape(1), want.reshape(1),
                  f"{what} subject {subject}", "sharded K3")


def _shard_tick_ms(params, state, blocks: int, dev) -> dict:
    """One gossip tick (serf.step, a user event in flight) on the pool
    node-sharded into `blocks` blocks on one card (unsharded with
    blocks=0): the call's ms between CUDA events, host dispatch included
    (median_ms), the window with the dispatch hidden behind a 2 ms sleep
    (kernel_ms: still host-bound when the dispatch outlasts the sleep),
    and the device ms of its kernels alone (device_total_ms)."""
    from consul_tpu_torch.parallel import mesh as meshlib
    sh = meshlib.shard_state(state, _shard_mesh([dev] * blocks)) \
        if blocks else state
    return {"call_ms": median_ms(lambda: serf.step(params, sh)),
            "window_ms": kernel_ms(lambda: serf.step(params, sh)),
            "device_ms": device_total_ms(lambda: serf.step(params, sh))}


def _bytes_ms(b: float) -> float:
    return b / HBM_BYTES_PER_S * 1000.0


def _sharded_entry(name, source, replaces, launches, t, bound, plain_ms,
                   library_ms=None, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0,
            "ms": t, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms, **extra}


def sharded_phase(dev) -> tuple:
    """Phase 15: the pool node-sharded into SHARD_BLOCKS blocks (one card,
    or one block a card where there are that many) at N = 2^20, U = 32:
    gossip ticks with a rumor and a user event in flight bit-equal to the
    unsharded port's, the probe tick they reach bit-equal too, a tick
    with the bulk channel live refused with nothing launched, K2
    (pack, exchange, chaos mode), K3 and K4 over block tables bit-equal to
    their per-block twins, the sharded oracle's reads equal to the
    unsharded oracle's with O(k) bytes moved, the gather law, and the
    times.  Returns (the kernels-line entries, the record)."""
    from consul_tpu_torch.parallel import mesh as meshlib
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(SHARD_BLOCKS)] \
        if cards >= SHARD_BLOCKS else [dev] * SHARD_BLOCKS
    m = _shard_mesh(devs)
    params, pool = _gossip_tick_pool(dev)
    period = params.swim.probe_period_ticks
    ticks = period - pool.swim.tick % period
    require(ticks >= 2 and bool(pool.swim.r_active.any())
            and bool((pool.swim.sends_left > 0).any())
            and any(pool.events.active_host),
            f"phase 15: no rumor or event in flight at tick {pool.swim.tick}")
    record = {"mesh": [str(d) for d in m.devices], "n_nodes": SHARD_N,
              "blocks": SHARD_BLOCKS, "start_tick": pool.swim.tick,
              "ticks": ticks}

    # the main path: the sharded pool's gossip ticks with the monitor
    ref = pool.clone()
    sh = meshlib.shard_state(pool.clone(), m)
    meshlib.assert_node_sharded(sh.swim.know, SHARD_BLOCKS, "knowledge")
    torch.cuda.synchronize()
    kernels.reset_launches()
    with kernel_audit.RowCensus(m.devices) as census:
        sh, fr_sh = serf.run(params, sh, ticks, SHARD_VICTIM)
        for d in m.distinct:
            torch.cuda.synchronize(d)
    launches = dict(kernels.LAUNCHES)
    ref, fr_ref = serf.run(params, ref, ticks, SHARD_VICTIM)
    _same(fr_sh, fr_ref, "monitor fractions", "sharded tick")
    _same_state(_flat(sh), ref, "sharded gossip ticks")
    law = kernel_audit.gather_law(census.rows, SHARD_N)
    record.update(path_launches={k: v for k, v in launches.items() if v},
                  gather=law, peak_bytes=census.peaks,
                  fractions=fr_ref.cpu().tolist())
    log(f"sharded path: {ticks} gossip ticks from tick {pool.swim.tick} at "
        f"B={SHARD_BLOCKS} on {record['mesh']}: every leaf bit-equal to the "
        f"unsharded port's; launches {record['path_launches']}; gather law "
        f"{law}; per-device peak bytes {census.peaks}")
    require(law["ok"], f"gather law broken: {law}")
    b = SHARD_BLOCKS
    for name, want in (("gossip_pack_blocks", 2 * b * ticks),
                       ("gossip_exchange_blocks", 2 * b * ticks),
                       ("gossip_combine", 2 * ticks),
                       ("believed_down_blocks", b * ticks),
                       ("believed_down_combine", ticks)):
        require(launches[name] == want, f"sharded path: {name} launched "
                f"{launches[name]} times, want {want}")
    for name in kernels.MAIN_PATH[1:] + kernels.MEMBERS:
        require(launches[name] == 0, f"sharded path launched the unsharded "
                f"{name}")

    # the probe tick the gossip ticks reached runs (phase 16 holds it at
    # length); a tick with the bulk channel live refuses before anything
    # runs (ROADMAP queue A item 3b-ii)
    require(sh.swim.tick % period == 0, f"phase 15 ended at tick "
            f"{sh.swim.tick}, not a probe tick")
    probe_sh = serf.step(params, sh.clone())
    _same_state(_flat(probe_sh), serf.step(params, ref.clone()),
                "sharded probe tick")
    record["probe_tick"] = f"tick {sh.swim.tick} bit-equal"
    live = sh.replace(swim=sh.swim.replace(bulk_live=True))
    before = dict(kernels.LAUNCHES)
    with kernel_audit.RowCensus(m.devices) as census:
        try:
            serf.step(params, live)
            refused, kept = False, None
        except meshlib.BulkChannelLive as e:
            refused, kept = str(e), e.state.swim
    require(refused and "3b-ii" in refused and kept is live.swim
            and dict(kernels.LAUNCHES) == before and not census.rows,
            f"a sharded tick with the bulk channel live ran: {refused}")
    record["bulk_tick_refused"] = refused
    log(f"sharded probe tick at {sh.swim.tick} bit-equal; a tick with the "
        f"bulk channel live refused, nothing launched or made: {refused}")

    # the chaos build's gossip ticks, sharded (K2's chaos mode)
    cp, cpool = _gossip_tick_pool(dev, chaos_build=True)
    cref, csh = cpool.clone(), meshlib.shard_state(cpool.clone(), m)
    cticks = period - cpool.tick % period
    kernels.reset_launches()
    for _ in range(cticks):
        csh = swim.step(cp, csh)
    chaos_launches = dict(kernels.LAUNCHES)
    for _ in range(cticks):
        cref = swim.step(cp, cref)
    _same_state(_flat(csh), cref, "sharded chaos gossip ticks")
    require(chaos_launches["gossip_exchange_chaos_blocks"] == b * cticks,
            f"chaos path: {chaos_launches}")
    record["chaos_launches"] = {k: v for k, v in chaos_launches.items() if v}
    log(f"sharded chaos path: {cticks} ticks bit-equal; launches "
        f"{record['chaos_launches']}")

    # K2, K3, K4 against their per-block twins on the card
    held = {"swim": _hold_sharded_gossip(
        _sharded_gossip_call(params.swim, meshlib.shard_state(pool.swim, m)),
        "swim")}
    spool = meshlib.shard_state(pool, m)
    held["events"] = _hold_sharded_gossip(
        _sharded_events_call(params, spool.events, spool.swim.up,
                             spool.swim.member), "events")
    held["chaos"] = _hold_sharded_gossip(_sharded_gossip_call(
        cp, meshlib.shard_state(cpool, m), chaos_mode=True), "chaos")
    for n, slots, blocks in ((SHARD_N, 16, 8), (SHARD_N, 64, 2),
                             (100_000, 40, 4), (1024, 8, 8)):
        rm = _shard_mesh([dev] * blocks)
        held[f"random {n}x{slots} B={blocks}"] = _hold_sharded_gossip(
            _random_sharded_call(dev, rm, n, slots, 7 + slots), "random")
    log(f"sharded K2 bit-equal to its per-block twin: {held}")
    _hold_sharded_monitor(params.swim, pool.swim, m,
                          (SHARD_VICTIM, 0, SHARD_N - 1, 3 * SHARD_N // 4 + 5),
                          "pool")
    rnd = _random_swim_state(dev, pool.swim, SHARD_VICTIM, SHARD_N, 32)
    _hold_sharded_monitor(params.swim, rnd, m, (SHARD_VICTIM, SHARD_N - 2),
                          "random")
    prov = torch.arange(SHARD_N, device=dev) < SHARD_N - 1000
    deltas = _hold_sharded_reads(params.swim, pool.swim, m, prov, 3, "pool")
    deltas += _hold_sharded_reads(params.swim,
                                  _random_k4_state(dev, pool.swim, 4), m,
                                  prov, 5, "random")
    # N = 1,000,000 in 4 blocks: L = 250,000, a ragged last tile a block
    rp = swim.make_params(GossipConfig.lan(), SimConfig(n_nodes=N,
                                                        rumor_slots=32))
    rag = _random_k4_state(dev, swim.init_state(rp, device=dev), 6)
    deltas += _hold_sharded_reads(rp, rag, _shard_mesh([dev] * 4),
                                  torch.ones(N, dtype=torch.bool, device=dev),
                                  7, "ragged 1,000,000")
    log(f"sharded K3 and K4 bit-equal to their per-block twins and the "
        f"unsharded kernels ({deltas} deltas)")

    # the sharded oracle's reads: equal to the unsharded oracle's, O(k)
    o_ref, o_sh = _sharded_oracles(dev, params, pool, m)
    want = _oracle_reads(o_ref)
    import consul_tpu_torch.oracle as oracle_mod
    moved = []
    real = oracle_mod._to_host

    def spy(x):
        a = real(x)
        moved.append(a.nbytes)
        return a

    oracle_mod._to_host = spy
    try:
        kernels.reset_launches()
        with kernel_audit.RowCensus(m.devices) as census:
            got = _oracle_reads(o_sh)
        read_launches = dict(kernels.LAUNCHES)
    finally:
        oracle_mod._to_host = real
    require(got == want, "sharded oracle reads differ: " + json.dumps(
        {k: [got[k], want[k]] for k in want if got[k] != want[k]},
        default=str)[:2000])
    law_reads = kernel_audit.gather_law(census.rows, SHARD_N)
    require(law_reads["ok"], f"gather law broken by the reads: {law_reads}")
    require(sum(moved) < SHARD_N, f"reads moved {sum(moved)} B")
    for name in ("members_scan_blocks", "members_combine",
                 "members_emit_blocks", "members_page_blocks",
                 "believed_down_blocks", "believed_down_combine"):
        require(read_launches[name] > 0, f"oracle reads never launched "
                f"{name}")
    record.update(oracle_bytes=sum(moved), oracle_transfers=len(moved),
                  read_launches={k: v for k, v in read_launches.items() if v},
                  reads_gather=law_reads, reads_peak_bytes=census.peaks)
    log(f"sharded oracle: {len(want)} reads equal to the unsharded oracle's, "
        f"{sum(moved)} B in {len(moved)} transfers; launches "
        f"{record['read_launches']}; gather law {law_reads}")

    # peer access: the same ticks over cards
    if cards >= 2:
        pm = _shard_mesh([torch.device("cuda", i)
                          for i in range(min(cards, SHARD_BLOCKS))])
        kernels.enable_peer_access(pm.devices)
        psh = meshlib.shard_state(pool.clone(), pm)
        psh, pfr = serf.run(params, psh, ticks, SHARD_VICTIM)
        _same(pfr.to(dev), fr_ref, "monitor over cards", "sharded tick")
        _same_state(_flat(psh), ref, "sharded gossip ticks over cards")
        record["peer_access"] = f"held over {len(pm.devices)} cards"
    else:
        record["peer_access"] = "not run: 1 card"
    log(json.dumps({"peer_access": record["peer_access"]}))

    # times: the tick at B = 1, 2, 4 on one card against the unsharded
    # port's, then each sharded kernel and its twin
    tick = {"unsharded": _shard_tick_ms(params, pool, 0, dev)}
    for blocks in SHARD_SCALING:
        tick[f"B={blocks}"] = _shard_tick_ms(params, pool, blocks, dev)
    record["tick_ms"] = tick
    log(f"sharded gossip tick (serf.step, event in flight) on one card: "
        + json.dumps(tick))
    spool = meshlib.shard_state(pool, _shard_mesh([dev] * SHARD_BLOCKS))
    sw = spool.swim
    scall = _sharded_gossip_call(params.swim, sw)
    ccall = _sharded_gossip_call(cp, meshlib.shard_state(
        cpool, _shard_mesh([dev] * SHARD_BLOCKS)), chaos_mode=True)
    k2 = device_ms(lambda: gossip.disseminate_blocks_kernel(**scall),
                   ("gossip_pack_kernel", "gossip_exchange_kernel",
                    "gossip_combine_kernel"))
    k2c = device_ms(lambda: gossip.disseminate_blocks_kernel(**ccall),
                    ("gossip_exchange_kernel",))
    k2_plain = median_ms(lambda: gossip.disseminate_blocks_plain(**scall),
                         reps=5)
    k2c_plain = median_ms(lambda: gossip.disseminate_blocks_plain(**ccall),
                          reps=5)
    ucall = _swim_gossip_call(params.swim, pool.swim)
    gb = _gossip_bounds(ucall)
    cb = _gossip_bounds(_chaos_gossip_call(cp, cpool))
    out1 = torch.empty(1, dtype=torch.float32, device=dev)
    k3 = device_ms(lambda: swim.believed_down_fraction(
        params.swim, sw, SHARD_VICTIM, out=out1),
        ("believed_down_kernel", "believed_down_combine_kernel"))
    k3_plain = median_ms(lambda: swim.believed_down_fraction_blocks_plain(
        params.swim, sw, SHARD_VICTIM), reps=5)
    k3_bound = _monitor_bound(params.swim, pool.swim, SHARD_VICTIM)[0]
    bprov = meshlib.shard_state(prov, _shard_mesh([dev] * SHARD_BLOCKS),
                                SHARD_N)
    st = swim.status_vector(params.swim, pool.swim)
    prev = _prev(st, 100, 11)
    bprev = meshlib.shard_state(prev, _shard_mesh([dev] * SHARD_BLOCKS),
                                SHARD_N)
    page_ids = torch.arange(SHARD_N // 2, SHARD_N // 2 + 128,
                            dtype=torch.int32, device=dev)
    k4 = device_ms(lambda: swim.membership_delta(params.swim, sw, bprev,
                                                 bprov, 256),
                   ("members_scan_kernel", "members_combine_kernel",
                    "members_emit_kernel"))
    k4p = device_ms(lambda: swim.membership_page(params.swim, sw, page_ids),
                    ("members_page_kernel",))
    delta_plain = median_ms(lambda: swim.membership_delta_blocks_plain(
        params.swim, sw, bprev, bprov, 256), reps=5)
    page_plain = median_ms(lambda: swim.membership_page_blocks_plain(
        params.swim, sw, page_ids), reps=5)
    counts_plain = median_ms(lambda: swim.membership_counts_blocks_plain(
        params.swim, sw, bprov), reps=5)
    changed = (st != prev) & prov
    tiles_read = int(sum(
        int((changed[i * kernels.MEMBER_TILE:(i + 1) * kernels.MEMBER_TILE]
             .any())) for i in range(kernels.member_tiles(SHARD_N))))
    u = params.swim.rumor_slots
    g = params.swim.gossip_nodes
    bb = SHARD_BLOCKS
    pk = page_ids.shape[0]
    lib_scan = library_times(lambda: torch.bincount(
        st[prov].to(torch.int64), minlength=3))["library_ms"]
    path = launches
    reads = read_launches
    gsrc = "consul_tpu_torch/kernels/csrc/gossip.cu"
    msrc = "consul_tpu_torch/kernels/csrc/monitor.cu"
    ksrc = "consul_tpu_torch/kernels/csrc/members.cu"
    shape = [SHARD_N, u, bb]
    entries = [
        _sharded_entry("gossip_pack_blocks", gsrc, "consul_tpu/ops/rolls.py:53",
                       path["gossip_pack_blocks"],
                       k2["gossip_pack_kernel"] * bb, gb["pack"][0], k2_plain,
                       ms_per_block=k2["gossip_pack_kernel"], shape=shape),
        _sharded_entry("gossip_exchange_blocks", gsrc,
                       "consul_tpu/ops/rolls.py:53",
                       path["gossip_exchange_blocks"],
                       k2["gossip_exchange_kernel"] * bb, gb["exchange"][0],
                       k2_plain, ms_per_block=k2["gossip_exchange_kernel"],
                       shape=shape),
        _sharded_entry("gossip_exchange_chaos_blocks", gsrc,
                       "consul_tpu/ops/gossip.py:82",
                       chaos_launches["gossip_exchange_chaos_blocks"],
                       k2c["gossip_exchange_kernel"] * bb, cb["exchange"][0],
                       k2c_plain, ms_per_block=k2c["gossip_exchange_kernel"],
                       launches_path="phase 15 chaos ticks", shape=shape),
        _sharded_entry("gossip_combine", gsrc, "consul_tpu/ops/gossip.py:122",
                       path["gossip_combine"], k2["gossip_combine_kernel"],
                       _bytes_ms(24 * bb + 12 + 8 * swim.CTR_N), k2_plain),
        _sharded_entry("believed_down_blocks", msrc,
                       "consul_tpu/models/swim.py:533",
                       path["believed_down_blocks"],
                       k3["believed_down_kernel"] * bb, k3_bound, k3_plain,
                       ms_per_block=k3["believed_down_kernel"], shape=shape),
        _sharded_entry("believed_down_combine", msrc,
                       "consul_tpu/models/swim.py:556",
                       path["believed_down_combine"],
                       k3["believed_down_combine_kernel"],
                       _bytes_ms(16 * bb + 5 + 4), k3_plain),
        _sharded_entry("members_scan_blocks", ksrc,
                       "consul_tpu/models/swim.py:1502",
                       reads["members_scan_blocks"],
                       k4["members_scan_kernel"] * bb,
                       _bytes_ms(6 * SHARD_N + 6 * u * bb
                                 + 4 * kernels.member_tiles(SHARD_N)
                                 + 20 * bb), counts_plain, lib_scan,
                       ms_per_block=k4["members_scan_kernel"], shape=shape),
        _sharded_entry("members_combine", ksrc,
                       "consul_tpu/models/swim.py:1507",
                       reads["members_combine"], k4["members_combine_kernel"],
                       _bytes_ms(20 * bb + 20), counts_plain),
        _sharded_entry("members_emit_blocks", ksrc,
                       "consul_tpu/models/swim.py:569",
                       reads["members_emit_blocks"],
                       k4["members_emit_kernel"] * bb,
                       _bytes_ms(4 * kernels.member_tiles(SHARD_N) + 20 * bb
                                 + 3 * kernels.MEMBER_TILE * tiles_read
                                 + 5 * 256), delta_plain,
                       ms_per_block=k4["members_emit_kernel"], shape=shape),
        _sharded_entry("members_page_blocks", ksrc,
                       "consul_tpu/models/swim.py:1517",
                       reads["members_page_blocks"],
                       k4p["members_page_kernel"],
                       _bytes_ms(pk * (4 + 3 + 4 + 1) + 6 * u + pk * 6),
                       page_plain, shape=shape + [pk]),
    ]
    for e in entries:
        log(f"sharded {e['name']}: " + json.dumps(e))
    record["seconds"] = time.perf_counter() - t0
    return entries, record


# ------------------------------------------------------------------ phase 16

PROBE_SHARD_BLOCKS = 4
# the block forms on the kernels line: (its source, the JAX function it
# replaces, its blocks' kernel as the profiler names it, its combine's
# LAUNCHES name and profiler name, or None)
BLOCK_ENTRIES = {
    "threefry_draws_blocks": ("threefry.cu", "consul_tpu/models/swim.py:725",
                              "threefry_draws_kernel", None),
    "subject_maps_blocks": ("maps.cu", "consul_tpu/models/swim.py:392",
                            "subject_maps_kernel", None),
    "map_add_blocks": ("maps.cu", "consul_tpu/models/swim.py:414",
                       "map_add_kernel", None),
    "maps_convert_blocks": ("maps.cu", "consul_tpu/models/swim.py:422",
                            "maps_convert_kernel", None),
    "probe_round_blocks": ("probe.cu", "consul_tpu/models/swim.py:698",
                           "probe_round_kernel<false>",
                           ("probe_combine", "probe_combine_kernel")),
    "originate_blocks": ("originate.cu", "consul_tpu/models/swim.py:605",
                         "originate_kernel<false>",
                         ("originate_combine", "originate_kernel<true>")),
    "suspicion_expiry_blocks": ("expiry.cu", "consul_tpu/models/swim.py:900",
                                "expiry_kernel<false>",
                                ("suspicion_expiry_combine",
                                 "expiry_kernel<true>")),
    "dense_expiry_blocks": ("dense.cu", "consul_tpu/models/swim.py:965",
                            "dense_pre_kernel<false>",
                            ("dense_expiry_combine", "dense_combine_kernel")),
    "dense_expiry_post_blocks": ("dense.cu", "consul_tpu/models/swim.py:1030",
                                 "dense_post_kernel<false>", None),
    "refutation_blocks": ("refute.cu", "consul_tpu/models/swim.py:1086",
                          "refutation_kernel<false>",
                          ("refutation_combine", "refutation_kernel<true>")),
    "expire_blocks": ("refute.cu", "consul_tpu/models/swim.py:1267",
                      "expire_kernel<false>",
                      ("expire_combine", "expire_kernel<true>")),
    "vivaldi_ring_blocks": ("vivaldi.cu", "consul_tpu/models/vivaldi.py:162",
                            "vivaldi_tile_kernel", None),
}
# a combine's partial words a block (what its bound reads)
COMBINE_PART = {"probe_combine": kernels.PROBE_PART,
                "originate_combine": kernels.ORIGINATE_PART,
                "suspicion_expiry_combine": 1,
                "dense_expiry_combine": kernels.DENSE_COUNTS,
                "refutation_combine": 0,
                "expire_combine": kernels.EXPIRE_PART}


def device_call_ms(fn, make, reps: int = 10) -> float:
    """Mean device ms of one call of fn on make()'s input: every device
    record of the call summed (the L2-evicting read and the inputs, made
    before the capture, left out)."""
    flush = profile_tick._flush()
    if not _FLUSH_KEYS:
        flush.max()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flush.max()
            torch.cuda.synchronize()
        _FLUSH_KEYS.update(profile_tick._device_times(prof))
    for _ in range(2):
        fn(make())
    inputs = [make() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            flush.max()
            fn(x)
        torch.cuda.synchronize()
    us = [t for k, (t, _) in profile_tick._device_times(prof).items()
          if k not in _FLUSH_KEYS]
    return sum(us) / reps / 1000.0


def _to_probe_tick(params, st):
    """A clone of swim state st stepped (unsharded) to its next probe
    tick."""
    return profile_tick.next_probe_tick(lambda x: swim.step(params, x),
                                        params.probe_period_ticks, st)


def _held3(unsharded, kernel, twin, what: str) -> None:
    """A pass's outputs three ways: the unsharded kernel's, the block
    form's and the per-block twin's (states, maps, Blocks or tensors),
    every leaf bit-equal."""
    from consul_tpu_torch.parallel.mesh import Blocks, Replicated

    def flat(x):
        if isinstance(x, Replicated):
            return x.home
        return _flat(x) if isinstance(x, Blocks) else x

    if isinstance(unsharded, (swim.SwimState, vivaldi.VivaldiState)):
        for other, who in ((kernel, "block form"), (twin, "twin")):
            o = _flat(other)
            fields = swim.TENSOR_FIELDS if isinstance(o, swim.SwimState) \
                else VIVALDI_FIELDS
            for f in fields:
                _same(getattr(o, f), getattr(unsharded, f),
                      f"{what} {f} ({who})", "sharded")
        return
    if isinstance(unsharded, (tuple, list)):
        for i, (a, b, c) in enumerate(zip(unsharded, kernel, twin)):
            _held3(a, b, c, f"{what}[{i}]")
        return
    _same(flat(kernel), unsharded, f"{what} (block form)", "sharded")
    _same(flat(twin), unsharded, f"{what} (twin)", "sharded")


def hold_block_passes(params, st, m, what: str, census=None) -> dict:
    """Every probe-tick pass at the probe-tick state st three ways (the
    unsharded kernels on clones, the block forms on the mesh m, the
    per-block twins on the card), each pass from the unsharded chain's
    input, held bit-equal: K9's build, K1's block draws, K7, K8, K9's
    map_add, K10, K9's maps_convert, K11 with K8, K12's refutation and
    expire.  Returns what the state exercised (converted, refuted and
    freed slots, eviction)."""
    from consul_tpu_torch.models import swim_blocks
    from consul_tpu_torch.parallel import mesh as meshlib
    P = params
    cm = census if census is not None else contextlib.nullcontext()

    def sh(x):
        return meshlib.shard_state(x.clone(), m)

    mu = swim._maps(P, st)
    x0 = sh(st)
    with cm:
        mk = swim_blocks.maps(P, x0)
    _held3(mu, mk, swim_blocks.maps_plain(P, sh(st)), f"{what} K9 build")
    du = swim._probe_inputs(P, st)
    with cm:
        dk = swim_blocks.probe_inputs(P, x0)
    want_draws = swim._probe_draws(P, st.tick)
    for name, d in want_draws.items():
        if d.shape[0] != P.n_nodes:
            _same(dk[name].home, du[name], f"{what} K1 {name}", "sharded")
            continue
        ell = dk[name].rows
        per = int(np.prod(d.shape[1:])) if len(d.shape) > 1 else 1
        twin = [prng.draw_plain([dataclasses.replace(
            d, shape=(ell,) + tuple(d.shape[1:]))], part.device,
            b * ell * per)[0] for b, part in enumerate(dk[name].parts)]
        _held3(du[name], dk[name], meshlib.Blocks(twin), f"{what} K1 {name}")
    a = swim._probe_pass(P, st.clone(), mu, du)
    x0 = sh(st)
    with cm:
        b = swim_blocks.probe_pass(P, x0, mk, dk)
    c = swim_blocks.probe_pass_plain(P, sh(st), mk, dk)
    _held3(a[:3], b[:3], c[:3], f"{what} K7")
    _held3((a[3].rtt_ms, a[3].acked), (b[3].rtt_ms, b[3].acked),
           (c[3].rtt_ms, c[3].acked), f"{what} K7 obs")
    s1 = a[0]
    x = s1.clone()
    a8 = swim._originate(P, x, a[1], swim.SUSPECT, x.incarnation, a[2])
    outs = []
    for fn in (swim_blocks.originate, swim_blocks.originate_plain):
        y = sh(s1)
        with (cm if fn is swim_blocks.originate else
              contextlib.nullcontext()):
            outs.append(fn(P, y, b[1], swim.SUSPECT, y.incarnation, b[2]))

    _held3(a8, *outs, f"{what} K8")
    evicting = _eviction(s1, a[1])[0]
    s2 = a8[0]
    mu2 = swim._map_add(profile_tick.copy_maps(mu)[0], *a8[1])
    x0 = mk[0].clone()
    with cm:
        mk2 = swim_blocks.map_add(x0, *outs[0][1])
    _held3(mu2, mk2, swim_blocks.map_add_plain(mk[0], *outs[0][1]),
           f"{what} K9 map_add")
    mu = (mu2, *mu[1:])
    mk = (mk2, *mk[1:])
    a10 = swim._suspicion_expiry(P, s2.clone())
    x0 = sh(s2)
    with cm:
        b10 = swim_blocks.suspicion_expiry(P, x0)
    _held3(a10, b10, swim_blocks.suspicion_expiry_plain(P, sh(s2)),
           f"{what} K10")
    s3, conv = a10
    mu3 = swim._maps_convert(profile_tick.copy_maps(mu), s3, conv)
    mkc = tuple(x.clone() for x in mk)
    x0 = sh(s3)
    with cm:
        mk3 = swim_blocks.maps_convert(mkc, x0, conv)
    _held3(mu3, mk3, swim_blocks.maps_convert_plain(mk, sh(s3), conv),
           f"{what} K9 maps_convert")
    a11 = swim._dense_suspicion_expiry(P, s3.clone(), a[3].shift,
                                       profile_tick.copy_maps(mu3))
    x0, mkd = sh(s3), tuple(x.clone() for x in mk3)
    with cm:
        b11 = swim_blocks.dense_expiry(P, x0, b[3].shift, mkd)
    _held3(a11, b11, swim_blocks.dense_expiry_plain(
        P, sh(s3), b[3].shift, tuple(x.clone() for x in mk3)), f"{what} K11")
    a12 = swim._refutation(P, a11.clone())
    x0 = sh(a11)
    with cm:
        b12 = swim_blocks.refutation(P, x0)
    _held3(a12, b12, swim_blocks.refutation_plain(P, sh(a11)),
           f"{what} K12 refutation")
    a13 = swim._expire(P, a12.clone())
    x0 = sh(a12)
    with cm:
        b13 = swim_blocks.expire(P, x0)
    _held3(a13, b13, swim_blocks.expire_plain(P, sh(a12)),
           f"{what} K12 expire")
    return {"converted": int(conv.sum()), "evicting": bool(evicting),
            "refuted": _refuting(a11, a12)[0],
            "freed": int((a12.r_active & ~a13.r_active).sum()),
            "tick": st.tick}


def hold_expire_frees(params, st, m, census=None) -> int:
    """K12's expire (and its refutation before it) three ways at a state
    whose first half of the slots are dead, left and alive rumors every
    live row knows, past their windows: the slots are freed and their
    beliefs committed.  Returns the slots freed."""
    from consul_tpu_torch.models import swim_blocks
    from consul_tpu_torch.parallel import mesh as meshlib
    u, dev = params.rumor_slots, st.device
    half = torch.arange(u, device=dev) < u // 2
    x = st.replace(r_active=half | st.r_active,
                   r_kind=torch.where(half, (torch.arange(
                       u, device=dev) % 3 * 2 % 4).to(torch.int8),
                       st.r_kind),
                   r_subject=torch.where(half, ((torch.arange(
                       u, device=dev) * 7919 + 3) % st.up.shape[0]).to(
                           torch.int32), st.r_subject),
                   r_start=torch.where(half, st.tick - 1000, st.r_start),
                   know=st.know | half[None, :])
    for name, fn in (("refutation", swim._refutation),
                     ("expire", swim._expire)):
        want = fn(params, x.clone())
        y = meshlib.shard_state(x.clone(), m)
        with (census if census is not None else contextlib.nullcontext()):
            got = getattr(swim_blocks, name)(params, y)
        _held3(want, got, getattr(swim_blocks, f"{name}_plain")(
            params, meshlib.shard_state(x.clone(), m)), f"freeing {name}")
        if name == "expire":
            freed = int((x.r_active & ~want.r_active).sum())
    require(freed > 0, "the freeing state freed no slot")
    return freed


def hold_ring_blocks(vp, c, shift, rtt_ms, acked, m, what: str) -> None:
    """K13's block form against its per-block twin and the unsharded
    kernel at one observation (the window written in place: clones)."""
    from consul_tpu_torch.parallel import mesh as meshlib
    n = c.coords.shape[0]
    want = vivaldi.observe_ring(vp, c.clone(), shift, rtt_ms, acked)
    sc = lambda: meshlib.shard_state(c.clone(), m, n)  # noqa: E731
    br = meshlib.shard_state(rtt_ms, m, n)
    ba = meshlib.shard_state(acked, m, n)
    _held3(want, vivaldi.observe_ring(vp, sc(), shift, br, ba),
           vivaldi.observe_ring_blocks_plain(vp, sc(), shift, br, ba),
           f"{what} K13")


def hold_sentinels(dev, blocks: int) -> None:
    """The index-0 sentinels on the card: a pool whose every block's row 0
    holds a value a masked lane's scatter into index 0 would change, with
    no rumor subject in block 0 (tests/test_torch_sharded_probe.py's
    state at N = 4096): expire's committed_inc, refutation's incarnation,
    map_add's and maps_convert's maps changed at global row 0 alone,
    block form, twin and unsharded kernel alike."""
    from consul_tpu_torch.models import swim_blocks
    from consul_tpu_torch.parallel import mesh as meshlib
    n, u = 4096, 16
    ell = n // blocks
    p = swim.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=n, rumor_slots=u, shard_blocks=blocks))
    s = swim.init_state(p, device=dev)
    firsts = torch.arange(0, n, ell, device=dev)
    inc = torch.zeros(n, dtype=torch.int32, device=dev)
    inc[firsts] = -5
    subj = torch.tensor([ell + 1 + k % (ell - 1) for k in range(u)],
                        dtype=torch.int32, device=dev)
    s = s.replace(committed_inc=inc.clone(), incarnation=inc.clone(),
                  r_active=torch.ones(u, dtype=torch.bool, device=dev),
                  r_kind=torch.tensor([swim.ALIVE] * (u // 2) + [swim.SUSPECT]
                                      * (u - u // 2), dtype=torch.int8,
                                      device=dev),
                  r_subject=subj, r_inc=torch.full((u,), 3, dtype=torch.int32,
                                                   device=dev),
                  r_start=torch.zeros(u, dtype=torch.int32, device=dev),
                  know=torch.ones((n, u), dtype=torch.bool, device=dev),
                  tick=10 ** 4)
    m = _shard_mesh([dev] * blocks)
    sh = lambda: meshlib.shard_state(s.clone(), m)  # noqa: E731
    a = swim._expire(p, s.clone())
    _held3(a, swim_blocks.expire(p, sh()), swim_blocks.expire_plain(p, sh()),
           "sentinel expire")
    require(int(a.committed_inc[0]) == 0
            and bool((a.committed_inc[firsts[1:]] == -5).all()),
            "sentinel expire: the masked lanes did not land on node 0 alone")
    a = swim._refutation(p, s.clone())
    _held3(a, swim_blocks.refutation(p, sh()),
           swim_blocks.refutation_plain(p, sh()), "sentinel refutation")
    require(int(a.incarnation[0]) == -1
            and bool((a.incarnation[firsts[1:]] == -5).all()),
            "sentinel refutation: the masked lanes did not land on node 0")
    mp = torch.full((n,), 3, dtype=torch.int32, device=dev)
    mp[firsts] = -7
    pairs = (torch.tensor([n - 1, 0], dtype=torch.int32, device=dev),
             torch.tensor([2, 5], dtype=torch.int32, device=dev),
             torch.tensor([True, False], device=dev))
    bm = lambda: meshlib.shard_state(mp.clone(), m, n)  # noqa: E731
    want = swim._map_add(mp.clone(), *pairs)
    _held3(want, swim_blocks.map_add(bm(), *pairs),
           swim_blocks.map_add_plain(bm(), *pairs), "sentinel map_add")
    require(int(want[0]) == -1 and bool((want[firsts[1:]] == -7).all()),
            "sentinel map_add: not at node 0 alone")
    conv = torch.zeros(u, dtype=torch.bool, device=dev)
    conv[u - 1] = True
    maps = lambda: (mp.clone(), mp.clone(), mp.clone(), mp.clone())  # noqa: E731
    bmaps = lambda: tuple(meshlib.shard_state(x, m, n) for x in maps())  # noqa: E731
    _held3(swim._maps_convert(tuple(torch.stack(maps())), s, conv),
           swim_blocks.maps_convert(bmaps(), sh(), conv),
           swim_blocks.maps_convert_plain(bmaps(), sh(), conv),
           "sentinel maps_convert")


def _peak_bytes(devs) -> dict:
    return {str(d): torch.cuda.max_memory_allocated(d) for d in devs}


def time_block_forms(params, vp, st, c, m) -> dict:
    """The block forms timed at the probe-tick state st (serf coords c) on
    the mesh m: each launch kind's device ms (device_ms: the blocks'
    kernel and the combine's, each by its own name) times its launches a
    call, the call (CUDA events, dispatch included), the per-block twin
    (K11's in its pre and post parts, one a launch), the per-device peak
    bytes of the call."""
    from consul_tpu_torch.models import swim_blocks
    from consul_tpu_torch.parallel import mesh as meshlib
    P = params
    n = P.n_nodes
    bb = m.size
    sh = meshlib.shard_state(st, m)
    mk = swim_blocks.maps(P, sh)
    dk = swim_blocks.probe_inputs(P, sh)
    s1k, wantk, rowsk, obsk = swim_blocks.probe_pass(P, sh.clone(), mk, dk)
    s2k, allock = swim_blocks.originate(P, s1k.clone(), wantk, swim.SUSPECT,
                                        s1k.incarnation, rowsk)
    s3k, convk = swim_blocks.suspicion_expiry(P, s2k.clone())
    mk3 = swim_blocks.maps_convert(tuple(x.clone() for x in mk), s3k, convk)
    s4k = swim_blocks.dense_expiry(P, s3k.clone(), obsk.shift,
                                   tuple(x.clone() for x in mk3))
    s5k = swim_blocks.refutation(P, s4k.clone())
    # the post launch's twin on the inputs the pre launch and K8 give it
    s3p, wantp, rowp, convp = swim_blocks.dense_pre_plain(
        P, s3k.clone(), obsk.shift, tuple(x.clone() for x in mk3))
    s3p, allocp = swim_blocks.originate(P, s3p, wantp, swim.DEAD,
                                        s3p.incarnation, rowp)
    cm = meshlib.shard_state(c, m, n)
    draws = list(swim._probe_draws(P, st.tick).values())
    cmaps = lambda: tuple(x.clone() for x in mk)  # noqa: E731
    cmaps3 = lambda: tuple(x.clone() for x in mk3)  # noqa: E731
    def draws_plain():
        ell, out = sh.up.rows, []
        for d in draws:
            if d.shape[0] != n:
                out.append(prng.draw_plain([d], st.device)[0])
                continue
            per = int(np.prod(d.shape[1:])) if len(d.shape) > 1 else 1
            out.append([prng.draw_plain([dataclasses.replace(
                d, shape=(ell,) + tuple(d.shape[1:]))], part.device,
                b * ell * per)[0] for b, part in enumerate(sh.up.parts)])
        return out

    calls = {
        "threefry_draws_blocks": (lambda _: prng.draw_blocks(draws, sh.up),
                                  lambda: None, draws_plain),
        "subject_maps_blocks": (lambda _: swim_blocks.maps(P, sh),
                                lambda: None,
                                lambda: swim_blocks.maps_plain(P, sh)),
        "map_add_blocks": (lambda x: swim_blocks.map_add(x, *allock),
                           lambda: mk[0].clone(),
                           lambda: swim_blocks.map_add_plain(mk[0],
                                                             *allock)),
        "maps_convert_blocks": (
            lambda x: swim_blocks.maps_convert(x, s3k, convk), cmaps,
            lambda: swim_blocks.maps_convert_plain(mk, s3k, convk)),
        "probe_round_blocks": (
            lambda x: swim_blocks.probe_pass(P, x, mk, dk), sh.clone,
            lambda: swim_blocks.probe_pass_plain(P, sh, mk, dk)),
        "originate_blocks": (
            lambda x: swim_blocks.originate(P, x, wantk, swim.SUSPECT,
                                            x.incarnation, rowsk),
            s1k.clone, lambda: swim_blocks.originate_plain(
                P, s1k, wantk, swim.SUSPECT, s1k.incarnation, rowsk)),
        "suspicion_expiry_blocks": (
            lambda x: swim_blocks.suspicion_expiry(P, x), s2k.clone,
            lambda: swim_blocks.suspicion_expiry_plain(P, s2k)),
        # K11's twin in its two parts, each timed against its launch
        "dense_expiry_blocks": (
            lambda x: swim_blocks.dense_expiry(P, x[0], obsk.shift, x[1]),
            lambda: (s3k.clone(), cmaps3()),
            lambda: swim_blocks.dense_pre_plain(P, s3k, obsk.shift,
                                                cmaps3())),
        "refutation_blocks": (lambda x: swim_blocks.refutation(P, x),
                              s4k.clone,
                              lambda: swim_blocks.refutation_plain(P, s4k)),
        "expire_blocks": (lambda x: swim_blocks.expire(P, x), s5k.clone,
                          lambda: swim_blocks.expire_plain(P, s5k)),
        "vivaldi_ring_blocks": (
            lambda x: vivaldi.observe_ring(vp, x, obsk.shift, obsk.rtt_ms,
                                           obsk.acked), cm.clone,
            lambda: vivaldi.observe_ring_blocks_plain(
                vp, cm, obsk.shift, obsk.rtt_ms, obsk.acked)),
    }
    out = {}
    for name, (fn, make, plain) in calls.items():
        kern, comb = BLOCK_ENTRIES[name][2], BLOCK_ENTRIES[name][3]
        names = [kern] + ([comb[1]] if comb else [])
        if name == "dense_expiry_blocks":
            names.append(BLOCK_ENTRIES["dense_expiry_post_blocks"][2])
        before = dict(kernels.LAUNCHES)
        for d in m.distinct:
            torch.cuda.reset_peak_memory_stats(d)
        fn(make())
        torch.cuda.synchronize()
        peaks = _peak_bytes(m.distinct)
        per_call = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        # each launch kind's mean by its name, times its launches a call
        # (a profile that drops a record leaves the means as they are)
        means = device_ms(fn, tuple(names), make=make)
        out[name] = {"launches_per_call": per_call,
                     "per_launch_ms": means,
                     "ms": means[kern] * per_call[name],
                     "combine_ms": means[comb[1]] * per_call[comb[0]]
                     if comb else None,
                     "call_ms": median_ms(fn, make=make),
                     "plain_ms": median_ms(plain, reps=5),
                     "peak_bytes": peaks}
        if name == "dense_expiry_blocks":
            post = BLOCK_ENTRIES["dense_expiry_post_blocks"][2]
            out["dense_expiry_post_blocks"] = dict(
                out[name], ms=means[post] * per_call["dense_expiry_post_blocks"],
                combine_ms=None, plain_ms=median_ms(
                    lambda: swim_blocks.dense_post_plain(
                        P, s3p, obsk.shift, wantp, convp, allocp), reps=5))
        log(f"{name} timed at tick {st.tick} on {bb} blocks: "
            + json.dumps(out[name]))
    return out


def _scaling_tick_ms(params, st, blocks: int, dev) -> dict:
    """One probe tick of the serf pool (serf.step and the monitor) node-
    sharded into `blocks` blocks on one card (unsharded with blocks=0):
    the call (CUDA events, dispatch included), its device work (every
    device record), each on a clone."""
    from consul_tpu_torch.parallel import mesh as meshlib
    s = meshlib.shard_state(st, _shard_mesh([dev] * blocks)) if blocks \
        else st
    out = torch.empty(1, dtype=torch.float32, device=dev)

    def tick(x):
        y = serf.step(params, x)
        swim.believed_down_fraction(params.swim, y.swim, bench.VICTIM,
                                    out=out)
        return y

    return {"call_ms": median_ms(tick, make=s.clone),
            "device_ms": device_call_ms(tick, s.clone)}


def sharded_probe_phase(dev, states: dict) -> tuple:
    """Phase 16: the node-sharded probe tick.  The main path sharded from
    init_state (bench.run_convergence at N = 1,000,000, U = 32, B = 4 on
    one card, or a block a card where there are four) held to the
    unsharded run (ticks, F1, false commits, every leaf of the final
    state, the bulk channel empty); the nemesis build's swim.run over two
    probe periods at N = 2^20 bit-equal; every pass's block form against
    its per-block twin and the unsharded kernel at replayed probe-tick
    states (phases 2-10's) and random ones that refute, free, evict and
    convert; K13's and K1's block forms; the index-0 sentinels; the
    gather law; the times.  Returns (the kernels-line entries, the
    record)."""
    from consul_tpu_torch.models import swim_blocks
    from consul_tpu_torch.parallel import mesh as meshlib
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    bb = PROBE_SHARD_BLOCKS
    devs = [torch.device("cuda", i) for i in range(bb)] if cards >= bb \
        else [dev] * bb
    m = _shard_mesh(devs)
    record = {"mesh": [str(d) for d in m.devices], "blocks": bb}

    # the main path, sharded from init_state, held to the unsharded run
    ref = bench.run_convergence(n_nodes=N, device=dev)
    bulk0 = swim.bulk_steps
    torch.cuda.synchronize()
    kernels.reset_launches()
    syncs0 = swim.host_syncs
    got = bench.run_convergence(n_nodes=N, mesh=m)
    for d in m.distinct:
        torch.cuda.synchronize(d)
    path = dict(kernels.LAUNCHES)
    flag_reads = swim.host_syncs - syncs0
    log(f"sharded main path (B={bb} on {record['mesh']}): converged="
        f"{got['converged']} ticks={got['ticks']} (unsharded {ref['ticks']}, "
        f"JAX {REFERENCE_TICKS}) f1={got['f1']} false_commits="
        f"{got['false_commits']} wall_s={got['wall']} (unsharded "
        f"{ref['wall']}) flag reads {flag_reads} in {got['state'].swim.tick}"
        f" ticks; launches {{k: v for k, v in path.items() if v}}".replace(
            "{k: v for k, v in path.items() if v}",
            json.dumps({k: v for k, v in path.items() if v})))
    require(got["converged"] and got["ticks"] == ref["ticks"]
            == REFERENCE_TICKS, f"sharded main path: {got['ticks']} ticks, "
            f"unsharded {ref['ticks']}")
    require(got["f1"] == 1.0 and got["false_commits"] == 0,
            f"sharded main path: f1 {got['f1']}, false commits "
            f"{got['false_commits']}")
    require(got["fracs"] == ref["fracs"], "sharded monitor fractions differ")
    require(got["sim_counters"] == ref["sim_counters"],
            "sharded metrics vector differs")
    require(got["host_syncs"] == ref["host_syncs"],
            f"host syncs {got['host_syncs']} != {ref['host_syncs']}")
    _same_state(_flat(got["state"]), ref["state"], "sharded main path")
    meshlib.assert_node_sharded(got["state"].swim.know, bb, "main path")
    require(swim.bulk_steps == bulk0 and not bool(
        swim_blocks._any(got["state"].swim.bulk_member)),
        "the sharded main path opened the bulk channel")
    period = ref["params"].swim.probe_period_ticks
    probe_ticks = -(-got["state"].swim.tick // period)
    require(flag_reads == probe_ticks, f"{flag_reads} flag reads in "
            f"{probe_ticks} probe ticks")
    for name, entry in BLOCK_ENTRIES.items():
        for launched in (name,) + ((entry[3][0],) if entry[3] else ()):
            require(path[launched] > 0, f"{launched} never launched on the "
                    f"sharded path")
    for name in kernels.PROBE + kernels.DETECTOR + ("vivaldi_ring",
                                                    "believed_down"):
        require(path[name] == 0, f"the sharded path launched the unsharded "
                f"{name}")
    record.update(main_path={
        "ticks": got["ticks"], "wall_s": got["wall"],
        "unsharded_wall_s": ref["wall"], "f1": got["f1"],
        "false_commits": got["false_commits"], "flag_reads": flag_reads,
        "probe_ticks": probe_ticks, "host_syncs": got["host_syncs"],
        "launches": {k: v for k, v in path.items() if v}})

    # the gather law over a 10-tick chunk crossing two probe ticks, and
    # the per-device peak bytes of it
    chunk_from = got["state"]
    for d in m.distinct:
        torch.cuda.reset_peak_memory_stats(d)
    with kernel_audit.RowCensus(m.devices) as census:
        chunk, _ = serf.run(ref["params"], chunk_from.clone(), 10,
                            bench.VICTIM)
        for d in m.distinct:
            torch.cuda.synchronize(d)
    law = kernel_audit.gather_law(census.rows, N)
    require(law["ok"], f"gather law broken by the sharded chunk: {law}")
    unchunk, _ = serf.run(ref["params"], ref["state"].clone(), 10,
                          bench.VICTIM)
    _same_state(_flat(chunk), unchunk, "sharded 10-tick chunk")
    record.update(chunk_gather=law, chunk_peak_bytes=census.peaks,
                  chunk_device_peak=_peak_bytes(m.distinct))
    log(f"sharded chunk: 10 ticks bit-equal; gather law {law}; per-device "
        f"peak bytes {census.peaks}")

    # the nemesis build over two probe periods at N = 2^20
    cp, cpool = _gossip_tick_pool(dev, chaos_build=True)
    cpool = _to_probe_tick(cp, cpool)
    cref, csh = cpool.clone(), meshlib.shard_state(cpool.clone(), m)
    kernels.reset_launches()
    with kernel_audit.RowCensus(m.devices) as ccensus:
        csh = swim.run(cp, csh, 2 * period)[0]
    claunch = dict(kernels.LAUNCHES)
    cref = swim.run(cp, cref, 2 * period)[0]
    _same_state(_flat(csh), cref, "sharded chaos build")
    claw = kernel_audit.gather_law(ccensus.rows, SHARD_N)
    require(claw["ok"], f"gather law broken by the chaos run: {claw}")
    require(claunch["probe_round_blocks"] == 2 * bb, f"chaos: {claunch}")
    record["chaos"] = {"ticks": 2 * period, "from_tick": cpool.tick,
                       "launches": {k: v for k, v in claunch.items() if v},
                       "gather": claw}
    log(f"sharded chaos build: {2 * period} ticks from {cpool.tick} "
        f"bit-equal; gather law {claw}")

    # every pass's block form against its twin and the unsharded kernel
    held = {}
    hcensus = kernel_audit.RowCensus(m.devices)
    for name, (hp, st) in states.items():
        if not isinstance(st, swim.SwimState) or st.up.shape[0] % bb \
                or st.up.shape[0] < 1024:
            continue
        held[name] = hold_block_passes(hp, _to_probe_tick(hp, st), m, name,
                                       census=hcensus)
    p0 = states["mid"][0]
    base = _to_probe_tick(p0, states["mid"][1])
    for seed in (21, 22):
        rnd = _to_probe_tick(p0, _random_detector_state(dev, p0, base, seed))
        held[f"random {seed}"] = hold_block_passes(
            p0, rnd.replace(tick=base.tick), m, f"random {seed}",
            census=hcensus)
    ev = base.clone()
    u = p0.rumor_slots
    ev = ev.replace(r_active=torch.ones(u, dtype=torch.bool, device=dev),
                    r_kind=(torch.arange(u, device=dev) % 4).to(torch.int8),
                    r_subject=(torch.arange(u, device=dev) * 997 + 11).to(
                        torch.int32),
                    know=torch.ones_like(ev.know))
    held["all slots covered"] = hold_block_passes(p0, ev, m,
                                                  "all slots covered",
                                                  census=hcensus)
    held["freed (crafted)"] = {"freed": hold_expire_frees(p0, base, m,
                                                          census=hcensus),
                               "evicting": False, "refuted": 0,
                               "converted": 0}
    hlaw = kernel_audit.gather_law(hcensus.rows, N)
    require(hlaw["ok"], f"gather law broken by a block form: {hlaw}")
    require(any(h["evicting"] for h in held.values())
            and any(h["refuted"] for h in held.values())
            and any(h["freed"] for h in held.values())
            and any(h["converted"] for h in held.values()),
            f"the held states never evicted, refuted, freed or converted: "
            f"{held}")
    record["held"] = held
    log(f"block forms of K1, K7-K12 bit-equal to their per-block twins and "
        f"the unsharded kernels at {len(held)} states: {json.dumps(held)}")
    sp, spool = states["serf mid"]
    sst = _to_probe_tick(sp.swim, spool.swim)
    shift = swim._probe_inputs(sp.swim, sst)["offs"][0]
    _, _, _, obs = swim._probe_pass_plain(sp.swim, sst, swim._maps(sp.swim,
                                                                  sst),
                                          swim._probe_inputs(sp.swim, sst))
    hold_ring_blocks(sp.vivaldi, spool.coords, obs.shift, obs.rtt_ms,
                     obs.acked, m, "serf mid")
    hold_ring_blocks(sp.vivaldi, *_random_ring(dev, 23), m, "random ring")
    for blocks in (2, 4, 8):
        hold_sentinels(dev, blocks)
    log("sharded K13 bit-equal (serf mid, random ring); index-0 sentinels "
        "held at B = 2, 4, 8")
    del shift

    # peer access: the chunk over cards
    if cards >= 2:
        pm = _shard_mesh([torch.device("cuda", i)
                          for i in range(min(cards, bb))])
        kernels.enable_peer_access(pm.devices)
        pch, _ = serf.run(ref["params"], meshlib.shard_state(
            _flat(chunk_from), pm), 10, bench.VICTIM)
        _same_state(_flat(pch), unchunk, "sharded chunk over cards")
        record["peer_access"] = f"held over {len(pm.devices)} cards"
    else:
        record["peer_access"] = "not run: 1 card"
    log(json.dumps({"peer_access": record["peer_access"]}))

    # times: the probe tick at B = 1, 2, 4 on one card against the
    # unsharded tick, then each block form
    sp_probe = spool.replace(swim=sst)
    ticks = {"unsharded": _scaling_tick_ms(sp, sp_probe, 0, dev)}
    for blocks in SHARD_SCALING:
        ticks[f"B={blocks}"] = _scaling_tick_ms(sp, sp_probe, blocks, dev)
    record["probe_tick_ms"] = ticks
    log("sharded probe tick (serf.step and the monitor) at tick "
        f"{sst.tick} on one card: " + json.dumps(ticks))
    one = _shard_mesh([dev] * bb)
    times = time_block_forms(sp.swim, sp.vivaldi, sst, spool.coords, one)
    unsharded = {**time_detector(sp.swim, sst), "probe": time_probe(
        sp.swim, sst, "serf mid")}
    ring = time_ring(sp.vivaldi, spool.coords, obs.shift, obs.rtt_ms,
                     obs.acked)
    d_ms, d_by = _draw_bound(list(swim._probe_draws(sp.swim,
                                                    sst.tick).values()),
                             SASS_PER_ELEMENT)
    bounds = {"threefry_draws_blocks": (d_ms, d_by, None, None),
              "probe_round_blocks": (unsharded["probe"]["k7_bound_ms"],
                                     "bytes", unsharded["probe"]["k7_ms"],
                                     None),
              "originate_blocks": (unsharded["probe"]["k8_bound_ms"],
                                   "bytes", unsharded["probe"]["k8_ms"],
                                   unsharded["probe"]["topk_ms"]),
              "vivaldi_ring_blocks": (ring["bound_ms"], ring["bound_by"],
                                      ring["ms"], None)}
    for name in ("subject_maps", "map_add", "maps_convert",
                 "suspicion_expiry", "refutation", "expire"):
        t = unsharded[name]
        bounds[f"{name}_blocks"] = (t["bound_ms"], "bytes", t["ms"],
                                    t["library_ms"])
    # K11's two launches, each against its own bytes
    dense = unsharded["dense_expiry"]
    for part, name in (("pre", "dense_expiry_blocks"),
                       ("post", "dense_expiry_post_blocks")):
        bounds[name] = (dense[f"{part}_bound_ms"], "bytes",
                        (dense["phase_ms"] or {}).get(f"dense_{part}_kernel"),
                        None)
    entries = []
    u_bytes = 14 * p0.rumor_slots
    for name, (src, replaces, _, comb) in BLOCK_ENTRIES.items():
        t = times[name]
        bound, by, one_ms, lib = bounds[name]
        entries.append(_sharded_entry(
            name, "consul_tpu_torch/kernels/csrc/" + src, replaces,
            path[name], t["ms"], bound, t["plain_ms"], library_ms=lib,
            bound_by=by, ms_per_block=t["ms"] / bb, unsharded_ms=one_ms,
            call_ms=t["call_ms"], peak_bytes=t["peak_bytes"],
            shape=[N, p0.rumor_slots, bb]))
        if comb:
            # a combine reads the blocks' partials and writes the [U]
            # table and the small outputs: its bound is those bytes
            cbound = _bytes_ms(8 * COMBINE_PART[comb[0]] * bb + 2 * u_bytes)
            entries.append(_sharded_entry(
                comb[0], "consul_tpu_torch/kernels/csrc/" + src, replaces,
                path[comb[0]], t["combine_ms"], cbound, t["plain_ms"],
                library_ms=None, closes=name))
    record["times"] = times
    record["seconds"] = time.perf_counter() - t0
    log(f"phase 16: {record['seconds']:.1f} s")
    return entries, record


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

    SASS_PER_ELEMENT.update(draw_census())
    states = {}
    with swim_twin_calls() as twins:
        results, records, r = phases_2_to_10(dev, states)
    log(f"K7-K14 twins called on card states in phases 2-10: {twins}")
    require(not any(twins.values()), f"a K7-K14 twin ran on the card "
            f"outside the holds: {twins}")
    k78, probe_record = probe_phase(dev, r, states)
    k912, detector_record = detector_phase(dev, r, states)
    k1314, ring_bulk_record = vivaldi_bulk_phase(
        dev, r, states, records["correlated"]["launches"]["bulk_step"])
    results += k78 + k912 + k1314
    contracts = contracts_phase(dev)
    k15, sharded_record = sharded_phase(dev)
    results += k15
    k16, sharded_probe_record = sharded_probe_phase(dev, states)
    results += k16
    for k in results:
        log(f"kernel {k['name']}: ms={k['ms']} plain_ms={k['plain_ms']} "
            f"bound_ms={k['bound_ms']} ({k['bound_by']}) launches="
            f"{k['launches']} library_ms={k['library_ms']}")
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": results, **records,
              "probe": probe_record, "detector": detector_record,
              "vivaldi_bulk": ring_bulk_record, "contracts": contracts,
              "sharded": sharded_record,
              "sharded_probe": sharded_probe_record,
              "twin_calls": twins,
              "sass_per_element": SASS_PER_ELEMENT,
              "main_path": {"ticks": r["ticks"], "wall_s": r["wall"],
                            "timed_ticks_run": r["timed_ticks_run"],
                            "host_syncs": r["host_syncs"],
                            "peak_mem_bytes": r["peak_mem_bytes"],
                            "launches": r["all_launches"],
                            "draw_launches": r["draw_launches"],
                            "sim_counters": r["sim_counters"]}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phases_2_to_10(dev, for_phase_11: dict) -> tuple:
    """Phases 2-10, leaving (params, state) pairs for phase 11's holds in
    for_phase_11.
    Returns (the kernels-line entries, the phases' records, the main
    path's result)."""
    r = main_path(dev)

    params = r["params"]
    mid = mid_state(r)
    states = {"mid": mid.swim, "final": r["state"].swim}
    for_phase_11.update({name: (params.swim, st)
                         for name, st in states.items()})
    for_phase_11.update({"serf mid": (params, mid),
                         "serf final": (params, r["state"])})
    launches = r["all_launches"]
    k1, k1_record = check_draws(dev, params.swim, r["state"].swim.tick,
                                SASS_PER_ELEMENT, r["draw_launches"])
    k2, k2_states = check_gossip(dev, params, states,
                                 events_call_after_fire(params, r["state"]),
                                 launches)
    results = [*k1, *k2,
               check_monitor(dev, params.swim, states, bench.VICTIM,
                             launches["believed_down"])]
    k4, oracle_record = oracle_phase(dev)
    results += k4
    k2_chaos, chaos_record = chaos_phase(
        dev, k2_states["final"]["exchange_ms"], for_phase_11)
    k5, correlated_record = correlated_phase(dev, for_phase_11)
    results += [k2_chaos, k5]
    wan_record = wan_phase(dev, for_phase_11)
    k6, ae_record = ae_phase(dev)
    results += k6
    vivaldi_record = vivaldi_phase(dev)
    # K1's normal mode runs on the Vivaldi solver's path, not the main one
    for e in k1:
        if e["name"] == "threefry_draws.normal":
            e["launches"] = vivaldi_record["draw_launches"]["normal"]
            e["launches_path"] = "vivaldi (phase 10)"
    records = {"oracle": oracle_record, "chaos": chaos_record,
               "correlated": correlated_record, "federation": wan_record,
               "antientropy": ae_record, "vivaldi": vivaldi_record,
               "gossip_states": k2_states, "k1": k1_record}
    return results, records, r


if __name__ == "__main__":
    sys.exit(main())
