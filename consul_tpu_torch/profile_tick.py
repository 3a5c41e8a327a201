"""Where a tick's time goes on the card: per-tick wall times (probe ticks
and gossip-only ticks apart), device kernels per tick of each kind, and a
torch.profiler window over the timed scan, summed by kernel name, with
the device's busy and idle share.

    python -m consul_tpu_torch.profile_tick [n_nodes] [ticks]
    python -m consul_tpu_torch.profile_tick kernels [n_nodes]
    python -m consul_tpu_torch.profile_tick draws [n_nodes]
    python -m consul_tpu_torch.profile_tick k12k13 [n_nodes]
    python -m consul_tpu_torch.profile_tick k9k14 [n_nodes]
    python -m consul_tpu_torch.profile_tick k6 [tick]
    python -m consul_tpu_torch.profile_tick k2 [n_nodes] [reps]
    python -m consul_tpu_torch.profile_tick k5k4 [n_nodes]
    python -m consul_tpu_torch.profile_tick wan [reps]
    python -m consul_tpu_torch.profile_tick vivaldi [reps]

Builds the bench configuration, runs the warm scan and the kill as the
bench does, then times `ticks` fenced ticks, counts the device kernels of
10 gossip-only and 10 probe ticks (each tick with its monitor call, as
the bench scan runs it), times each pass of a probe tick alone, and
profiles a window of `ticks` monitored ticks; the bulk channel's step
(K14) is timed apart, at the correlated bench's mid-drain state at the
same N.  Each pass's entry gives
its fenced wall, its device time (the sum of its CUDA kernels' times
from torch.profiler) and its device kernels per call.  The `kernels` form runs
the set-up and the kernel count only; it uses nothing but the serf/swim
entry points, so it also counts an older tree's kernels when that tree's
package comes first on PYTHONPATH.  The `draws` form times each random
draw of the main path at its shape through the public `utils/prng.py`
functions (device ms, call ms, device kernels per call), which an older
tree has too.  The `k12k13` form times the refutation and expire (K12)
and the ring observation (K13) on the inputs the bench run hands them at
its first probe ticks after the kill that neither refute nor free a slot,
that refute and that free one; it spies on the swim and vivaldi entry
points through their module attributes, so it also times an older
tree's passes when that tree's package comes first on PYTHONPATH.  The
`k9k14` form does the same for the subject maps' build and updates (K9)
at the bench run's first probe ticks after the kill that convert no
suspect slot and that convert one, and for the bulk step (K14) at the
correlated bench's mid-drain and on the empty channel of the tick
before its overflow.  The `k6` form times K6's diff (both forms), its
merge and one whole anti-entropy step at the churn's mid-churn state
(older trees too).  The `k5k4` form times the correlated bench's tick
and K5 at its mid-drain state, and the oracle's summary, delta and page
reads at its 1M state, with their device kernels (older trees too).
The `k2` form times K2's pack and exchange alone on the swim caller's
inputs at the bench run's kill (older trees too).  The `probe` form
times one probe tick of the bench run (serf.step and the monitor, on
clones of the state at its first probe tick after the kill): every
device record of a call summed over two captures of 20 calls, and each
pass's device ms (`_pass_times`); older trees too.
The `wan` and `vivaldi` forms time the registry's `wan.run` (3 DCs x
50,000 nodes: a gossip-only and a probe tick) and `vivaldi.sim_step`
(100,000 nodes) entries as parallel/kernel_audit.py builds them: fenced
ms and device kernels a tick.
Prints one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from consul_tpu_torch import correlated, kernels, scenarios
from consul_tpu_torch.bench import CHUNK, VICTIM
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import antientropy, serf, swim, vivaldi
from consul_tpu_torch.ops import reconcile
from consul_tpu_torch.utils import prng


def next_probe_tick(step, period: int, s):
    """A clone of s (a swim or a serf state) stepped by `step` to its next
    probe tick."""
    s = s.clone()
    while getattr(s, "swim", s).tick % period:
        s = step(s)
    return s


def _setup(n_nodes: int):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick needs a CUDA device")
    dev = torch.device("cuda", 0)
    params = serf.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=n_nodes, rumor_slots=32, alloc_cap=8, p_loss=0.01, seed=7))
    s = serf.init_state(params, device=dev)
    s, _ = serf.run(params, s, CHUNK, VICTIM)
    s = s.replace(swim=swim.kill(s.swim, VICTIM))
    torch.cuda.synchronize(dev)
    return dev, params, s


def _calls(fn, make):
    """(call, make): fn as a call of one input, and the maker of its
    input (with no `make`, fn takes none)."""
    if make is None:
        return (lambda _: fn()), (lambda: None)
    return fn, make


def median_ms(fn, reps: int = 20, warmup: int = 3, make=None) -> float:
    """Median of `reps` CUDA-event timings of one call of fn, host
    dispatch included.  With `make`, fn takes an input make() builds
    before the call's events (a clone of a state fn consumes)."""
    call, make = _calls(fn, make)
    for _ in range(warmup):
        call(make())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        x = make()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call(x)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


_FLUSH: list = []


def _flush() -> torch.Tensor:
    if not _FLUSH:
        _FLUSH.append(torch.zeros(96 << 20, dtype=torch.uint8, device="cuda"))
    return _FLUSH[0]


def kernel_ms(fn, reps: int = 20, make=None) -> float:
    """Median device ms of one call of fn with its host dispatch hidden:
    the stream sleeps (~1 ms) while the host enqueues a 96 MB read that
    evicts the inputs from the 50 MB L2 (as the tick's earlier passes do,
    with no dirty lines left to write back) and the call between two CUDA
    events.  With `make`, fn takes an input make() builds first."""
    call, make = _calls(fn, make)
    flush = _flush()
    for _ in range(3):
        call(make())
    times = []
    for _ in range(reps):
        x = make()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        flush.max()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call(x)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernels_of(fn) -> dict:
    """{kernel: launches} of one call of fn (torch.profiler; copies and
    memsets left out)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {k: v for k, v in _device_ops(prof).items()
            if not k.startswith(("Memcpy", "Memset"))}


def kernels_a_call(fn, reps: int = 10, tries: int = 3, make=None) -> dict:
    """{kernel: launches per call} of fn, from torch.profiler's records of
    `reps` calls (copies and memsets left out; in a long run on the card
    a capture of one call has recorded nothing, and one of ten calls six
    of the ten launches), taken again when a capture records no device
    activity at all.  With `make`, fn takes an input make() builds before
    the capture (a clone of a state fn consumes)."""
    call, make = _calls(fn, make)
    call(make())
    torch.cuda.synchronize()
    for attempt in range(tries):
        inputs = [make() for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                call(x)
            torch.cuda.synchronize()
        kinds = {k: v / reps for k, v in _device_ops(prof).items()
                 if not k.startswith(("Memcpy", "Memset"))}
        if kinds:
            return kinds
        print(f"profile {attempt + 1} of {tries} of {reps} calls recorded "
              f"nothing", file=sys.stderr)
    return {}


def _device_ops(prof) -> dict:
    """{name: calls} of the device activities a profile recorded."""
    return {k: calls for k, (_, calls) in _device_times(prof).items()}


def _device_times(prof) -> dict:
    """{name: (device us, calls)} of the device activities a profile
    recorded."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(ev, "device_time_total", None)
            out[ev.key] = (dt if dt is not None else ev.cuda_time_total,
                           ev.count)
    return out


def kernels_per_tick(params, s, ticks: int = 10, subject: int = VICTIM):
    """Device kernels of `ticks` gossip-only ticks and `ticks` probe ticks,
    each tick (serf.step plus its monitor call) under its own profiler.
    Returns (state, {kind: {"kernels": mean per tick, "device_ops": mean
    per tick with copies and memsets, "names": {kernel: calls per tick},
    "launches": {port kernel: launches per tick}}}).  The launches come
    from the wrappers' own counts (kernels.LAUNCHES), which no profiler
    record that goes missing can change."""
    dev = s.swim.device
    period = params.swim.probe_period_ticks
    out = torch.empty(1, dtype=torch.float32, device=dev)
    seen = {"gossip": [], "probe": []}
    launched = {"gossip": [], "probe": []}
    while min(len(v) for v in seen.values()) < ticks:
        kind = "probe" if s.swim.tick % period == 0 else "gossip"
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = serf.step(params, s)
            swim.believed_down_fraction(params.swim, s.swim, subject, out=out)
            torch.cuda.synchronize(dev)
        if len(seen[kind]) < ticks:
            seen[kind].append(_device_ops(prof))
            launched[kind].append({k: v - before[k]
                                   for k, v in kernels.LAUNCHES.items()})
    summary = {}
    for kind, runs in seen.items():
        totals: dict = {}
        for ops in runs:
            for name, calls in ops.items():
                totals[name] = totals.get(name, 0) + calls
        names = {name: calls / len(runs) for name, calls in totals.items()}
        kern = {k: v for k, v in names.items()
                if not k.startswith(("Memcpy", "Memset"))}
        summary[kind] = {"kernels": sum(kern.values()),
                         "device_ops": sum(names.values()),
                         "ticks": len(runs),
                         "names": dict(sorted(kern.items(),
                                              key=lambda kv: -kv[1])),
                         "launches": {k: sum(r[k] for r in launched[kind])
                                      / len(runs) for k in kernels.LAUNCHES}}
    return s, summary


def main(n_nodes: int = 1_000_000, ticks: int = 50) -> dict:
    dev, params, s = _setup(n_nodes)

    # per-tick wall, each tick fenced (fencing removes the host/device
    # overlap, so these are upper bounds on a tick's cost in the scan)
    period = params.swim.probe_period_ticks
    walls = {"probe": [], "gossip": []}
    fr = torch.zeros(ticks, dtype=torch.float32, device=dev)
    for t in range(ticks):
        kind = "probe" if s.swim.tick % period == 0 else "gossip"
        t0 = time.perf_counter()
        s = serf.step(params, s)
        swim.believed_down_fraction(params.swim, s.swim, VICTIM, out=fr[t:t + 1])
        torch.cuda.synchronize(dev)
        walls[kind].append(time.perf_counter() - t0)

    passes = _pass_times(params, s, dev)
    s, per_tick = kernels_per_tick(params, s)

    # unfenced window under the profiler: the scan as the bench runs it
    launches0 = dict(kernels.LAUNCHES)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s, fr = serf.run(params, s, ticks, VICTIM)
        fr.cpu()
        window = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()}
    by_kernel = {k: {"us": us, "calls": calls}
                 for k, (us, calls) in _device_times(prof).items() if us}
    busy_us = sum(v["us"] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1]["us"])[:25]
    out = {
        "device": torch.cuda.get_device_name(dev),
        "n_nodes": n_nodes, "ticks": ticks,
        "fenced_tick_ms": {k: 1000.0 * sum(v) / max(len(v), 1)
                           for k, v in walls.items()},
        "window_s": window, "window_ms_per_tick": 1000.0 * window / ticks,
        "device_busy_us": busy_us,
        "device_idle_share": max(0.0, 1.0 - busy_us / (window * 1e6)),
        "launches": launches,
        "pass_ms": passes,
        "kernels_per_tick": per_tick,
        "top_device_time": [{"name": k[:120], **v} for k, v in top],
    }
    return out


def _pass_times(params, s, dev, reps: int = 5) -> dict:
    """Each pass of a probe tick, run alone on the same probe-tick input
    state (`probe_round` with its map_add, which `map_add` also times
    alone; `maps_convert` on the state's own conversions; the dense
    expiry with its origination), and the bulk channel's step at the
    correlated bench's mid-drain state: {pass: {"wall_ms":
    fenced wall ms (host dispatch + device,
    median of `reps`), "device_ms": the sum of its CUDA kernels' device
    times per call, "kernels": its device kernels per call}} (the last
    two from one torch.profiler capture of `reps` calls; copies and
    memsets left out of both).  The passes that update the state in place
    on the card (K7 and K8 in `probe_round`, K10, K11 and K8 in the dense
    expiry, K12, K13's window, K14) or the maps (K9's updates,
    `probe_round`'s map_add) get a clone of it a call, made before the
    fenced window and outside the profiler's capture."""
    p, sw = params.swim, s.swim
    while sw.tick % p.probe_period_ticks:
        s = serf.step(params, s)
        sw = s.swim
    maps = swim._maps(p, sw)
    _, obs, _ = swim._probe_round(p, sw.clone(), maps)
    s1, want, rows, _ = swim._probe_pass(p, sw.clone(), maps,
                                         swim._probe_inputs(p, sw))
    _, alloc = swim._originate(p, s1, want, swim.SUSPECT, s1.incarnation,
                               rows)
    _, convert = swim._suspicion_expiry(p, sw.clone())
    out = torch.empty(1, dtype=torch.float32, device=dev)
    fns = {
        "maps": lambda: swim._maps(p, sw),
        "probe_round": (lambda: (sw.clone(), copy_maps(maps)),
                        lambda a: swim._probe_round(p, a[0], a[1])),
        "map_add": (maps[0].clone, lambda m: swim._map_add(m, *alloc)),
        "suspicion_expiry": (sw.clone,
                             lambda st: swim._suspicion_expiry(p, st)),
        "maps_convert": (lambda: copy_maps(maps),
                         lambda m: swim._maps_convert(m, sw, convert)),
        "dense_suspicion_expiry": (sw.clone, lambda st: (
            swim._dense_suspicion_expiry(p, st, obs.shift, maps))),
        "refutation": (sw.clone, lambda st: swim._refutation(p, st)),
        "expire": (sw.clone, lambda st: swim._expire(p, st)),
        "bulk_flag_sync": lambda: swim._bulk_flag(sw.bulk_member),
        "disseminate": lambda: swim._disseminate(p, sw),
        "vivaldi_observe_ring": (s.coords.clone, lambda c: (
            vivaldi.observe_ring(params.vivaldi, c, obs.shift, obs.rtt_ms,
                                 obs.acked))),
        "monitor": lambda: swim.believed_down_fraction(p, sw, VICTIM, out=out),
    }
    bp = correlated.bench_params(p.n_nodes)
    bs = correlated.mid_drain(bp, dev)
    fns["bulk_step"] = (bs.clone, lambda st: swim._bulk_step(bp, st))
    return _time_passes(fns, dev, reps)


def copy_maps(maps) -> tuple:
    """The four subject maps copied into the rows of one [4, N] block, as
    swim._maps writes them: what a caller keeps of maps it hands to K9's
    updates, which consume them on the card."""
    return tuple(torch.stack(maps))


def _time_passes(fns: dict, dev, reps: int) -> dict:
    """{name: {"wall_ms", "device_ms", "kernels"}} of each call (see
    _pass_times).  An entry is a call, or a pair (make, call) whose call
    takes an input make() builds before the call's fenced window and
    before the profiler's capture."""
    times = {}
    for name, entry in fns.items():
        call, make = (entry[1], entry[0]) if isinstance(entry, tuple) \
            else _calls(entry, None)
        walls = []
        for _ in range(reps + 1):
            x = make()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            call(x)
            torch.cuda.synchronize(dev)
            walls.append(1000.0 * (time.perf_counter() - t0))
        inputs = [make() for _ in range(reps)]
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                call(x)
            torch.cuda.synchronize(dev)
        kern = [v for k, v in _device_times(prof).items()
                if not k.startswith(("Memcpy", "Memset"))]
        times[name] = {"wall_ms": statistics.median(walls[1:]),
                       "device_ms": sum(us for us, _ in kern) / 1000.0 / reps,
                       "kernels": sum(c for _, c in kern) / reps}
    return times


def draw_times(n_nodes: int = 1_000_000) -> dict:
    """Each random draw of the main path at its shape, through the public
    prng functions: device ms (kernel_ms), call ms (median_ms) and the
    device kernels of one call."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick needs a CUDA device")
    dev = torch.device("cuda", 0)
    n = n_nodes
    key = prng.tick_key(7, 12345, 5)
    calls = {
        "uniform [N, 3]": lambda: prng.uniform(key, (n, 3), dev),
        "exponential [N]": lambda: prng.exponential(key, (n,), dev),
        "normal [N, 8]": lambda: prng.normal(key, (n, 8), dev),
        "randint [3]": lambda: prng.randint(key, (3,), 1, n, dev),
        "randint [4]": lambda: prng.randint(key, (4,), 1, n, dev),
    }
    out = {}
    for name, fn in calls.items():
        kern = kernels_of(fn)
        out[name] = {"device_ms": kernel_ms(fn), "call_ms": median_ms(fn),
                     "kernels": sum(kern.values())}
    return {"device": torch.cuda.get_device_name(dev), "n_nodes": n,
            "draws": out}


def _copy(x):
    """A swim or Vivaldi state with every tensor leaf its own."""
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def k12_k13_times(n_nodes: int = 1_000_000, ticks: int = 400) -> dict:
    """K12's refutation and expire and K13's ring observation, each timed
    on the inputs the bench run hands it at three probe ticks after the
    kill: the first whose refutation and expire neither refute nor free a
    slot ("quiet"), the first that refutes and the first that frees one.
    Per call: device ms (kernel_ms: dispatch hidden, L2 evicted), call ms
    (median_ms, dispatch included) and device kernels; every call takes a
    copy of its input, made outside the timed window (the card's passes
    consume it)."""
    dev, params, s = _setup(n_nodes)
    p = params.swim
    real = {"refutation": swim._refutation, "expire": swim._expire,
            "ring": vivaldi.observe_ring}
    seen: dict = {}

    def spy_refutation(pp, st):
        x = _copy(st)
        out = real["refutation"](pp, st)
        seen["refutation"] = x
        seen["refuted"] = int((out.r_kind != x.r_kind).sum())
        return out

    def spy_expire(pp, st):
        x = _copy(st)
        out = real["expire"](pp, st)
        seen["expire"] = x
        seen["freed"] = int((x.r_active & ~out.r_active).sum())
        return out

    def spy_ring(vp, c, shift, rtt_ms, mask):
        seen["ring"] = (_copy(c), shift.clone(), rtt_ms.clone(), mask.clone())
        return real["ring"](vp, c, shift, rtt_ms, mask)

    picked: dict = {}
    swim._refutation, swim._expire = spy_refutation, spy_expire
    vivaldi.observe_ring = spy_ring
    try:
        for _ in range(ticks):
            seen.clear()
            s = serf.step(params, s)
            if "ring" not in seen:
                continue
            for kind, hit in (("quiet", not seen["refuted"]
                               and not seen["freed"]),
                              ("refuting", seen["refuted"] > 0),
                              ("freeing", seen["freed"] > 0)):
                if hit and kind not in picked:
                    picked[kind] = dict(seen, tick=s.swim.tick - 1)
            if len(picked) == 3:
                break
    finally:
        swim._refutation, swim._expire = real["refutation"], real["expire"]
        vivaldi.observe_ring = real["ring"]
    out = {}
    for kind, got in picked.items():
        c, shift, rtt_ms, mask = got["ring"]
        calls = {
            "refutation": (lambda x: swim._refutation(p, x),
                           lambda g=got: _copy(g["refutation"])),
            "expire": (lambda x: swim._expire(p, x),
                       lambda g=got: _copy(g["expire"])),
            "vivaldi_ring": (lambda x, a=(shift, rtt_ms, mask): (
                vivaldi.observe_ring(params.vivaldi, x, *a)),
                lambda c=c: _copy(c))}
        out[kind] = {"tick": got["tick"], "refuted": got["refuted"],
                     "freed": got["freed"]}
        for name, (fn, make) in calls.items():
            x = make()
            out[kind][name] = {
                "device_ms": kernel_ms(fn, make=make),
                "call_ms": median_ms(fn, make=make),
                "kernels": sum(kernels_of(lambda: fn(x)).values())}
    return {"device": torch.cuda.get_device_name(dev), "n_nodes": n_nodes,
            "at": out}


def k9_k14_times(n_nodes: int = 1_000_000, ticks: int = 400) -> dict:
    """K9's build, map_add and maps_convert, each timed on the inputs the
    bench run hands it at two probe ticks after the kill: the first whose
    suspicion expiry converts no slot ("quiet") and the first that
    converts one; and K14 at the correlated bench's mid-drain and on the
    empty channel of the probe tick before its overflow.  Per call: device
    ms (kernel_ms), call ms (median_ms) and device kernels; every call
    takes a copy of its input, made outside the timed window (the card's
    updates consume it)."""
    dev, params, s = _setup(n_nodes)
    p = params.swim
    real = {"maps": swim._maps, "map_add": swim._map_add,
            "maps_convert": swim._maps_convert}
    seen: dict = {}

    def spy_maps(pp, st):
        seen["maps"] = _copy(st)
        return real["maps"](pp, st)

    def spy_add(m, *pairs):
        seen["map_add"] = (m.clone(), tuple(x.clone() for x in pairs))
        return real["map_add"](m, *pairs)

    def spy_convert(maps, st, conv):
        seen["maps_convert"] = (copy_maps(maps), _copy(st), conv.clone())
        seen["converted"] = int(conv.sum())
        return real["maps_convert"](maps, st, conv)

    picked: dict = {}
    swim._maps, swim._map_add = spy_maps, spy_add
    swim._maps_convert = spy_convert
    try:
        for _ in range(ticks):
            seen.clear()
            s = serf.step(params, s)
            if "maps_convert" not in seen:
                continue
            kind = "converting" if seen["converted"] else "quiet"
            picked.setdefault(kind, dict(seen, tick=s.swim.tick - 1))
            if len(picked) == 2:
                break
    finally:
        swim._maps, swim._map_add = real["maps"], real["map_add"]
        swim._maps_convert = real["maps_convert"]
    out = {}
    for kind, got in picked.items():
        m, pairs = got["map_add"]
        cmaps, cst, conv = got["maps_convert"]
        calls = {
            "subject_maps": (lambda x: swim._maps(p, x),
                             lambda g=got: g["maps"]),
            "map_add": (lambda x, a=pairs: swim._map_add(x, *a), m.clone),
            "maps_convert": (lambda x, st=cst, c=conv: swim._maps_convert(
                x, st, c), lambda c=cmaps: copy_maps(c))}
        out[kind] = {"tick": got["tick"], "converted": got["converted"],
                     "pairs": int(pairs[2].sum())}
        for name, (fn, make) in calls.items():
            x = make()
            out[kind][name] = {
                "device_ms": kernel_ms(fn, make=make),
                "call_ms": median_ms(fn, make=make),
                "kernels": sum(kernels_of(lambda: fn(x)).values())}
    bp = correlated.bench_params(n_nodes)
    bulk = {"mid-drain": correlated.mid_drain(bp, dev)}
    s, mask = correlated.start(bp, correlated.FRACTION, correlated.SEED, dev)
    for _ in range(4096):
        before = _copy(s)
        s, _, _ = correlated.run_chunk(bp, s, 1, mask)
        if bool(s.bulk_member.any()):
            bulk["empty"] = before
            break
    for kind, st in bulk.items():
        fn = lambda x: swim._bulk_step(bp, x)  # noqa: E731
        out[f"bulk_step {kind}"] = {
            "tick": st.tick, "members": int(st.bulk_member.sum()),
            "device_ms": kernel_ms(fn, make=st.clone),
            "call_ms": median_ms(fn, make=st.clone),
            "kernels": sum(kernels_of(lambda: fn(st.clone())).values())}
    return {"device": torch.cuda.get_device_name(dev), "n_nodes": n_nodes,
            "at": out}


class _Picked(Exception):
    """Ends a churn run once its state is kept."""


def k6_times(tick: int = 50, reps: int = 20) -> dict:
    """K6 at the anti-entropy churn's mid-churn state (scenarios.ae_churn
    at 1M services over 100,000 agents, the state before the step of churn
    tick `tick`): the diff in its plain form and in the step's (masked by
    the due agents; an older tree without that form runs its diff and the
    masks as its sync_masks did), the merge, sync_masks and one whole
    antientropy.step.  Per call: device ms (kernel_ms: dispatch hidden,
    L2 evicted), call ms (median_ms), and from _time_passes the fenced
    wall, the profiler's device ms (L2 warm) and the device kernels.  It
    uses nothing but the antientropy and reconcile entry points, so it
    also times an older tree when that tree's package comes first on
    PYTHONPATH."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = scenarios.Churn(n_agents=100_000, capacity=1 << 20,
                          services=1_000_000)
    params = cfg.params
    kept = {}

    def keep(label, st, up):
        if label == tick:
            kept["at"] = (st, up)
            raise _Picked

    try:
        scenarios.ae_churn(cfg, dev, keep=keep)
    except _Picked:
        pass
    s, up = kept["at"]
    _, due, push, drop = antientropy.sync_masks(params, s, up)
    cols = (s.d_ids, s.d_ver, s.a_ids, s.a_ver)
    step_form = "due" in inspect.signature(
        reconcile.diff_sorted_kernel).parameters

    def diff_step():
        if step_form:
            return reconcile.diff_sorted_kernel(*cols, due, s.d_node,
                                                s.a_node)
        d = reconcile.diff_sorted_kernel(*cols)
        return (d.push & due[s.d_node.to(torch.int64)],
                d.drop & due[s.a_node.to(torch.int64)])

    calls = {
        "diff": lambda: reconcile.diff_sorted_kernel(*cols),
        "diff_step": diff_step,
        "merge": lambda: reconcile.merge_kernel(
            s.d_ids, s.d_ver, s.d_node, s.a_ids, s.a_ver, s.a_node, push,
            drop),
        "sync_masks": lambda: antientropy.sync_masks(params, s, up),
        "step": lambda: antientropy.step(params, s, up)}
    passes = _time_passes(calls, dev, reps)
    out = {}
    for name, fn in calls.items():
        out[name] = {"device_ms": kernel_ms(fn), "call_ms": median_ms(fn),
                     "fenced_ms": passes[name]["wall_ms"],
                     "profiler_ms": passes[name]["device_ms"],
                     "kernels": passes[name]["kernels"]}
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        antientropy.step(params, s, up)
        torch.cuda.synchronize(dev)
        walls.append(1000.0 * (time.perf_counter() - t0))
    walls = sorted(walls[1:])
    out["step"]["fenced_p10_p90_ms"] = [walls[len(walls) // 10],
                                        walls[(9 * len(walls)) // 10]]
    return {"device": torch.cuda.get_device_name(dev), "tick": tick,
            "step_form": step_form,
            "rows": [s.d_ids.numel(), s.a_ids.numel()],
            "live": int((s.d_ids != antientropy.INVALID_ID).sum()),
            "at": out}


def wall_ms(fn, reps: int = 20) -> float:
    """Median host wall ms of one call of fn, ended by a synchronize."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    return sorted(times)[len(times) // 2]


def k5_k4_times(n_nodes: int = 1_000_000, reps: int = 20) -> dict:
    """K5 and K4 where their callers run them.  The correlated bench's
    tick (`swim.step`, then K5 into the tick's slots) from its mid-drain
    state (correlated.mid_drain): fenced ms a tick over `reps` ticks,
    device kernels of each of 10 ticks, and K5 alone (device ms with
    kernel_ms, call ms, device kernels a call over 10 calls).  The
    oracle's membership reads at its 1M state (N - 1,000 joined, three
    members killed and advanced 50 ticks): members_summary,
    members_delta(256) (a checkpoint already set) and members(limit=100),
    each its wall ms and device kernels a read (over 10 reads).  Nothing
    but public entry points, so an older tree's
    package first on PYTHONPATH is measured the same way."""
    from consul_tpu_torch.oracle import GossipOracle
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick needs a CUDA device")
    dev = torch.device("cuda", 0)
    bp = correlated.bench_params(n_nodes)
    _, mask = correlated.start(bp, correlated.FRACTION, correlated.SEED, dev)
    s = correlated.mid_drain(bp, dev)
    out = (torch.empty(1, dtype=torch.float32, device=dev),
           torch.empty(1, dtype=torch.int32, device=dev))
    k5 = lambda: swim.mass_detection_stats(bp, s, mask, out=out)  # noqa: E731
    res = {"k5": {"tick": s.tick, "device_ms": kernel_ms(k5),
                  "call_ms": median_ms(k5),
                  "kernels": sum(kernels_a_call(k5).values())}}
    held = {"s": s}

    def tick():
        held["s"] = swim.step(bp, held["s"])
        swim.mass_detection_stats(bp, held["s"], mask, out=out)

    per_tick = [sum(kernels_of(tick).values()) for _ in range(10)]
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize(dev)
        walls.append(1000.0 * (time.perf_counter() - t0))
    res["correlated_tick"] = {"fenced_ms": statistics.median(walls[1:]),
                              "kernels_per_tick": per_tick}
    o = GossipOracle(GossipConfig.lan(), SimConfig(
        n_nodes=n_nodes, rumor_slots=32, alloc_cap=8, p_loss=0.01, seed=7,
        n_initial=n_nodes - 1000), device=dev)
    o.warmup()
    o.advance(1)
    o.members_delta()
    for v in (1000, n_nodes // 2, n_nodes - 1001):
        o.kill(f"node{v}")
    o.advance(50)
    reads = {"members_summary": o.members_summary,
             "members_delta(256)": lambda: o.members_delta(256),
             "members(limit=100)": lambda: o.members(limit=100,
                                                      offset=n_nodes // 2)}
    for name, fn in reads.items():
        res[name] = {"wall_ms": wall_ms(fn, reps),
                     "kernels": kernels_a_call(fn)}
    o.stop()
    return {"device": torch.cuda.get_device_name(dev), "n_nodes": n_nodes,
            "at": res}


def registry_times(name: str, reps: int = 20) -> dict:
    """One entry of the program-contract registry on the card, built by
    its build function (parallel/kernel_audit.py) at full width: each form's
    fenced ms (median, p10 and p90 of `reps` calls, each on an input made
    before its fence) and device kernels a call
    (kernel_audit.profiled_kernels)."""
    from consul_tpu_torch.parallel import kernel_audit
    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick needs a CUDA device")
    dev = torch.device("cuda", 0)
    spec = next(s for s in kernel_audit.REGISTRY if s.name == name)
    prog = spec.build(dev, 1)
    forms = {}
    for form, call in prog.forms.items():
        for _ in range(2):
            call.fn(call.make())
        walls = []
        for _ in range(reps):
            x = call.make()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            call.fn(x)
            torch.cuda.synchronize(dev)
            walls.append(1000.0 * (time.perf_counter() - t0))
        walls.sort()
        kinds = kernel_audit.profiled_kernels(call.fn, call.make)
        forms[form] = {"fenced_ms": statistics.median(walls),
                       "fenced_p10_p90_ms": [walls[len(walls) // 10],
                                             walls[(9 * len(walls)) // 10]],
                       "kernels": sum(kinds.values()),
                       "names": {k[:120]: v for k, v in kinds.items()}}
    return {"device": torch.cuda.get_device_name(dev), "entry": name,
            "n_nodes": prog.n_nodes, "forms": forms}


def k2_times(n_nodes: int = 1_000_000, reps: int = 50) -> dict:
    """K2's pack and exchange alone on the swim caller's inputs at the
    bench run's kill (the offsets, loss key, stamp and counters its next
    tick hands them): each kernel's device ms a launch by torch.profiler
    over `reps` calls, a 96 MB read evicting the L2 before each.  Only
    `ops.gossip.disseminate_kernel`, so an older tree is timed the same
    way."""
    from consul_tpu_torch.ops import gossip, rolls
    dev, params, s = _setup(n_nodes)
    p, sw = params.swim, s.swim
    call = dict(offs=rolls.offsets(prng.tick_key(p.seed, sw.tick, 2),
                                   p.n_nodes, p.gossip_nodes, dev),
                know=sw.know, sends_left=sw.sends_left, sender_ok=sw.up,
                receiver_ok=sw.up & sw.member, slot_active=sw.r_active,
                retransmit_limit=p.retransmit_limit, p_loss=p.p_loss,
                key=prng.tick_key(p.seed, sw.tick, 5),
                learn_tick=sw.learn_tick, tick16=swim._t16(sw.tick),
                ctr=sw.ctr, want_newly=False)
    flush = _flush()
    for _ in range(5):
        gossip.disseminate_kernel(**call)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.max()
            gossip.disseminate_kernel(**call)
        torch.cuda.synchronize(dev)
    out = {"device": torch.cuda.get_device_name(dev), "n_nodes": n_nodes,
           "tick": sw.tick}
    for key, (us, calls) in _device_times(prof).items():
        for name in ("gossip_pack_kernel", "gossip_exchange_kernel"):
            if name in key:
                out[f"{name}_ms"] = us / calls / 1000.0
    return out


def probe_times(n_nodes: int = 1_000_000, reps: int = 20) -> dict:
    """One probe tick of the bench run (serf.step and the victim's
    monitor) on clones of its first probe-tick state after the kill:
    the device ms of a call, every device record summed, in each of two
    torch.profiler captures of `reps` calls; and each pass's device ms
    (_pass_times).  Only public entry points and the passes
    _pass_times names, so an older tree is timed the same way."""
    dev, params, s = _setup(n_nodes)
    s = next_probe_tick(lambda x: serf.step(params, x),
                        params.swim.probe_period_ticks, s)
    out1 = torch.empty(1, dtype=torch.float32, device=dev)

    def tick(x):
        y = serf.step(params, x)
        swim.believed_down_fraction(params.swim, y.swim, VICTIM, out=out1)

    for _ in range(3):
        tick(s.clone())
    res = {"device": torch.cuda.get_device_name(dev), "n_nodes": n_nodes,
           "tick": s.swim.tick, "probe_tick_device_ms": []}
    for _ in range(2):
        inputs = [s.clone() for _ in range(reps)]
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                tick(x)
            torch.cuda.synchronize(dev)
        res["probe_tick_device_ms"].append(
            sum(us for us, _ in _device_times(prof).values()) / reps / 1000.0)
    res["pass_device_ms"] = {k: v["device_ms"] for k, v in
                             _pass_times(params, s, dev).items()}
    return res


def count_main(n_nodes: int = 1_000_000) -> dict:
    dev, params, s = _setup(n_nodes)
    _, per_tick = kernels_per_tick(params, s)
    return {"device": torch.cuda.get_device_name(dev), "n_nodes": n_nodes,
            "kernels_per_tick": per_tick}


if __name__ == "__main__":
    if sys.argv[1:2] == ["kernels"]:
        print(json.dumps(count_main(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["draws"]:
        print(json.dumps(draw_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["k12k13"]:
        print(json.dumps(k12_k13_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["k9k14"]:
        print(json.dumps(k9_k14_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["k6"]:
        print(json.dumps(k6_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["k2"]:
        print(json.dumps(k2_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["probe"]:
        print(json.dumps(probe_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["k5k4"]:
        print(json.dumps(k5_k4_times(*[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["wan"]:
        print(json.dumps(registry_times("wan.run",
                                        *[int(a) for a in sys.argv[2:]])))
    elif sys.argv[1:2] == ["vivaldi"]:
        print(json.dumps(registry_times("vivaldi.sim_step",
                                        *[int(a) for a in sys.argv[2:]])))
    else:
        print(json.dumps(main(*[int(a) for a in sys.argv[1:]])))
