"""Program contracts of the port's entry points: the kernel audit, the
counterpart of consul_tpu/parallel/hlo_audit.py.

The JAX package holds each jitted entry point to rules read off its
compiled program.  The port runs no compiled program: an entry point is
Python dispatching hand-written kernels (kernels/csrc) and a few plain
torch ops onto the card, so the same contracts are read off one call of
the entry on the card:

  * kernel census   — the counterpart of the collective census.  The
                      hand-written kernels' launches per call, counted by
                      their wrappers (`kernels.LAUNCHES`, K1's modes in
                      `DRAW_LAUNCHES`), equal the budget name by name; the
                      device kernels of the call as torch.profiler records
                      them (the plain torch ops among them) stay within
                      the budget, and a kernel the budget never recorded
                      fails (an int64 elementwise kernel that lands on a
                      gossip-only tick).  The profiler has dropped records
                      in long runs and never added one, so its counts
                      fail only when too high;
  * host-transfer freedom — the counterpart of gather-freedom: the host
                      syncs of a call (torch's sync debug mode, and the
                      flag reads `swim.host_syncs` / `wan.host_syncs`
                      count) within the budget, and a read entry's
                      outputs the same size when it is built at N and 2N
                      (O(page), never O(N));
  * in place honored — the counterpart of donation honored: every leaf
                      the entry's passes update in place on the card
                      (`swim.PROBE_INPLACE` ... `BULK_INPLACE`,
                      `vivaldi.RING_INPLACE`) keeps its data_ptr across
                      the call.  On the CPU the twins return fresh
                      tensors, so the record holds null, not a pass;
  * bytes per node slot — the dtype-width ledger: every tensor of the
                      entry's state with N in its shape, summed, over N;
                      it must not widen past the budget;
  * peak bytes and allocations — the counterpart of the flops / peak-bytes
                      budget: the caching allocator's peak over the call
                      (above what was allocated before it) within
                      ±tolerance, its allocations no more than the budget.
                      The card has no flop cost model here; PERF.md's
                      bounds play that part;
  * one build       — the counterpart of compile-count: the kernel
                      library is loaded once in the process, and the
                      second measured call launches and allocates what
                      the first did (no build or first-use scratch inside
                      a measured call);
  * gather law      — the counterpart of full_gather_ops: in a call on a
                      node-sharded pool (parallel/mesh.py) no device makes
                      a tensor with N or more along any axis (RowCensus,
                      read through the dispatcher; the per-device peak
                      bytes are kept beside it);
  * block scaling   — the counterpart of the permute law (`judge_scaling`):
                      a sharded entry measured at B = 1, 2 and 4 blocks
                      keeps its per-block launches and its largest tensor
                      times B from growing with B.

Every record carries a topology stamp; a budget from another backend or
card refuses to judge (verdict "topology").  The measurement side
(`measure_entry`) runs on the card at the widths PERF.md §4 lists, or on
the CPU at N = 256, U = 16 (the reference's `_N`); the judge is pure
dicts in, dicts out.  Manifest I/O and the tree-wide scan of kernel
launch sites behind `registry_parity` live in kernel_lint.py; this module
never touches the filesystem.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from consul_tpu_torch import chaos, correlated, kernels
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import antientropy, serf, swim, vivaldi, wan
from consul_tpu_torch.ops import reconcile
from consul_tpu_torch.oracle import _coord_row
from consul_tpu_torch.parallel import mesh as meshlib
from consul_tpu_torch.utils import prng

# ---------------------------------------------------------------- rules

TOPOLOGY_KEYS = ("backend", "devices", "arch", "mesh_shape", "mesh_devices")


def topology_stamp(device, mesh=None) -> dict:
    """What a record was measured on: the backend, its devices, the card's
    architecture (None on the CPU) and, for a node-sharded entry, the
    mesh's block count and devices (None for one device)."""
    device = torch.device(device)
    arch = None
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        arch = f"sm_{major}{minor}"
    stamp = {"backend": device.type, "devices": 1, "arch": arch,
             "mesh_shape": None}
    if mesh is not None:
        stamp.update(devices=len(mesh.distinct),
                     mesh_shape={meshlib.NODE_AXIS: mesh.size},
                     mesh_devices=[str(d) for d in mesh.devices])
    return stamp


def tensors(x):
    """The tensors of a state: dataclass fields, tuples, lists and dicts
    walked in order; a node-sharded leaf (parallel/mesh.py) as one value,
    Blocks or Replicated."""
    if isinstance(x, (torch.Tensor, meshlib.Blocks, meshlib.Replicated)):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)


def bytes_per_slot(state, slots: int) -> int:
    """Dtype-width ledger: the bytes of every tensor of the state with a
    `slots` axis, per slot (hlo_audit.bytes_per_slot on the port's
    tensors)."""
    total = 0
    for t in tensors(state):
        if isinstance(t, meshlib.Blocks):    # the whole leaf, every block
            size = sum(p.numel() * p.element_size() for p in t.parts)
        else:                                # a tensor, or one copy
            t = t.home if isinstance(t, meshlib.Replicated) else t
            size = t.numel() * t.element_size()
        if slots in t.shape:
            total += size // slots
    return total


def leaf(x, path: str):
    """The tensor at a dotted path ("swim.sus_start", "lan.0.coords.adj_window")."""
    for part in path.split("."):
        x = x[int(part)] if part.isdigit() else getattr(x, part)
    return x


def page_elements(out) -> int:
    """Elements of the outputs a caller copies to the host."""
    return sum(math.prod(t.shape) for t in tensors(out))


def launch_counts() -> Dict[str, int]:
    """The wrappers' launch counts: every hand-written kernel, and K1's
    launches that carried each mode as "threefry_draws.<mode>"."""
    return {**kernels.LAUNCHES,
            **{f"threefry_draws.{m}": v
               for m, v in kernels.DRAW_LAUNCHES.items()}}


def flag_syncs() -> int:
    """The host reads the port counts itself: a probe tick's bulk flag and
    the federation bridge's table reads."""
    return swim.host_syncs + wan.host_syncs


@contextlib.contextmanager
def counting_syncs(box: dict):
    """Count the synchronizing CUDA calls of the block into box["syncs"]:
    torch's sync debug mode warns at each one."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield box
    finally:
        torch.cuda.set_sync_debug_mode("default")
    box["syncs"] = sum("synchroniz" in str(w.message) for w in caught)


def profiled_kernels(fn, make, reps: int = 5) -> dict:
    """{device kernel: launches per call} of fn on make()'s inputs
    (profile_tick.kernels_a_call: torch.profiler's records, copies and
    memsets left out), each rounded up: a capture may drop a record but
    never adds one."""
    from consul_tpu_torch import profile_tick
    counts = profile_tick.kernels_a_call(fn, reps, make=make)
    return {k: math.ceil(v - 1e-9) for k, v in sorted(counts.items())}


class RowCensus:
    """The gather law's measurement (the counterpart of
    parallel/mesh.py:full_gather_ops): every tensor an op makes inside
    the block, as the dispatcher hands it back, with its largest extent
    kept per device (`rows`); with `devices` only tensors on those.  The
    allocator's peak cannot tell B blocks on one card from one gathered
    leaf, so the law reads each made tensor's shape; the per-device peak
    bytes are recorded beside it (`peaks`, on the card)."""

    def __init__(self, devices=None):
        self.devices = None if devices is None else {
            str(torch.device(d)) for d in devices}
        self.rows: Dict[str, int] = {}
        self.peaks: Dict[str, int] = {}

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        census = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and t.dim() > 0:
                        dev = str(t.device)
                        if census.devices is None or dev in census.devices:
                            census.rows[dev] = max(census.rows.get(dev, 0),
                                                   max(t.shape))
                return out

        self._cards = sorted({d for d in (self.devices or ())
                              if d.startswith("cuda")})
        self._base = {}
        for d in self._cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
            self._base[d] = torch.cuda.memory_allocated(d)
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for d in self._cards:
            torch.cuda.synchronize(d)
            self.peaks[d] = torch.cuda.max_memory_allocated(d) - self._base[d]
        return False


def gather_law(rows: Dict[str, int], n_nodes: int) -> dict:
    """In a sharded call no device makes a tensor with n_nodes or more
    along any axis (a gathered [N] / [N, U] leaf, or a doubled [2N]
    ring buffer); the [U] tables, [B * k] candidates and pages stay far
    below it."""
    bad = {d: r for d, r in sorted(rows.items()) if r >= max(n_nodes, 2)}
    return {"ok": not bad, "rule": "gather", "n_nodes": n_nodes,
            "max_rows": dict(sorted(rows.items())), "gathered": bad}


# ------------------------------------------------------------- registry

@dataclasses.dataclass
class Call:
    """One form of an entry: `make()` builds the call's input outside the
    measured window (a clone where the call consumes its state on the
    card: the counterpart of the reference's `rebind`, so that every
    measured call starts from the same input), `fn(x)` is one call of the
    entry, `state_of(out)` the state whose `inplace` leaf paths must be
    the input's own tensors after the call."""
    make: Callable[[], Any]
    fn: Callable[[Any], Any]
    inplace: Tuple[str, ...] = ()
    state_of: Callable[[Any], Any] = lambda out: out


@dataclasses.dataclass
class Program:
    """One buildable entry point on one device: its forms (a probe and a
    gossip-only tick, a chunk, a read), the state the dtype ledger sums
    over with its slot count, and for a read entry `page`, the outputs of
    its first form a caller copies to the host."""
    forms: Dict[str, Call]
    n_nodes: int
    state: Any
    slots: int
    page: Optional[Callable[[Any], Any]] = None
    mesh: Any = None          # a node-sharded entry's mesh


@dataclasses.dataclass(frozen=True)
class EntrySpec:
    """A registered entry point: how to build its Program on a device at a
    scale of its node axis (1, or 2 for the O(page) rule), and the kernel
    launch sites (file, function, launcher) its measured calls reach, for
    registry parity.  Every entry holds its contracts on both
    TOPOLOGIES."""
    name: str
    build: Callable[[torch.device, int], Program]
    covers: Tuple[Tuple[str, str, str], ...]
    # a node-sharded entry: build(dev, scale, blocks) takes the block
    # count too, measured at SHARD_BLOCKS and at each of SCALING_BLOCKS
    sharded: bool = False


TOPOLOGIES = ("cpu", "cuda")
# the CPU's widths: the reference's bounded pool (hlo_audit._N) and slots
_N = 256
_U = 16
# the card's: PERF.md §4's configurations
_N_CARD = 1_000_000
_U_CARD = 32
_SEED = 7
# the sharded entries: N = 2^20 on the card (chip_smoke.py phase 15), its
# blocks (one card, or one block a card where there are that many), and
# the block counts the scaling law compares
_N_SHARDED_CARD = 1 << 20
SHARD_BLOCKS = 4
SCALING_BLOCKS = (1, 2, 4)

# K2 replaces these swim leaves with fresh tensors every tick
# (ops/gossip.disseminate_kernel); every other leaf a probe tick's
# kernels write stays the input's own tensor over the whole tick
GOSSIP_FRESH = ("know", "learn_tick", "sends_left", "ctr")
PROBE_TICK_INPLACE = tuple(dict.fromkeys(
    f for group in (swim.PROBE_INPLACE, swim.ORIGINATE_INPLACE,
                    swim.EXPIRY_INPLACE, swim.DENSE_INPLACE,
                    swim.REFUTE_INPLACE, swim.FREE_INPLACE,
                    swim.BULK_INPLACE)
    for f in group if f not in GOSSIP_FRESH))


def _serf_inplace(prefix: str = "") -> Tuple[str, ...]:
    """A serf probe tick's in-place leaves: the swim passes' and K13's."""
    return tuple(f"{prefix}swim.{f}" for f in PROBE_TICK_INPLACE) \
        + tuple(f"{prefix}coords.{f}" for f in vivaldi.RING_INPLACE)


def _card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _wan_clone(x: wan.WanState) -> wan.WanState:
    return x.replace(lan=tuple(c.clone() for c in x.lan), wan=x.wan.clone())


def _serf_bench(dev: torch.device, scale: int):
    """The bench's pool (bench.prepare): LAN gossip, 1% loss, seed 7, its
    warm scan with the victim monitored and the kill; then one tick more.
    (params, {"probe": the state at the kill, a probe tick; "gossip": the
    next, gossip-only, tick's}, victim).  At scale 2 a fresh pool: it only
    shapes the reads' outputs."""
    from consul_tpu_torch import bench
    card = _card(dev)
    params = serf.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=(_N_CARD if card else _N) * scale,
        rumor_slots=_U_CARD if card else _U, alloc_cap=8, p_loss=0.01,
        seed=_SEED))
    victim = bench.VICTIM if card else 3
    s = serf.init_state(params, device=dev)
    if scale != 1:
        return params, {"probe": s, "gossip": s}, victim
    s, _ = serf.run(params, s, bench.CHUNK if card else 20, victim)
    s = s.replace(swim=swim.kill(s.swim, victim))
    return params, {"probe": s, "gossip": serf.step(params, s.clone())}, \
        victim


def _tick_forms(step, at: dict, state_of=lambda out: out,
                inplace: Tuple[str, ...] = ()) -> Dict[str, Call]:
    """A gossip-only and a probe tick of `step`, each on a clone."""
    return {kind: Call(make=at[kind].clone, fn=step, state_of=state_of,
                       inplace=inplace if kind == "probe" else ())
            for kind in ("gossip", "probe")}


def _build_scan(dev: torch.device, scale: int) -> Program:
    """The bench's timed loop (bench.run_convergence): serf.run with the
    victim's believed-down fraction after every tick (K3), as one tick of
    each kind and a 10-tick chunk crossing two probe ticks."""
    params, at, victim = _serf_bench(dev, scale)
    forms = _tick_forms(lambda x: serf.run(params, x, 1, victim), at,
                        state_of=lambda out: out[0],
                        inplace=_serf_inplace())
    forms["chunk"] = Call(make=at["probe"].clone,
                          fn=lambda x: serf.run(params, x, 10, victim),
                          state_of=lambda out: out[0],
                          inplace=_serf_inplace())
    return Program(forms=forms, n_nodes=params.n_nodes, state=at["probe"],
                   slots=params.n_nodes)


def _build_step(dev: torch.device, scale: int) -> Program:
    """The oracle's tick (oracle.advance): serf.step, one of each kind."""
    params, at, _ = _serf_bench(dev, scale)
    return Program(forms=_tick_forms(lambda x: serf.step(params, x), at,
                                     inplace=_serf_inplace()),
                   n_nodes=params.n_nodes, state=at["probe"],
                   slots=params.n_nodes)


def _read(fn, page=lambda out: out, fixture=None):
    """The build function of a read entry over the bench's pool (or
    `fixture`'s): one form, the pool its input, outputs that stay on the
    device."""
    def build(dev: torch.device, scale: int) -> Program:
        params, s, extra = (fixture or _bench_read)(dev, scale)
        return Program(forms={"read": Call(make=lambda: s,
                                           fn=lambda x: fn(params, x, extra))},
                       n_nodes=params.n_nodes, state=s, slots=params.n_nodes,
                       page=page)
    return build


def _bench_read(dev: torch.device, scale: int):
    params, at, _ = _serf_bench(dev, scale)
    return params, at["probe"], None


def _oracle(dev: torch.device, scale: int):
    """The oracle's pool (chip_smoke.py phase 5): N - 1,000 joined on the
    card (N - 16 on the CPU), 10 ticks, a status checkpoint, three kills
    and 10 ticks more.  (params, state, {"prov", "prev", "ids", "rtt"})."""
    card = _card(dev)
    n = (_N_CARD if card else _N) * scale
    joined = n - (1000 if card else 16)
    params = serf.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=n, rumor_slots=_U_CARD if card else _U, alloc_cap=8,
        p_loss=0.01, seed=_SEED, n_initial=joined))
    s = serf.init_state(params, n_initial=joined, device=dev)
    s, _ = serf.run(params, s, 10)
    prev = serf.status_vector(params, s).clone()
    for v in (joined // 4, joined // 2, joined - 1):
        s = s.replace(swim=swim.kill(s.swim, v))
    s, _ = serf.run(params, s, 10)
    k = 1000 if card else 64      # sort_by_rtt over a list of k names
    extra = {"prov": torch.arange(n, device=dev) < joined, "prev": prev,
             "ids": torch.arange(n // 2, n // 2 + 128, dtype=torch.int32,
                                 device=dev),
             "rtt": (torch.arange(k, dtype=torch.int32, device=dev),
                     torch.ones(k, dtype=torch.bool, device=dev))}
    return params, s, extra


def _build_coord_row(dev: torch.device, scale: int) -> Program:
    """oracle._coord_row: one node's Vivaldi row."""
    params, s, _ = _oracle(dev, scale)
    return Program(forms={"read": Call(make=lambda: s.coords,
                                       fn=lambda c: _coord_row(c, 5))},
                   n_nodes=params.n_nodes, state=s.coords,
                   slots=params.n_nodes, page=lambda out: out)


def _build_chaos_swim(dev: torch.device, scale: int) -> Program:
    """chaos.compiled_swim_run's chunk in the nemesis build (chaos=True:
    K2's chaos mode): 10 ticks from the 25th, two probe ticks."""
    card = _card(dev)
    params = swim.make_params(GossipConfig.lan(), SimConfig(
        n_nodes=(_N_CARD if card else _N) * scale,
        rumor_slots=_U_CARD if card else _U, p_loss=0.01, seed=_SEED,
        chaos=True))
    s = swim.run(params, swim.init_state(params, device=dev), 25)[0]
    run = chaos.compiled_swim_run(params, 10)
    return Program(forms={"chunk": Call(
        make=s.clone, fn=run, state_of=lambda out: out[0],
        inplace=PROBE_TICK_INPLACE)}, n_nodes=params.n_nodes, state=s,
        slots=params.n_nodes)


def _correlated(dev: torch.device, scale: int):
    """The correlated bench's row at mid-drain (correlated.mid_drain): the
    1M, 1% row on the card; 256 nodes, 16 slots and 30% killed on the CPU,
    where 1% fills no bulk channel.  (params, {"gossip": a gossip-only
    tick's input, "probe": a probe tick's, both with the bulk channel
    live}, victim mask, K5's out slots)."""
    card = _card(dev)
    params = correlated.bench_params((_N_CARD if card else _N) * scale,
                                     _U_CARD if card else _U)
    frac = correlated.FRACTION if card else 0.3
    _, mask = correlated.start(params, frac, correlated.SEED, dev)
    s = correlated.mid_drain(params, dev, frac=frac)
    at = {}
    for _ in range(4 * params.probe_period_ticks):
        kind = "probe" if s.tick % params.probe_period_ticks == 0 \
            else "gossip"
        if kind not in at and s.bulk_live:
            at[kind] = s.clone()
        if len(at) == 2:
            break
        s = swim.step(params, s)
    else:
        raise RuntimeError("the bulk channel emptied after mid-drain")
    out = (torch.empty(1, dtype=torch.float32, device=dev),
           torch.empty(1, dtype=torch.int32, device=dev))
    return params, at, mask, out


def _build_correlated(dev: torch.device, scale: int) -> Program:
    """correlated.run_chunk, one tick of each kind with the bulk channel
    live (K14 on both), and K5 alone into the tick's slots."""
    params, at, mask, out = _correlated(dev, scale)
    forms = {kind: Call(make=at[kind].clone,
                        fn=lambda x: correlated.run_chunk(params, x, 1, mask),
                        state_of=lambda o: o[0],
                        inplace=PROBE_TICK_INPLACE if kind == "probe"
                        else swim.BULK_INPLACE)
             for kind in ("gossip", "probe")}
    forms["detect"] = Call(make=lambda: at["gossip"],
                           fn=lambda x: swim.mass_detection_stats(
                               params, x, mask, out=out))
    return Program(forms=forms, n_nodes=params.n_nodes, state=at["gossip"],
                   slots=params.n_nodes)


def _build_wan(dev: torch.device, scale: int) -> Program:
    """wan.run on one device (tools/scale_sweep.py's _dc_point: 3 DCs of
    50,000 nodes and 5 servers on the card, of 256 on the CPU), a tick of
    each kind: tick 21 is gossip-only in every pool, tick 20 a probe tick
    in every pool (LAN period 5, WAN 10)."""
    card = _card(dev)
    params = wan.make_params(3, (50_000 if card else _N) * scale, 5,
                             p_loss=0.01, seed=_SEED, rumor_slots=_U,
                             event_slots=_U)
    s = wan.run(params, wan.init_state(params, device=dev), 20)
    at = {"probe": s, "gossip": wan.step(params, _wan_clone(s))}
    pools = [f"lan.{d}." for d in range(params.n_dcs)] + ["wan."]
    inplace = tuple(p for pool in pools for p in _serf_inplace(pool))
    forms = {kind: Call(make=lambda s=at[kind]: _wan_clone(s),
                        fn=lambda x: wan.run(params, x, 1),
                        inplace=inplace if kind == "probe" else ())
             for kind in ("gossip", "probe")}
    n = params.lan.n_nodes
    return Program(forms=forms, n_nodes=n, state=at["probe"], slots=n)


def _ae(dev: torch.device, scale: int):
    """Anti-entropy at BASELINE.json's 1M services (chip_smoke.py phase 9:
    AEParams(100_000, 1_048_576, 60, seed 7)) on the card, 4,096 services
    over 256 agents on the CPU: every service registered and pushed, then
    one churn tick's commands (1,000 re-registrations and 100
    deregistrations on the card, 8 and 1 on the CPU).  Returns a dict of
    the params, the states before each command and the step, up, the
    batches and the step's masks."""
    card = _card(dev)
    agents, cap, services, rereg, dereg = (
        (100_000, 1_048_576, 1_000_000, 1000, 100) if card
        else (256, 4608, 4096, 8, 1))
    params = antientropy.AEParams(n_agents=agents * scale,
                                  capacity=cap * scale,
                                  sync_interval_ticks=60, seed=_SEED)
    rng = np.random.default_rng(_SEED)
    ids = rng.choice(2 ** 30, size=services * scale,
                     replace=False).astype(np.int32)
    owner = (np.arange(ids.size) % params.n_agents).astype(np.int32)
    ver = np.ones(ids.size, np.int32)
    up = torch.ones(params.n_agents, dtype=torch.bool, device=dev)
    s = antientropy.init_state(params, device=dev)
    s = antientropy.register_desired(s, ids, owner, ver)
    s = antientropy.step(params, s, up)
    pick = rng.choice(ids.size, size=rereg + dereg, replace=False)
    reg, gone = pick[:rereg], pick[rereg:]
    batch = (ids[reg], owner[reg], ver[reg] + 1)
    registered = antientropy.register_desired(s, *batch)
    dereg_ids = ids[gone]
    before_step = antientropy.deregister_desired(registered, dereg_ids)
    _, _, push, drop = antientropy.sync_masks(params, before_step, up)
    return {"params": params, "synced": s, "registered": registered,
            "batch": batch, "dereg_ids": dereg_ids, "step": before_step,
            "up": up, "push": push, "drop": drop}


def _ae_program(ae: dict, forms: Dict[str, Call]) -> Program:
    """Anti-entropy's slot is a row of its service tables."""
    cap = ae["params"].capacity
    return Program(forms=forms, n_nodes=ae["params"].n_agents,
                   state=ae["step"], slots=cap)


def _build_ae_step(dev: torch.device, scale: int) -> Program:
    """antientropy.step after a churn tick's commands (K6's diff in its
    step's form, its merge, K1's jitter), and K6's merge alone on the
    step's masks."""
    ae = _ae(dev, scale)
    p, up, push, drop = ae["params"], ae["up"], ae["push"], ae["drop"]
    return _ae_program(ae, {
        "step": Call(make=lambda: ae["step"],
                     fn=lambda x: antientropy.step(p, x, up)),
        "merge": Call(make=lambda: ae["step"],
                      fn=lambda x: reconcile.merge(
                          x.d_ids, x.d_ver, x.d_node, x.a_ids, x.a_ver,
                          x.a_node, push, drop))})


def _build_ae_register(dev: torch.device, scale: int) -> Program:
    """antientropy.register_desired of a churn tick's re-registrations,
    host arrays as the agent hands them over."""
    ae = _ae(dev, scale)
    return _ae_program(ae, {"command": Call(
        make=lambda: ae["synced"],
        fn=lambda x: antientropy.register_desired(x, *ae["batch"]))})


def _build_ae_deregister(dev: torch.device, scale: int) -> Program:
    """antientropy.deregister_desired of a churn tick's deregistrations."""
    ae = _ae(dev, scale)
    return _ae_program(ae, {"command": Call(
        make=lambda: ae["registered"],
        fn=lambda x: antientropy.deregister_desired(x, ae["dereg_ids"]))})


def _build_vivaldi(dev: torch.device, scale: int) -> Program:
    """The standalone Vivaldi solver (scenarios.vivaldi_converge): 100,000
    nodes and 8 dimensions on the card, 256 on the CPU; sim_step at tick
    5 from the state after ticks 0-4."""
    n = (100_000 if _card(dev) else _N) * scale
    params = vivaldi.VivaldiParams(n_nodes=n, dims=8, seed=_SEED)
    true = prng.uniform(prng.PRNGKey(_SEED), (n, 2), dev) * 0.060
    s = vivaldi.init_state(params, device=dev)
    for t in range(5):
        s = vivaldi.sim_step(params, true, s, t)
    return Program(forms={"tick": Call(
        make=lambda: s, fn=lambda x: vivaldi.sim_step(params, true, x, 5))},
        n_nodes=n, state=s, slots=n)


def _shard_mesh(dev: torch.device, blocks: int):
    """`blocks` blocks on the card (one a card where there are that many),
    or on the CPU."""
    if _card(dev) and torch.cuda.device_count() >= blocks > 1:
        return meshlib.make_mesh([torch.device("cuda", i)
                                  for i in range(blocks)])
    return meshlib.make_mesh([dev] * blocks)


def _sharded_pool(dev: torch.device, scale: int, chaos_build: bool = False):
    """chip_smoke.py phase 15's pool, unsharded: N = 2^20, U = 32 on the
    card (256 and 16 on the CPU), LAN gossip, 1% loss, seed 7; 20 ticks, a
    kill, ticks to 31 (a gossip tick) and a user event fired; with
    `chaos_build` the swim pool of the nemesis build, its groups and rates
    set at tick 20.  (params, state, victim)."""
    card = _card(dev)
    n = (_N_SHARDED_CARD if card else _N) * scale
    sim = SimConfig(n_nodes=n, rumor_slots=_U_CARD if card else _U,
                    alloc_cap=8, p_loss=0.01, seed=_SEED, chaos=chaos_build,
                    shard_blocks=SHARD_BLOCKS)
    victim = 123_457 % n if card else 3
    if chaos_build:
        p = swim.make_params(GossipConfig.lan(), sim)
        s = swim.run(p, swim.init_state(p, device=dev), 20)[0]
        s = swim.kill(s, victim)
        gen = torch.Generator(device=dev)
        gen.manual_seed(17)
        r = torch.rand(n, generator=gen, device=dev)
        s = s.replace(chaos_grp=(r < 0.25).to(torch.int16),
                      chaos_ok=torch.where(r > 0.9, 0.6, 1.0).to(
                          torch.float32))
        return p, swim.run(p, s, 11)[0], victim
    p = serf.make_params(GossipConfig.lan(), sim)
    s, _ = serf.run(p, serf.init_state(p, device=dev), 20)
    s = s.replace(swim=swim.kill(s.swim, victim))
    s, _ = serf.run(p, s, 11)
    return p, serf.fire_event(p, s, 5, 1), victim


def _build_step_sharded(dev: torch.device, scale: int,
                        blocks: int = SHARD_BLOCKS) -> Program:
    """serf.step on the node-sharded pool: a probe tick with the victim's
    monitor after it (every probe pass's block form, K13's, K1's block
    draws, K2 and K3 over block tables), a gossip tick with a rumor and a
    user event in flight; swim.step of the nemesis build's pool at a
    probe tick and a gossip tick (K7's and K2's chaos modes).  A probe
    tick consumes its input on the card, so its calls take clones; a
    gossip tick leaves its input as it was.  The probe tick comes first:
    the block-scaling law measures it."""
    m = _shard_mesh(dev, blocks)
    params, s, victim = _sharded_pool(dev, scale)
    cp, cs, _ = _sharded_pool(dev, scale, chaos_build=True)
    from consul_tpu_torch.profile_tick import next_probe_tick
    period = params.swim.probe_period_ticks
    ps = next_probe_tick(lambda x: serf.step(params, x), period, s)
    cps = next_probe_tick(lambda x: swim.step(cp, x), period, cs)
    sh, csh, psh, cpsh = (meshlib.shard_state(x, m)
                          for x in (s, cs, ps, cps))
    return Program(forms={
        "probe": Call(make=psh.clone,
                      fn=lambda x: serf.run(params, x, 1, victim),
                      state_of=lambda out: out[0], inplace=_serf_inplace()),
        "gossip": Call(make=lambda: sh,
                       fn=lambda x: serf.run(params, x, 1, victim),
                       state_of=lambda out: out[0]),
        "chaos_probe": Call(make=cpsh.clone, fn=lambda x: swim.step(cp, x),
                            inplace=PROBE_TICK_INPLACE),
        "chaos": Call(make=lambda: csh, fn=lambda x: swim.step(cp, x))},
        n_nodes=params.n_nodes, state=sh, slots=params.n_nodes, mesh=m)


def _build_reads_sharded(dev: torch.device, scale: int,
                         blocks: int = SHARD_BLOCKS) -> Program:
    """The sharded oracle's reads (GossipOracle(mesh=...)): the summary,
    a delta against a checkpoint with members moved, a page; K4's scan,
    combine, emit and page over block tables."""
    m = _shard_mesh(dev, blocks)
    params, s, _ = _sharded_pool(dev, scale)
    n = params.n_nodes
    card = _card(dev)
    prov = torch.arange(n, device=dev) < n - (1000 if card else 16)
    st = serf.status_vector(params, s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(_SEED)
    flip = torch.rand(n, generator=gen, device=dev) < 0.01
    prev = torch.where(flip, (st + 1) % 3, st).to(torch.int8)
    sh = meshlib.shard_state(s, m)
    bprov, bprev = (meshlib.shard_state(x, m, n) for x in (prov, prev))
    # k well below L: the [B * k] candidates of the twin's top-k stay
    # below N at the CPU's 256 nodes in 4 blocks too
    k = 256 if card else 32
    ids = torch.arange(n // 2, n // 2 + (128 if card else 32),
                       dtype=torch.int32, device=dev)
    sp = params.swim
    return Program(forms={
        "summary": Call(make=lambda: sh, fn=lambda x: swim.membership_counts(
            sp, x.swim, bprov)),
        "delta": Call(make=lambda: sh, fn=lambda x: swim.membership_delta(
            sp, x.swim, bprev, bprov, k)[1:]),
        "page": Call(make=lambda: sh, fn=lambda x: swim.membership_page(
            sp, x.swim, ids))},
        n_nodes=n, state=sh, slots=n, page=lambda out: out, mesh=m)


_SWIM = "consul_tpu_torch/models/swim.py"
_DRAW = ("consul_tpu_torch/utils/prng.py", "draw", "launch_draws")
_GOSSIP = ("consul_tpu_torch/ops/gossip.py", "disseminate_kernel",
           "launch_gossip")
_RING = ("consul_tpu_torch/models/vivaldi.py", "observe_ring",
         "launch_vivaldi_ring")
# the launch sites of a probe tick's swim passes
_PROBE_SITES = tuple((_SWIM, fn, f"launch_{k}") for fn, k in (
    ("_maps", "subject_maps"), ("_map_add", "map_add"),
    ("_maps_convert", "maps_convert"), ("_probe_pass", "probe_round"),
    ("_originate", "originate"), ("_suspicion_expiry", "suspicion_expiry"),
    ("_dense_suspicion_expiry", "dense_expiry"),
    ("_dense_suspicion_expiry", "dense_expiry_post"),
    ("_refutation", "refutation"), ("_expire", "expire")))
_SWIM_TICK = (_DRAW, _GOSSIP) + _PROBE_SITES
# the launch sites of a sharded probe tick's swim passes (their block forms)
_BLOCK_SITES = tuple(("consul_tpu_torch/models/swim_blocks.py",
                      f"kernel_{fn}", f"launch_{k}_blocks") for fn, k in (
    ("maps", "subject_maps"), ("map_add", "map_add"),
    ("maps_convert", "maps_convert"), ("probe_pass", "probe_round"),
    ("originate", "originate"), ("suspicion_expiry", "suspicion_expiry"),
    ("dense_expiry", "dense_expiry"), ("dense_expiry", "dense_expiry_post"),
    ("refutation", "refutation"), ("expire", "expire")))
_SERF_TICK = _SWIM_TICK + (_RING,)
_MONITOR = (_SWIM, "believed_down_fraction", "launch_believed_down")
_SCAN = (_SWIM, "_scan", "launch_members_scan")
_RECONCILE = "consul_tpu_torch/ops/reconcile.py"

REGISTRY: Tuple[EntrySpec, ...] = (
    EntrySpec("serf.scan", _build_scan,
              covers=_SERF_TICK + (_MONITOR,)),
    EntrySpec("serf.step", _build_step, covers=_SERF_TICK),
    EntrySpec("serf.metrics",
              _read(lambda p, s, _: serf.metrics_vector(p, s)),
              covers=()),
    # its [N] status stays on the device for the caller to page or
    # reduce: no page of it is read back, so the O(page) rule has nothing
    # to hold (the reads that do are the oracle's entries below)
    EntrySpec("serf.status_vector",
              _read(lambda p, s, _: serf.status_vector(p, s), page=None),
              covers=(_SCAN,)),
    EntrySpec("serf.shard_metrics",
              _read(lambda p, s, _: serf.shard_metrics(p, s, 8)),
              covers=()),
    EntrySpec("oracle.membership_counts",
              _read(lambda p, s, e: serf.membership_counts(p, s, e["prov"]),
                    fixture=_oracle), covers=(_SCAN,)),
    # the new status [N] is the next checkpoint and stays on the device
    EntrySpec("oracle.membership_delta",
              _read(lambda p, s, e: serf.membership_delta(
                  p, s, e["prev"], e["prov"], 256), page=lambda out: out[1:],
                  fixture=_oracle),
              covers=(_SCAN, (_SWIM, "membership_delta",
                              "launch_members_emit"))),
    EntrySpec("oracle.membership_page",
              _read(lambda p, s, e: serf.membership_page(p, s, e["ids"]),
                    fixture=_oracle),
              covers=((_SWIM, "membership_page", "launch_members_page"),)),
    EntrySpec("oracle.rtt_order",
              _read(lambda p, s, e: serf.rtt_order(p, s, 0, *e["rtt"]),
                    fixture=_oracle), covers=()),
    EntrySpec("oracle.coord_row", _build_coord_row, covers=()),
    EntrySpec("chaos.swim_run", _build_chaos_swim,
              covers=_SWIM_TICK),
    EntrySpec("correlated.tick", _build_correlated,
              covers=_SWIM_TICK + (
                  (_SWIM, "_bulk_step", "launch_bulk_step"),
                  (_SWIM, "mass_detection_stats", "launch_mass_detect"))),
    EntrySpec("wan.run", _build_wan, covers=_SERF_TICK),
    EntrySpec("antientropy.step", _build_ae_step,
              covers=(_DRAW,
                      (_RECONCILE, "diff_sorted_kernel",
                       "launch_reconcile_diff"),
                      (_RECONCILE, "merge_kernel", "launch_reconcile_merge"))),
    EntrySpec("antientropy.register_desired", _build_ae_register,
              covers=()),
    EntrySpec("antientropy.deregister_desired", _build_ae_deregister,
              covers=()),
    EntrySpec("vivaldi.sim_step", _build_vivaldi,
              covers=(_DRAW,)),
    EntrySpec("serf.step.sharded", _build_step_sharded,
              covers=(("consul_tpu_torch/ops/gossip.py",
                       "disseminate_blocks_kernel", "launch_gossip_blocks"),
                      (_SWIM, "believed_down_fraction",
                       "launch_believed_down_blocks"),
                      ("consul_tpu_torch/utils/prng.py", "draw_blocks",
                       "launch_draws"),
                      ("consul_tpu_torch/models/vivaldi.py",
                       "_observe_ring_blocks", "launch_vivaldi_ring_blocks"))
              + _BLOCK_SITES,
              sharded=True),
    EntrySpec("oracle.reads.sharded", _build_reads_sharded,
              covers=((_SWIM, "_scan_blocks", "launch_members_scan_blocks"),
                      (_SWIM, "_scan_blocks", "launch_members_combine"),
                      (_SWIM, "membership_delta",
                       "launch_members_emit_blocks"),
                      (_SWIM, "membership_page",
                       "launch_members_page_blocks")),
              sharded=True),
)

# kernel launch sites under consul_tpu_torch/ that no registry entry
# reaches, each with its reason (a stale one fails the parity check)
SUPPRESSED_LAUNCH_SITES: Dict[Tuple[str, str, str], str] = {}


def registry_parity(sites: List[Tuple[str, str, str]]) -> dict:
    """Every scanned `kernels.launch_*` call site must be covered by a
    registry entry or suppressed with a reason; covers and suppressions
    naming a site that no longer exists are stale and fail too.  `sites`
    comes from kernel_lint's AST scan: this stays pure so tests can
    fabricate it."""
    scanned = {tuple(s) for s in sites}
    covered = {c for spec in REGISTRY for c in spec.covers}
    suppressed = set(SUPPRESSED_LAUNCH_SITES)
    uncovered = sorted(scanned - covered - suppressed)
    stale = sorted((covered | suppressed) - scanned)
    return {"ok": not uncovered and not stale, "sites": len(scanned),
            "uncovered": [list(s) for s in uncovered],
            "stale": [list(s) for s in stale]}


def launch_coverage(records: Dict[str, dict]) -> dict:
    """Every hand-written kernel (kernels.KERNELS) launched by at least one
    measured call of some entry (the card's records)."""
    launched = {k for rec in records.values()
                for form in (rec.get("forms") or {}).values()
                for k, v in (form.get("launches") or {}).items() if v}
    missing = [k for k in kernels.KERNELS if k not in launched]
    return {"ok": not missing, "missing": missing}


# ---------------------------------------------------------- measurement

def _fence(dev: torch.device) -> None:
    if _card(dev):
        torch.cuda.synchronize(dev)


def _pointers(x) -> tuple:
    """A leaf's data pointers: its blocks', its copies', or its own."""
    return tuple(t.data_ptr() for t in swim._pieces(x))


def _one_call(call: Call, dev: torch.device, mesh=None) -> dict:
    """One measured call: its launches, flag reads, and on the card its
    synchronizing calls, allocations, peak bytes and in-place leaves; on a
    sharded entry's mesh also the largest tensor it made on each device
    (the gather law's `max_rows`) and each card's peak bytes."""
    card = _card(dev)
    x = call.make()
    ptrs = {p: _pointers(leaf(x, p)) for p in call.inplace}
    _fence(dev)
    launches0, flags0 = launch_counts(), flag_syncs()
    rec: Dict[str, Any] = {"syncs": None, "allocations": None,
                           "peak_bytes": None, "inplace": None}
    census = RowCensus(mesh.devices) if mesh is not None \
        else contextlib.nullcontext()
    if card:
        allocs0 = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
        box: dict = {}
        with counting_syncs(box):
            with census:
                out = call.fn(x)
        torch.cuda.synchronize(dev)
        state = call.state_of(out)
        rec.update(
            syncs=box["syncs"],
            allocations=torch.cuda.memory_stats(dev)[
                "allocation.all.allocated"] - allocs0,
            peak_bytes=torch.cuda.max_memory_allocated(dev) - mem0,
            inplace={"leaves": len(ptrs), "moved": sorted(
                p for p, ptr in ptrs.items()
                if _pointers(leaf(state, p)) != ptr)})
    else:
        with census:
            out = call.fn(x)
    if mesh is not None:
        rec["max_rows"] = dict(sorted(census.rows.items()))
        rec["device_peak_bytes"] = census.peaks or None
    after = launch_counts()
    rec["launches"] = {k: v - launches0[k] for k, v in after.items()
                       if v != launches0[k]}
    rec["flag_syncs"] = flag_syncs() - flags0
    del out
    return rec


def measure_call(call: Call, dev: torch.device, reps: int = 5,
                 mesh=None) -> dict:
    """Two warm calls (the library's build, the kernels' per-device
    scratch, first-use allocations), two measured calls one after the
    other on the current stream, then on the card the profiler's census
    of `reps` calls."""
    for _ in range(2):
        call.fn(call.make())
    _fence(dev)
    first = _one_call(call, dev, mesh)
    second = _one_call(call, dev, mesh)
    first["repeat_same"] = all(first[k] == second[k] for k in (
        "launches", "allocations", "flag_syncs"))
    first["kernels"] = profiled_kernels(call.fn, call.make, reps) \
        if _card(dev) else None
    first["device_kernels"] = None if first["kernels"] is None \
        else sum(first["kernels"].values())
    return first


def measure_entry(spec: EntrySpec, device, reps: int = 5) -> dict:
    """Build one entry on `device` and measure every number the rules
    judge: each form's calls, the state's bytes per slot, and for a read
    entry its outputs' size at N and at 2N."""
    dev = torch.device(device)
    prog = spec.build(dev, 1)
    record = {"topology": topology_stamp(dev, prog.mesh),
              "n_nodes": prog.n_nodes,
              "bytes_per_slot": bytes_per_slot(prog.state, prog.slots),
              "forms": {form: measure_call(call, dev, reps, prog.mesh)
                        for form, call in prog.forms.items()},
              "page_elements": None}
    if prog.page is not None:
        sizes = []
        for p in (prog, spec.build(dev, 2)):
            call = next(iter(p.forms.values()))
            sizes.append(page_elements(p.page(call.fn(call.make()))))
        record["page_elements"] = sizes
    record["library_loads"] = kernels.LIBRARY_LOADS if _card(dev) else None
    if spec.sharded:
        record["scaling"] = measure_scaling(spec, dev)
    return record


def measure_scaling(spec: EntrySpec, dev: torch.device) -> dict:
    """A sharded entry's first form at each of SCALING_BLOCKS blocks (one
    warm call, one measured): {B: its hand-written launches, the largest
    tensor it made and the pool's N}, judge_scaling's input."""
    out = {}
    for blocks in SCALING_BLOCKS:
        prog = spec.build(dev, 1, blocks)
        call = next(iter(prog.forms.values()))
        call.fn(call.make())
        _fence(dev)
        rec = _one_call(call, dev, prog.mesh)
        out[str(blocks)] = {"launches": rec["launches"],
                            "max_rows": max(rec["max_rows"].values(),
                                            default=0),
                            "n_nodes": prog.n_nodes}
    return out


# ---------------------------------------------------------------- judge

def _judge_form(form: str, run: dict, base: dict, tolerance: float, fail,
                n_nodes: Optional[int] = None):
    got, want = run.get("launches") or {}, base.get("launches") or {}
    if got != want:
        diff = {k: [got.get(k, 0), want.get(k, 0)]
                for k in sorted(set(got) | set(want))
                if got.get(k, 0) != want.get(k, 0)}
        fail("launch-count", f"{form}: launches [run, budget] {diff}")
    if run.get("kernels") is not None and base.get("kernels") is not None:
        for name, n in sorted(run["kernels"].items()):
            budget = base["kernels"].get(name)
            if budget is None:
                fail("kernel-family", f"{form}: unexpected device kernel "
                     f"{name[:160]} x{n} (absent from the budget)")
            elif n > budget:
                fail("kernel-census", f"{form}: {name[:160]} x{n} > budget "
                     f"{budget}")
    for key in ("syncs", "flag_syncs"):
        rv, bv = run.get(key), base.get(key)
        if rv is not None and bv is not None and rv > bv:
            fail("host-sync", f"{form}: {key} {rv} > budget {bv}")
    rows = run.get("max_rows")
    if rows is not None and n_nodes is not None:
        law = gather_law(rows, n_nodes)
        if not law["ok"]:
            fail("gather", f"{form}: made a tensor of {law['gathered']} "
                 f"rows of an N = {n_nodes} pool on a sharded call")
    moved = (run.get("inplace") or {}).get("moved")
    if moved:
        fail("in-place", f"{form}: leaves not updated in place: {moved}")
    rv, bv = run.get("allocations"), base.get("allocations")
    if rv is not None and bv is not None and rv > bv:
        fail("allocations", f"{form}: {rv} allocations > budget {bv}")
    rv, bv = run.get("peak_bytes"), base.get("peak_bytes")
    if rv is not None and bv is not None and abs(rv - bv) > tolerance * bv:
        fail("peak-bytes", f"{form}: peak {rv} B outside ±{tolerance:.0%} "
             f"of budget {bv} B")
    if run.get("repeat_same") is False:
        fail("one-build", f"{form}: the second measured call launched or "
             f"allocated other than the first")


def judge_record(run: dict, base: dict, tolerance: float) -> dict:
    """Judge one measured record against its committed budget.  A topology
    stamp mismatch refuses (verdict "topology") rather than judging: a
    card's budget never gates a CPU record or another card's; re-baseline
    on the new topology instead (kernel_lint --update-baseline)."""
    rt = run.get("topology") or {}
    bt = base.get("topology") or {}
    if bt and rt and any(rt.get(k) != bt.get(k) for k in TOPOLOGY_KEYS):
        return {"ok": False, "verdict": "topology", "failures": [],
                "baseline_topology": bt, "run_topology": rt}
    fails: List[dict] = []

    def fail(rule, detail):
        fails.append({"rule": rule, "detail": detail})

    bps, base_bps = run.get("bytes_per_slot"), base.get("bytes_per_slot")
    if bps is not None and base_bps is not None and bps > base_bps:
        fail("bytes-per-slot", f"state widened to {bps} B/slot (budget "
             f"{base_bps})")
    page = run.get("page_elements")
    if page and page[0] != page[1]:
        fail("host-transfer", f"a read's outputs grow with N: {page[0]} "
             f"elements at N, {page[1]} at 2N")
    if run.get("library_loads") not in (None, 1):
        fail("one-build", f"the kernel library was loaded "
             f"{run['library_loads']} times (want once a process)")
    base_forms = base.get("forms") or {}
    for form, rec in sorted((run.get("forms") or {}).items()):
        if form not in base_forms:
            fail("form", f"{form}: no budget for this form")
            continue
        _judge_form(form, rec, base_forms[form], tolerance, fail,
                    run.get("n_nodes"))
    return {"ok": not fails, "verdict": "ok" if not fails else "violation",
            "failures": fails}


def judge_scaling(records_by_blocks: Dict[str, dict],
                  tolerance: float) -> dict:
    """The block-scaling law across one sharded entry's records at B = 1,
    2, 4 (measure_scaling), the counterpart of the reference's permute
    law.  Each block runs its own launches of each kernel, so the
    per-block kernels' launches over B must not grow with B (a rotation
    regressing to O(B^2) launches would): one-sided against the smallest
    B, shrinking is never a violation.  And no tensor the call makes may
    outgrow one block: its largest extent times B over N stays within
    1 + tolerance at every B (a gathered [N] leaf makes it B).  Fewer
    than two block counts: nothing to judge."""
    ratios: Dict[str, Dict[str, float]] = {"launches_per_block": {},
                                           "rows_times_blocks": {}}
    for b, rec in (records_by_blocks or {}).items():
        if not str(b).isdigit():
            continue
        blocks = int(b)
        per_block = sum(v for k, v in (rec.get("launches") or {}).items()
                        if k.endswith("_blocks"))
        ratios["launches_per_block"][str(blocks)] = per_block / blocks
        ratios["rows_times_blocks"][str(blocks)] = \
            rec.get("max_rows", 0) * blocks / max(rec.get("n_nodes", 1), 1)
    if len(ratios["launches_per_block"]) < 2:
        return {"ok": True, "rule": "block-scaling", "ratios": {},
                "note": "needs >=2 sharded topologies"}
    by_b = ratios["launches_per_block"]
    ref = by_b[min(by_b, key=int)]
    growth = max(by_b.values()) / max(ref, 1e-9) if ref else \
        (0.0 if not max(by_b.values()) else math.inf)
    widest = max(ratios["rows_times_blocks"].values())
    ok = growth <= 1.0 + tolerance and widest <= 1.0 + tolerance
    return {"ok": ok, "rule": "block-scaling",
            "ratios": {k: {b: round(r, 4) for b, r in v.items()}
                       for k, v in ratios.items()},
            "launch_growth": round(growth, 3),
            "widest_block_share": round(widest, 4)}
