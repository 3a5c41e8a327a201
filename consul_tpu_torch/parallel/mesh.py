"""Device mesh and node-axis sharding of the simulator state (the port of
consul_tpu/parallel/mesh.py).

The JAX package shards the node axis of every [N] / [N, U] tensor over a
1-D `jax.sharding.Mesh` and lets GSPMD insert the collectives.  Here a
mesh is an ordered tuple of B `torch.device`s, which may name one card B
times (or the CPU), and the node axis is cut into B contiguous blocks of
L = N / B rows: block b holds rows [bL, (b + 1)L) on `mesh.devices[b]`,
each block its own allocation even when every block sits on one card.
Kernels read any row through a block table (B base pointers and L), so
the same launches run on one card and across cards with peer access
(`kernels.enable_peer_access`, asked once per pair of distinct cards).

A node-sharded leaf is a `Blocks` value; a replicated leaf (the rumor
and event tables, the counters) a `Replicated` value, one copy per
distinct device of the mesh, the copies kept equal.  `cpu_devices` has no
counterpart: torch needs no process-wide inflation of devices, since a
mesh may list the CPU or one card as often as it likes.  The gather law
(the counterpart of `full_gather_ops`: no device allocates a buffer with
N or more rows of a node-axis leaf in a sharded call) lives with the
other program contracts in parallel/kernel_audit.py.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

NODE_AXIS = "nodes"
DC_AXIS = "dc"

# queue A item 3b-ii of ROADMAP.md: what a sharded pool does not run yet
NOT_YET = ("on a sharded state the ticks, the reads, kill, revive and the "
           "metrics run; the bulk channel (K14), mass-event detection (K5), "
           "the correlated bench and the oracle's leave, spawn, fire_event, "
           "rtt and event_coverage are ROADMAP queue A item 3b-ii")


class BulkChannelLive(NotImplementedError):
    """A tick of a sharded pool whose bulk channel is live (NOT_YET).
    `state` is the pool as the refusal leaves it, for the caller to keep
    in place of the state it passed (which a probe tick consumes on the
    card): the state it was given when the tick starts with the channel
    live, or the state after the probe passes of the tick that filled it
    (its tick not advanced, bulk_live set), which every later tick
    refuses before anything runs."""

    def __init__(self, message: str, state):
        super().__init__(message)
        self.state = state


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices over the node axis."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (NODE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {NODE_AXIS: self.size}

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def home(self) -> torch.device:
        """Where replicated outputs (counters, pages, monitors) land."""
        return self.devices[0]


def make_mesh(devices: Optional[Iterable] = None) -> Mesh:
    """A mesh over `devices` (torch devices or their names), by default
    every visible card; a caller may list one card B times, or
    ["cpu"] * B."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; list "
                               "the devices (e.g. ['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devs))


def _refuse(what: str):
    raise TypeError(f"{what} of a sharded leaf would gather its blocks onto "
                    f"one device; work block by block (Blocks.parts) or "
                    f"call unshard_state outside a step")


class Blocks:
    """A node-axis leaf cut into B blocks: `parts[b]` holds rows
    [bL, (b + 1)L) on its own device.  It is no tensor and no sequence:
    torch functions, numpy and iteration refuse it, so nothing
    concatenates it onto one device by accident."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        parts = tuple(parts)
        if not parts or any(not isinstance(p, torch.Tensor) for p in parts):
            raise TypeError("Blocks takes one or more tensors")
        rows = parts[0].shape[0]
        if any(p.shape[0] != rows or p.shape[1:] != parts[0].shape[1:]
               or p.dtype != parts[0].dtype for p in parts):
            raise ValueError("Blocks: every block needs the same shape and "
                             "dtype")
        self.parts = parts

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        _refuse(f"torch's {getattr(func, '__name__', func)}")

    def __array__(self, *args, **kwargs):
        _refuse("numpy's conversion")

    def __iter__(self):
        _refuse("iteration")

    @property
    def n_blocks(self) -> int:
        return len(self.parts)

    @property
    def rows(self) -> int:
        """L: the rows of one block."""
        return self.parts[0].shape[0]

    @property
    def shape(self) -> tuple:
        return (self.n_blocks * self.rows,) + tuple(self.parts[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    @property
    def device(self) -> torch.device:
        """The first block's device, the mesh's home."""
        return self.parts[0].device

    @property
    def is_cuda(self) -> bool:
        return self.parts[0].is_cuda

    def map(self, fn, *others) -> "Blocks":
        """Blocks(fn(part, other parts...)) block by block: the others are
        Blocks (their block b), Replicated (the copy on block b's device)
        or anything else (passed as it is)."""
        return Blocks(fn(p, *(_block(o, b, p.device) for o in others))
                      for b, p in enumerate(self.parts))

    def clone(self) -> "Blocks":
        return Blocks(p.clone() for p in self.parts)

    def __repr__(self) -> str:
        return (f"Blocks({self.n_blocks} x {tuple(self.parts[0].shape)} "
                f"{self.dtype} on {[str(d) for d in self.devices]})")


class Replicated:
    """A leaf every device of a mesh holds whole: one copy per distinct
    device (`copies`, in the mesh's order), kept equal."""

    __slots__ = ("copies",)

    def __init__(self, copies):
        copies = tuple(copies)
        if not copies or any(not isinstance(c, torch.Tensor) for c in copies):
            raise TypeError("Replicated takes one or more tensors")
        self.copies = copies

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError("a Replicated leaf takes torch functions copy by "
                        "copy: use .on(device) or .map(fn)")

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        for c in self.copies:
            if c.device == device:
                return c
        raise KeyError(f"no copy on {device}")

    @property
    def home(self) -> torch.Tensor:
        return self.copies[0]

    @property
    def shape(self) -> tuple:
        return tuple(self.copies[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.copies[0].dtype

    @property
    def device(self) -> torch.device:
        return self.copies[0].device

    @property
    def is_cuda(self) -> bool:
        return self.copies[0].is_cuda

    def map(self, fn, *others) -> "Replicated":
        return Replicated(fn(c, *(_copy(o, c.device) for o in others))
                          for c in self.copies)

    def clone(self) -> "Replicated":
        return Replicated(c.clone() for c in self.copies)

    @staticmethod
    def of(x: torch.Tensor, devices) -> "Replicated":
        """x copied onto each of `devices` (distinct), each copy its own."""
        return Replicated(x.to(d, copy=True) for d in devices)

    def __repr__(self) -> str:
        return (f"Replicated({tuple(self.copies[0].shape)} {self.dtype} on "
                f"{[str(c.device) for c in self.copies]})")


def _block(x, b: int, device):
    if isinstance(x, Blocks):
        return x.parts[b]
    if isinstance(x, Replicated):
        return x.on(device)
    return x


def _copy(x, device):
    if isinstance(x, Replicated):
        return x.on(device)
    return x


def is_sharded(x) -> bool:
    return isinstance(x, (Blocks, Replicated))


def mesh_of(b: Blocks) -> Mesh:
    return Mesh(b.devices)


# ------------------------------------------------------------- placement

def _node_shardable(dim: int, n_shards: int) -> bool:
    """One predicate for 'this axis is the node axis': divisible AND
    large relative to the shard count (mesh.py:231-235)."""
    return dim % n_shards == 0 and dim >= 4 * n_shards


def _n_nodes(state) -> int:
    """N of a swim, serf, event or Vivaldi state: the leading extent of
    its first [N] leaf."""
    for name in ("up", "lamport", "height"):
        v = getattr(state, name, None)
        if v is not None:
            return v.shape[0]
    if hasattr(state, "swim"):
        return _n_nodes(state.swim)
    raise TypeError(f"no node axis known for {type(state).__name__}")


def _leaf_spec(leaf: torch.Tensor, n: int, n_shards: int) -> tuple:
    if leaf.dim() >= 1 and leaf.shape[0] == n and _node_shardable(n, n_shards):
        return (NODE_AXIS,)
    return ()


def state_sharding(state, mesh: Mesh, n_nodes: Optional[int] = None):
    """The placement of every tensor leaf: the state's dataclass with each
    tensor replaced by its partition spec, (NODE_AXIS,) for a leaf that
    leads with the node axis when `_node_shardable(N, B)`, () for a
    replicated one.  The JAX package applies the predicate to every
    leaf's leading extent, so it also shards a [U] or [E] table whose
    size happens to pass it; the port keeps every table whole (its
    kernels read the table whole on each device) and shards only leaves
    whose leading extent is N.  A bare tensor gets its spec."""
    n = n_nodes if n_nodes is not None else _n_nodes(state)
    if isinstance(state, torch.Tensor):
        return _leaf_spec(state, n, mesh.size)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: state_sharding(getattr(state, f.name), mesh, n)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(state, f.name))})
    raise TypeError(f"state_sharding: {type(state).__name__}")


def _place(leaf: torch.Tensor, spec: tuple, mesh: Mesh):
    if spec == (NODE_AXIS,):
        ell = leaf.shape[0] // mesh.size
        return Blocks(leaf[b * ell:(b + 1) * ell].to(d, copy=True)
                      .contiguous() for b, d in enumerate(mesh.devices))
    return Replicated.of(leaf, mesh.distinct)


def shard_state(state, mesh: Mesh, n_nodes: Optional[int] = None):
    """The state placed on the mesh: node-axis leaves as Blocks (each
    block a copy of its own), every other tensor Replicated; host fields
    as they are.  B must divide N (swim.make_params checks shard_blocks
    the same way)."""
    n = n_nodes if n_nodes is not None else _n_nodes(state)
    if n % mesh.size:
        raise ValueError(f"{mesh.size} blocks must divide n_nodes={n}")
    if isinstance(state, torch.Tensor):
        return _place(state, _leaf_spec(state, n, mesh.size), mesh)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: shard_state(getattr(state, f.name), mesh, n)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(state, f.name))})
    raise TypeError(f"shard_state: {type(state).__name__}")


def unshard_state(sharded):
    """The state back on one device (the mesh's home): blocks
    concatenated, the first copy of each replicated leaf.  For tests and
    the smoke's comparisons only; a step never calls it."""
    if isinstance(sharded, Blocks):
        home = sharded.device
        return torch.cat([p.to(home) for p in sharded.parts])
    if isinstance(sharded, Replicated):
        return sharded.home.clone()
    if dataclasses.is_dataclass(sharded):
        return dataclasses.replace(sharded, **{
            f.name: unshard_state(getattr(sharded, f.name))
            for f in dataclasses.fields(sharded)
            if is_sharded(getattr(sharded, f.name))
            or dataclasses.is_dataclass(getattr(sharded, f.name))})
    return sharded


def assert_node_sharded(leaf, n_blocks: int, what: str = "state") -> None:
    """Fail unless a node-axis leaf is spread over all `n_blocks` blocks,
    each its own allocation (mesh.py:138-146)."""
    if not isinstance(leaf, Blocks):
        raise AssertionError(f"{what} not sharded: a {type(leaf).__name__}, "
                             f"expected {n_blocks} blocks")
    if leaf.n_blocks != n_blocks:
        raise AssertionError(f"{what} not sharded: {leaf.n_blocks} "
                             f"block(s), expected {n_blocks}")
    spans = sorted((p.data_ptr(), p.data_ptr() + p.numel() * p.element_size(),
                    p.device) for p in leaf.parts)
    for (a0, a1, da), (b0, _, db) in zip(spans, spans[1:]):
        if da == db and b0 < a1:
            raise AssertionError(f"{what}: two blocks share one allocation")


# --------------------------------------------------------------- streams

def join(devices) -> None:
    """Order every distinct device's current stream after the work queued
    so far on all of them (an event recorded on each, waited on by
    each): nothing later on any card starts before it.  One device needs
    nothing, since its blocks run one after another on its stream."""
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    if len(cards) < 2:
        return
    marks = []
    for d in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        marks.append(ev)
    for d in cards:
        stream = torch.cuda.current_stream(d)
        for ev in marks:
            stream.wait_event(ev)
