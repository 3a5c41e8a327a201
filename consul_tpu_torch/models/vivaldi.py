"""Vivaldi network coordinates as vectorized spring relaxation (the port of
consul_tpu/models/vivaldi.py).

Every probe ack yields one coordinate observation; a whole cluster's
acks apply in one batched update, against the ring peer (i + shift) % N
on the serf tick (`observe_ring`) or against any peers (`observe`, which
the standalone solver `sim_step` drives over a synthetic RTT matrix).
The algorithm follows the Vivaldi paper (Dabek et al., SIGCOMM'04) with
serf's height vector, adaptive error, gravity and latency-adjustment
window.  Units: seconds.  On a CUDA device `observe_ring` is one launch
of kernel K13 (kernels/csrc/vivaldi.cu), which draws the spring
directions of colocated nodes itself and updates the window and the
adjustment of the state it is given in place; on the CPU it runs its
plain twin `observe_ring_plain`.  `observe` and the standalone solver are gathers
and elementwise work in plain torch, their normal draws K1's.

The floats here pass through norms and the normal draw's erf_inv, whose
rounding differs between XLA and PyTorch by a few ulp; nothing here
feeds back into the SWIM state, so the tests hold these leaves to a
stated tolerance rather than bit equality.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.models import swim
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.parallel.mesh import Blocks
from consul_tpu_torch.utils import devices, prng

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class VivaldiParams:
    """serf coordinate tuning surface (documented defaults)."""

    n_nodes: int
    dims: int = 8
    vivaldi_error_max: float = 1.5
    vivaldi_ce: float = 0.25
    vivaldi_cc: float = 0.25
    adjustment_window: int = 20
    height_min: float = 10.0e-6
    gravity_rho: float = 150.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class VivaldiState:
    coords: torch.Tensor      # [N, D] float32, seconds
    height: torch.Tensor      # [N] float32
    error: torch.Tensor       # [N] float32
    adj_window: torch.Tensor  # [N, W] float32
    adj_index: int            # host mirror of the int32 ring cursor
    adjustment: torch.Tensor  # [N] float32

    def replace(self, **kw) -> "VivaldiState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "VivaldiState":
        """A copy whose every tensor is its own: what a caller keeps of a
        state it passes to observe_ring on the card, which consumes it."""
        return self.replace(**{f: getattr(self, f).clone() for f in (
            "coords", "height", "error", "adj_window", "adjustment")})


# the leaves K13 updates in place on the card: the window's column and the
# adjustment (coordinates, height and error are fresh: row i reads them at
# its ring peer)
RING_INPLACE = ("adj_window", "adjustment")


def init_state(params: VivaldiParams, device=None) -> VivaldiState:
    device = devices.resolve(device)
    n, d = params.n_nodes, params.dims
    return VivaldiState(
        coords=torch.zeros((n, d), dtype=F32, device=device),
        height=torch.full((n,), params.height_min, dtype=F32, device=device),
        error=torch.full((n,), params.vivaldi_error_max, dtype=F32,
                         device=device),
        adj_window=torch.zeros((n, params.adjustment_window), dtype=F32,
                               device=device),
        adj_index=0,
        adjustment=torch.zeros((n,), dtype=F32, device=device),
    )


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def observe(params: VivaldiParams, s: VivaldiState,
            src: Optional[torch.Tensor], dst: torch.Tensor, rtt: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> VivaldiState:
    """One RTT observation per source row, batched (vivaldi.py:87-159).

    src: [K] int32 node ids (distinct), or None for the row-aligned path
    (node i observes dst[i]); dst: [K] int32; rtt: [K] float32 seconds;
    mask: [K] bool (False rows are no-ops)."""
    aligned = src is None
    dev = s.coords.device
    if aligned:
        src = torch.arange(s.coords.shape[0], dtype=torch.int32, device=dev)
    if mask is None:
        mask = torch.ones(src.shape, dtype=torch.bool, device=dev)
    rtt = torch.clamp_min(rtt, 1.0e-6)
    si, di = src.to(torch.int64), dst.to(torch.int64)
    ci = s.coords if aligned else s.coords[si]
    hi = s.height if aligned else s.height[si]
    ei = s.error if aligned else s.error[si]
    cj, hj, ej = s.coords[di], s.height[di], s.error[di]

    diff = ci - cj
    norm = _norm(diff)
    dist = norm + hi + hj

    w = ei / torch.clamp_min(ei + ej, 1.0e-9)
    err_sample = torch.abs(dist - rtt) / rtt
    ce = params.vivaldi_ce
    new_err = err_sample * ce * w + ei * (1.0 - ce * w)
    new_err = torch.clamp(new_err, 1.0e-6, params.vivaldi_error_max)

    key = prng.tick_key(params.seed, s.adj_index, 7)
    rand_dir = prng.normal(key, tuple(ci.shape), dev)
    unit = torch.where((norm > 1.0e-9)[:, None],
                       diff / torch.clamp_min(norm, 1.0e-9)[:, None],
                       rand_dir / _norm(rand_dir, keepdim=True))
    force = params.vivaldi_cc * w * (rtt - dist)
    new_ci = ci + unit * force[:, None]
    new_hi = torch.clamp_min(hi + (hi / torch.clamp_min(dist, 1.0e-9)) * force,
                             params.height_min)

    m = mask
    col = s.adj_index % params.adjustment_window
    sample = (rtt - dist) / 2.0
    if aligned:
        coords = torch.where(m[:, None], new_ci, s.coords)
        height = torch.where(m, new_hi, s.height)
        error = torch.where(m, new_err, s.error)
        new_col = torch.where(m, sample, s.adj_window[:, col])
    else:
        coords = s.coords.index_put((si,), torch.where(m[:, None], new_ci, ci))
        height = s.height.index_put((si,), torch.where(m, new_hi, hi))
        error = s.error.index_put((si,), torch.where(m, new_err, ei))
        old_col = s.adj_window[:, col]
        new_col = old_col.index_put((si,), torch.where(m, sample, old_col[si]))

    norms = _norm(coords, keepdim=True)
    q = norms / params.gravity_rho
    coords = coords * torch.clamp_min(1.0 - q * q, 0.0)

    adj_window = s.adj_window.clone()
    adj_window[:, col] = new_col
    return VivaldiState(coords=coords, height=height, error=error,
                        adj_window=adj_window, adj_index=s.adj_index + 1,
                        adjustment=adj_window.mean(1))


def observe_ring_plain(params: VivaldiParams, s: VivaldiState,
                       shift: torch.Tensor, rtt_ms: torch.Tensor,
                       mask: torch.Tensor) -> VivaldiState:
    """The plain PyTorch version of K13: the row-aligned observation where
    node i's peer is (i + shift) % N (vivaldi.py:162-210), from the probe
    round's RTTs in milliseconds (serf.py:74's / 1000, an IEEE division on
    every device: a CUDA tensor over a host scalar would multiply by its
    reciprocal)."""
    rtt = torch.clamp_min(rtt_ms / torch.full_like(rtt_ms, 1000.0), 1.0e-6)
    ci, hi, ei = s.coords, s.height, s.error
    cj = rolls.pull(s.coords, shift)
    hj = rolls.pull(s.height, shift)
    ej = rolls.pull(s.error, shift)

    diff = ci - cj
    norm = _norm(diff)
    dist = norm + hi + hj

    w = ei / torch.clamp_min(ei + ej, 1.0e-9)
    err_sample = torch.abs(dist - rtt) / rtt
    ce = params.vivaldi_ce
    new_err = err_sample * ce * w + ei * (1.0 - ce * w)
    new_err = torch.clamp(new_err, 1.0e-6, params.vivaldi_error_max)

    rand_dir = prng.normal(_ring_key(params, s), tuple(ci.shape), ci.device)
    unit = torch.where((norm > 1.0e-9)[:, None],
                       diff / torch.clamp_min(norm, 1.0e-9)[:, None],
                       rand_dir / _norm(rand_dir, keepdim=True))
    force = params.vivaldi_cc * w * (rtt - dist)
    new_ci = ci + unit * force[:, None]
    new_hi = torch.clamp_min(hi + (hi / torch.clamp_min(dist, 1.0e-9)) * force,
                             params.height_min)

    m = mask
    coords = torch.where(m[:, None], new_ci, s.coords)
    height = torch.where(m, new_hi, s.height)
    error = torch.where(m, new_err, s.error)

    norms = _norm(coords, keepdim=True)
    q = norms / params.gravity_rho
    coords = coords * torch.clamp_min(1.0 - q * q, 0.0)

    col = s.adj_index % params.adjustment_window
    new_col = torch.where(m, (rtt - dist) / 2.0, s.adj_window[:, col])
    adj_window = s.adj_window.clone()
    adj_window[:, col] = new_col
    adjustment = adj_window.mean(1)

    return VivaldiState(coords=coords, height=height, error=error,
                        adj_window=adj_window, adj_index=s.adj_index + 1,
                        adjustment=adjustment)


def observe_ring_blocks_plain(params: VivaldiParams, s: VivaldiState,
                              shift: torch.Tensor, rtt_ms, mask) -> VivaldiState:
    """observe_ring_plain over a node-sharded pool (parallel/mesh.Blocks
    leaves, rtt_ms and mask Blocks): the peers' rows pulled by rolls'
    block rotations, the colocated rows' normal draws by global element
    (prng.draw_blocks), every other step row by row in each block, as the
    one-device twin does it."""
    n, w = params.n_nodes, params.adjustment_window
    cj_b = rolls.pull(s.coords, shift)
    hj_b = rolls.pull(s.height, shift)
    ej_b = rolls.pull(s.error, shift)
    rand_b = prng.draw_blocks([prng.Draw("normal", _ring_key(params, s),
                                         (n, params.dims))], s.coords)[0]
    col = s.adj_index % w
    ce = params.vivaldi_ce
    out = {f: [] for f in ("coords", "height", "error", "adj_window",
                           "adjustment")}
    for b, ci in enumerate(s.coords.parts):
        hi, ei = s.height.parts[b], s.error.parts[b]
        cj, hj, ej = cj_b.parts[b], hj_b.parts[b], ej_b.parts[b]
        r = rtt_ms.parts[b]
        rtt = torch.clamp_min(r / torch.full_like(r, 1000.0), 1.0e-6)
        diff = ci - cj
        norm = _norm(diff)
        dist = norm + hi + hj
        wgt = ei / torch.clamp_min(ei + ej, 1.0e-9)
        err_sample = torch.abs(dist - rtt) / rtt
        new_err = err_sample * ce * wgt + ei * (1.0 - ce * wgt)
        new_err = torch.clamp(new_err, 1.0e-6, params.vivaldi_error_max)
        rand_dir = rand_b.parts[b]
        unit = torch.where((norm > 1.0e-9)[:, None],
                           diff / torch.clamp_min(norm, 1.0e-9)[:, None],
                           rand_dir / _norm(rand_dir, keepdim=True))
        force = params.vivaldi_cc * wgt * (rtt - dist)
        new_ci = ci + unit * force[:, None]
        new_hi = torch.clamp_min(
            hi + (hi / torch.clamp_min(dist, 1.0e-9)) * force,
            params.height_min)
        m = mask.parts[b]
        coords = torch.where(m[:, None], new_ci, ci)
        norms = _norm(coords, keepdim=True)
        q = norms / params.gravity_rho
        out["coords"].append(coords * torch.clamp_min(1.0 - q * q, 0.0))
        out["height"].append(torch.where(m, new_hi, hi))
        out["error"].append(torch.where(m, new_err, ei))
        win = s.adj_window.parts[b]
        new_col = torch.where(m, (rtt - dist) / 2.0, win[:, col])
        win = win.clone()
        win[:, col] = new_col
        out["adj_window"].append(win)
        out["adjustment"].append(win.mean(1))
    return VivaldiState(adj_index=s.adj_index + 1,
                        **{f: Blocks(v) for f, v in out.items()})


def _ring_key(params: VivaldiParams, s: VivaldiState):
    """The key of the colocated rows' spring directions (stream 7)."""
    return prng.tick_key(params.seed, s.adj_index, 7)


def observe_ring(params: VivaldiParams, s: VivaldiState, shift: torch.Tensor,
                 rtt_ms: torch.Tensor, mask: torch.Tensor) -> VivaldiState:
    """observe_ring_plain's result.  On CUDA tensors one K13 launch (`shift`
    a 0-d int32 on the device, the colocated rows' normal draws made
    inside it) consumes s: it writes the window's column and the
    adjustment into s's own tensors (RING_INPLACE), and the coordinates,
    height and error into fresh ones."""
    sharded = isinstance(s.coords, Blocks)
    if not s.coords.is_cuda:
        return (observe_ring_blocks_plain if sharded else
                observe_ring_plain)(params, s, shift, rtt_ms, mask)
    swim._writable(s, RING_INPLACE, "K13")
    if sharded:
        return _observe_ring_blocks(params, s, shift, rtt_ms, mask)
    n = s.coords.shape[0]
    w = s.adj_window.shape[1]
    lo, span = prng.normal_bounds()
    e = torch.empty_like
    out = dict(coords_out=e(s.coords), height_out=e(s.height),
               error_out=e(s.error))
    kernels.launch_vivaldi_ring(
        coords=s.coords, height=s.height, error=s.error, window=s.adj_window,
        rtt_ms=rtt_ms, acked=mask, shift=shift,
        col=s.adj_index % params.adjustment_window,
        key=_ring_key(params, s), normal_lo=lo, normal_span=span,
        ce=params.vivaldi_ce, cc=params.vivaldi_cc,
        error_max=params.vivaldi_error_max, height_min=params.height_min,
        # the twin's q = |c| / rho on a CUDA tensor: |c| * float32(1 / rho)
        inv_rho=prng.f32(np.float32(1.0) / np.float32(params.gravity_rho)),
        # torch's CUDA mean: the sum times float32(N) / float32(N * W)
        mean_factor=prng.f32(np.float32(n) / np.float32(n * w)),
        adjustment=s.adjustment, **out)
    return VivaldiState(coords=out["coords_out"], height=out["height_out"],
                        error=out["error_out"], adj_window=s.adj_window,
                        adj_index=s.adj_index + 1, adjustment=s.adjustment)


def _observe_ring_blocks(params: VivaldiParams, s: VivaldiState, shift,
                         rtt_ms, mask) -> VivaldiState:
    """observe_ring's block form on the cards: a K13 launch a block over
    its rows, the peers' rows read through block tables, the window's
    column and the adjustment written into s's blocks, the coordinates,
    height and error into fresh blocks (RING_INPLACE, as one device)."""
    n, w = params.n_nodes, params.adjustment_window
    lo, span = prng.normal_bounds()
    fresh = {f: Blocks(torch.empty_like(p) for p in getattr(s, f).parts)
             for f in ("coords", "height", "error")}
    kernels.launch_vivaldi_ring_blocks(
        coords=s.coords, height=s.height, error=s.error, window=s.adj_window,
        rtt_ms=rtt_ms, acked=mask,
        shift=torch.as_tensor(shift, dtype=torch.int32, device=s.height.device),
        col=s.adj_index % w, key=_ring_key(params, s), normal_lo=lo,
        normal_span=span, ce=params.vivaldi_ce, cc=params.vivaldi_cc,
        error_max=params.vivaldi_error_max, height_min=params.height_min,
        inv_rho=prng.f32(np.float32(1.0) / np.float32(params.gravity_rho)),
        mean_factor=prng.f32(np.float32(n) / np.float32(n * w)),
        coords_out=fresh["coords"], height_out=fresh["height"],
        error_out=fresh["error"], adjustment=s.adjustment)
    return VivaldiState(coords=fresh["coords"], height=fresh["height"],
                        error=fresh["error"], adj_window=s.adj_window,
                        adj_index=s.adj_index + 1, adjustment=s.adjustment)


def raw_distance(s: VivaldiState, src: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    """Euclidean + height distance between node rows src and dst ([K]
    ids; vivaldi.py:73-76), with observe_ring's norm."""
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    return _norm(s.coords[src] - s.coords[dst]) + s.height[src] \
        + s.height[dst]


def estimate_rtt(s: VivaldiState, src: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    """Predicted RTT with the adjustment terms, floored like the reference
    (lib/rtt.go:13-43; vivaldi.py:79-84)."""
    d = raw_distance(s, src, dst)
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    adjusted = d + s.adjustment[src] + s.adjustment[dst]
    return torch.where(adjusted > 0.0, adjusted, d)


def sort_by_distance(s: VivaldiState, origin: int) -> torch.Tensor:
    """Node ids ([N] int32) in stable order of estimated RTT from `origin`
    — the `?near=` query path (vivaldi.py:213-219)."""
    n = s.coords.shape[0]
    dev = s.coords.device
    d = estimate_rtt(s, torch.full((n,), origin, dtype=torch.int32,
                                   device=dev),
                     torch.arange(n, dtype=torch.int32, device=dev))
    return torch.sort(d, stable=True).indices.to(torch.int32)


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jnp.median along `dim` of finite values: with an even count the two
    middle values are averaged as (lo + hi) * 0.5 in float32 (its
    "midpoint" quantile; torch.median would return the lower one)."""
    v = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = v.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    hi = v.narrow(dim, n // 2, 1).squeeze(dim)
    return (lo + hi) * 0.5


# ---------------------------------------------------------------------------
# the standalone convergence sim (vivaldi.py:222-256)
# ---------------------------------------------------------------------------

def synthetic_rtt(true_coords: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, key, jitter: float = 0.02) -> torch.Tensor:
    """Ground-truth RTT (seconds) from latent coordinates, times
    1 + jitter * a K1 normal."""
    base = _norm(true_coords[src.to(torch.int64)]
                 - true_coords[dst.to(torch.int64)])
    noise = 1.0 + jitter * prng.normal(key, tuple(base.shape), base.device)
    return torch.clamp_min(base * noise, 1.0e-6)


def _pairs(params: VivaldiParams, tick: int, stream: int, device):
    """Every node and one random other node, from tick_key(seed, tick,
    stream)'s split, and the second half of the split for the RTT draw."""
    n = params.n_nodes
    k1, k2 = prng.split(prng.tick_key(params.seed, tick, stream))
    src = torch.arange(n, dtype=torch.int32, device=device)
    return src, prng.other_nodes(k1, n, (n,), device), k2


def sim_step(params: VivaldiParams, true_coords: torch.Tensor,
             s: VivaldiState, tick: int) -> VivaldiState:
    """One relaxation tick: every node measures one random peer."""
    src, dst, k2 = _pairs(params, tick, 8, s.coords.device)
    return observe(params, s, src, dst, synthetic_rtt(true_coords, src, dst,
                                                      k2))


def relative_error(params: VivaldiParams, true_coords: torch.Tensor,
                   s: VivaldiState, tick: int) -> torch.Tensor:
    """Median |predicted - true| / true RTT over one random pair per node
    (0-d float32, on the device)."""
    src, dst, k2 = _pairs(params, tick, 9, s.coords.device)
    true_rtt = synthetic_rtt(true_coords, src, dst, k2, jitter=0.0)
    est = estimate_rtt(s, src, dst)
    return median(torch.abs(est - true_rtt) / true_rtt)
