"""Counter-based threefry streams, bit-equal to jax.random (jax 0.9,
jax_threefry_partitionable=True).

Every random draw of the simulator derives from (seed, tick, stream), so
the whole run is a pure function of its seed — and here of the SAME
function the JAX package computes, so a port trajectory can be held to
the reference tick by tick.

Keys are pairs of Python ints (two uint32 words).  Key derivation
(`PRNGKey`, `fold_in`, `split`, `tick_key`) is scalar work done on the
host, so deriving a tick's keys never touches the device or syncs it.
Draws make device tensors: on a CUDA device each of `bits`, `uniform`,
`exponential`, `normal` and `randint` is one launch of kernel K1
(kernels/csrc/threefry.cu) that writes the finished draw, and `draw`
makes several draws (a call site's whole tick) in one launch; on the CPU
each runs its plain twin (`*_plain`), the same hash in int64 torch ops
and the same transforms in float32 torch ops.

Layout (jax/_src/prng.py:1184-1200): element i of a draw of `shape`
(row-major flat index) is x0 ^ x1 of threefry2x32(key, (i >> 32,
i & 0xffffffff)).  `split(key, k)[j]` is threefry2x32(key, (0, j)) and
`fold_in(key, d)` is threefry2x32(key, (0, d)) (prng.py:1138-1170).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from consul_tpu_torch import kernels

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(key, x0: int, x1: int):
    """The threefry2x32 block function on one counter pair (host ints)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int):
    """jax.random.PRNGKey for a 32-bit seed: (seed >> 32, seed & M)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} outside int32 (x64 is off in the "
                            f"reference)")
    return (0, seed & M32)


def fold_in(key, data: int):
    return threefry2x32(key, 0, int(data) & M32)


def split(key, num: int = 2):
    return [threefry2x32(key, 0, j) for j in range(num)]


def tick_key(seed: int, tick: int, stream: int):
    """Key for (tick, stream) from an integer seed (utils/prng.py:14-20)."""
    return fold_in(fold_in(PRNGKey(seed), stream), tick)


# ---------------------------------------------------------------------------
# the threefry hash in torch ops (the plain twin of K1's bits)
# ---------------------------------------------------------------------------

def threefry_bits_plain(key, n: int, device, start: int = 0,
                        step: int = 1) -> torch.Tensor:
    """[n] int32 bit patterns of elements start, start + step, ... of the
    xor-folded threefry2x32 stream, in int64 torch arithmetic masked to 32
    bits."""
    return _bits_at(key, start + step * torch.arange(n, dtype=torch.int64,
                                                     device=device))


def _bits_at(key, i: torch.Tensor) -> torch.Tensor:
    """The xor-folded threefry2x32 bits of the int64 element indices i, in
    i's shape."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ((i >> 32) + ks[0]) & M32
    x1 = ((i & M32) + ks[1]) & M32
    for rnd in range(5):
        for r in _ROT[rnd % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(rnd + 1) % 3]) & M32
        x1 = (x1 + (ks[(rnd + 2) % 3] + rnd + 1)) & M32
    out = x0 ^ x1
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def _numel(shape) -> int:
    return int(math.prod(shape))


def _u32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int64) & M32


def unit_floats(b: torch.Tensor) -> torch.Tensor:
    """jax's mantissa trick: (bits >> 9 | 0x3f800000) as float32, minus 1."""
    fb = (_u32(b) >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def f32(x: float) -> float:
    """The float32 nearest x, as a Python float (exact in either width)."""
    return float(np.float32(x))


def _uniform_bounds(minval: float, maxval: float):
    """jax.random.uniform's float32 minval and span (maxval - minval), as
    Python floats: scalar operands, so no host-to-device copy (which would
    synchronize the stream)."""
    lo = f32(minval)
    return lo, f32(np.float32(f32(maxval)) - np.float32(lo))


def _randint_span(minval: int, maxval: int):
    """jax.random.randint's span and multiplier for host-int bounds: the
    multiplier (2^16 mod span)^2 mod 2^32 mod span wraps to 0 for spans
    above 2^16, exactly as the reference computes it."""
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    return span, ((mult * mult) & M32) % span


# jax.random.normal's uniform lower bound, nextafter(-1, 0) in float32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


# erf_inv as XLA expands it for float32 (chlo.erf_inv: Giles' single-
# precision polynomial in w = -log1p(-x*x), w < 5 and w >= 5 branches)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, f32(a), f32(b)) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


# ---------------------------------------------------------------------------
# plain twins of K1's modes (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _element_index(shape, device, start: int) -> torch.Tensor:
    """start + the row-major flat index of each element of `shape`, made
    in that shape (a block's draw makes no flat [rows * width] vector)."""
    idx = torch.full((1,) * len(shape), start, dtype=torch.int64,
                     device=device)
    stride = 1
    for ax in reversed(range(len(shape))):
        at = torch.arange(shape[ax], dtype=torch.int64, device=device)
        idx = idx + (at * stride).reshape(
            (1,) * ax + (shape[ax],) + (1,) * (len(shape) - 1 - ax))
        stride *= shape[ax]
    return idx.expand(tuple(shape))


def bits_plain(key, shape, device, start: int = 0) -> torch.Tensor:
    """Elements start, start + 1, ... of the draw's stream in `shape`: a
    whole draw from 0, or a block of its rows (draw_blocks)."""
    return _bits_at(key, _element_index(tuple(shape), device, start))


def uniform_plain(key, shape, device, minval: float = 0.0,
                  maxval: float = 1.0, start: int = 0) -> torch.Tensor:
    """jax.random.uniform float32 (random.py:435-477)."""
    floats = unit_floats(bits_plain(key, shape, device, start))
    if minval == 0.0 and maxval == 1.0:
        return floats           # u * 1 + 0, floored at 0, is u itself
    lo, span = _uniform_bounds(minval, maxval)
    return torch.clamp_min(floats * span + lo, lo)


def exponential_plain(key, shape, device, start: int = 0) -> torch.Tensor:
    """jax.random.exponential (random.py:1291): -log1p(-u)."""
    return -torch.log1p(-uniform_plain(key, shape, device, start=start))


def normal_plain(key, shape, device, start: int = 0) -> torch.Tensor:
    """jax.random.normal float32 (random.py:867): sqrt(2) * erf_inv(u) with
    u uniform on (nextafter(-1, 0), 1)."""
    u = uniform_plain(key, shape, device, _NORMAL_LO, 1.0, start)
    return f32(np.sqrt(2)) * erf_inv(u)


def randint_plain(key, shape, minval: int, maxval: int,
                  device, start: int = 0) -> torch.Tensor:
    """jax.random.randint int32 for host-int bounds (random.py:581-646):
    two 32-bit draws from split(key), folded with the multiplier."""
    k1, k2 = split(key, 2)
    hi = _u32(bits_plain(k1, shape, device, start))
    lo = _u32(bits_plain(k2, shape, device, start))
    span, mult = _randint_span(minval, maxval)
    off = (((hi % span) * mult + lo % span) & M32) % span
    return (off + minval).to(torch.int32)


# ---------------------------------------------------------------------------
# draws: K1 on a CUDA device, the plain twins on the CPU
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Draw:
    """One jax.random draw of `shape` from `key`: kind "bits" (int32 bit
    patterns), "uniform" (float32 on [minval, maxval)), "exponential",
    "normal", or "randint" (int32 on [minval, maxval), host-int bounds)."""

    kind: str
    key: tuple
    shape: tuple
    minval: float = 0.0
    maxval: float = 1.0


def draw_plain(draws, device, start: int = 0) -> list:
    """The plain twin of `draw`: each Draw's tensor from its mode's twin,
    its elements from `start` of the draw's stream (a block of a larger
    draw's rows, draw_blocks)."""
    twins = {"bits": lambda d: bits_plain(d.key, d.shape, device, start),
             "uniform": lambda d: uniform_plain(d.key, d.shape, device,
                                                d.minval, d.maxval, start),
             "exponential": lambda d: exponential_plain(d.key, d.shape,
                                                        device, start),
             "normal": lambda d: normal_plain(d.key, d.shape, device, start),
             "randint": lambda d: randint_plain(d.key, d.shape, d.minval,
                                                d.maxval, device, start)}
    for d in draws:
        if d.kind not in twins:
            raise ValueError(f"unknown draw kind {d.kind!r}")
    return [twins[d.kind](d) for d in draws]


def normal_bounds():
    """(lo, span) of jax.random.normal's uniform, as K1 and K13 scale it."""
    return _uniform_bounds(_NORMAL_LO, 1.0)


def _segment(d: Draw, out: torch.Tensor, first: int = 0) -> kernels.Segment:
    """K1's segment of draw d into out, out[0] being element `first` of
    the draw's stream."""
    if d.kind == "randint":
        span, mult = _randint_span(d.minval, d.maxval)
        return kernels.Segment("randint", tuple(split(d.key, 2)), out,
                               out.numel(), minval=int(d.minval), range=span,
                               mult=mult, first=first)
    lo, span = 0.0, 1.0
    if d.kind == "uniform":
        lo, span = _uniform_bounds(d.minval, d.maxval)
    elif d.kind == "normal":
        lo, span = normal_bounds()
    return kernels.Segment(d.kind, (d.key,), out, out.numel(), lo=lo,
                           span=span, first=first)


def randint_spec(d: Draw) -> kernels.DrawSpec:
    """K1's table entry for a randint Draw that a kernel draws for itself,
    with no output: K14's ring offsets (rolls.offsets' draw)."""
    if d.kind != "randint":
        raise ValueError(f"randint_spec takes a randint draw, got {d.kind!r}")
    span, mult = _randint_span(d.minval, d.maxval)
    return kernels.randint_spec(tuple(split(d.key, 2)), _numel(d.shape),
                                int(d.minval), span, mult)


def draw_segments(draws, device):
    """K1's inputs for these draws on a CUDA device: each draw's output,
    allocated, and the kernels.Segment of each non-empty one."""
    outs = [torch.empty(d.shape, device=device, dtype=_dtype(d))
            for d in draws]
    return outs, [_segment(d, out) for d, out in zip(draws, outs)
                  if out.numel()]


def draw(draws, device) -> list:
    """Each Draw's tensor.  On a CUDA device K1 writes them all finished,
    one launch for up to kernels.MAX_SEGMENTS draws (empty draws launch
    nothing); on the CPU each runs its plain twin."""
    device = torch.device(device)
    if device.type != "cuda":
        return draw_plain(draws, device)
    outs, segs = draw_segments(draws, device)
    for i in range(0, len(segs), kernels.MAX_SEGMENTS):
        kernels.launch_draws(segs[i:i + kernels.MAX_SEGMENTS])
    return outs


def _dtype(d: Draw) -> torch.dtype:
    return torch.int32 if d.kind in ("bits", "randint") else torch.float32


def draw_blocks(draws, like) -> list:
    """Each Draw's value on a node-sharded pool cut as `like` (a
    parallel/mesh.Blocks of B blocks of L rows): a draw whose shape leads
    with N = B * L comes back as Blocks, block b holding rows [bL, (b +
    1)L) of the whole draw (elements bL * r .. of its stream, r elements a
    row: jax_threefry_partitionable makes an element depend on its index
    alone); any other draw comes back Replicated, drawn once on each
    distinct device.  On the cards one K1 batch a distinct device, a
    segment a block (`threefry_draws_blocks`); on the CPU the plain twins
    from each block's first element."""
    from consul_tpu_torch.parallel.mesh import Blocks, Replicated
    ell, devs = like.rows, like.devices
    n = like.n_blocks * ell
    distinct = tuple(dict.fromkeys(devs))

    def rows(d):
        return _numel(d.shape[1:]) if d.shape and d.shape[0] == n else None

    def block(d):
        return dataclasses.replace(d, shape=(ell,) + tuple(d.shape[1:]))

    if not like.is_cuda:
        return [Blocks(draw_plain([block(d)], dev, b * ell * rows(d))[0]
                       for b, dev in enumerate(devs))
                if rows(d) is not None else
                Replicated(draw_plain([d], dev)[0] for dev in distinct)
                for d in draws]
    parts = [[None] * len(devs) for _ in draws]
    copies = [{} for _ in draws]
    for dev in distinct:
        segs = []
        for j, d in enumerate(draws):
            if rows(d) is None:
                out = torch.empty(d.shape, dtype=_dtype(d), device=dev)
                copies[j][dev] = out
                if out.numel():
                    segs.append(_segment(d, out))
                continue
            for b, at in enumerate(devs):
                if at != dev:
                    continue
                out = torch.empty(block(d).shape, dtype=_dtype(d), device=dev)
                parts[j][b] = out
                if out.numel():
                    segs.append(_segment(d, out, b * ell * rows(d)))
        for i in range(0, len(segs), kernels.MAX_SEGMENTS):
            kernels.launch_draws(segs[i:i + kernels.MAX_SEGMENTS],
                                 blocks=True)
    return [Blocks(parts[j]) if rows(d) is not None else
            Replicated(copies[j][dev] for dev in distinct)
            for j, d in enumerate(draws)]


def bits(key, shape, device) -> torch.Tensor:
    """Random uint32 words (as int32 bit patterns) of `shape`."""
    return draw([Draw("bits", key, tuple(shape))], device)[0]


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform float32 (random.py:435-477)."""
    return draw([Draw("uniform", key, tuple(shape), minval, maxval)],
                device)[0]


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """jax.random.bernoulli (random.py:1075): uniform < p in float32."""
    return uniform(key, shape, device) < f32(p)


def exponential(key, shape, device) -> torch.Tensor:
    """jax.random.exponential (random.py:1291): -log1p(-u)."""
    return draw([Draw("exponential", key, tuple(shape))], device)[0]


def normal(key, shape, device) -> torch.Tensor:
    """jax.random.normal float32 (random.py:867)."""
    return draw([Draw("normal", key, tuple(shape))], device)[0]


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """jax.random.randint int32 for host-int bounds (random.py:581-646)."""
    return draw([Draw("randint", key, tuple(shape), minval, maxval)],
                device)[0]


def other_nodes(key, n: int, shape, device) -> torch.Tensor:
    """Uniform node ids excluding the row's own id (utils/prng.py:23-31):
    int32 of `shape`, shape[0] == n, row i never draws i."""
    d = randint(key, shape, 0, n - 1, device)
    rows = torch.arange(n, dtype=torch.int32, device=d.device)
    return (rows.reshape((n,) + (1,) * (len(shape) - 1)) + 1 + d) % n
