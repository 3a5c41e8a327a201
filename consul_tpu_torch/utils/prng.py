"""Counter-based threefry streams, bit-equal to jax.random (jax 0.9,
jax_threefry_partitionable=True).

Every random draw of the simulator derives from (seed, tick, stream), so
the whole run is a pure function of its seed — and here of the SAME
function the JAX package computes, so a port trajectory can be held to
the reference tick by tick.

Keys are pairs of Python ints (two uint32 words).  Key derivation
(`PRNGKey`, `fold_in`, `split`, `tick_key`) is scalar work done on the
host, so deriving a tick's keys never touches the device or syncs it.
Draws (`bits` and the transforms on top of it) make device tensors: on
a CUDA device `bits` launches kernel K1 (kernels/csrc/threefry.cu); on
the CPU it runs `threefry_bits_plain`, the same hash in int64 torch ops.

Layout (jax/_src/prng.py:1184-1200): element i of a draw of `shape`
(row-major flat index) is x0 ^ x1 of threefry2x32(key, (i >> 32,
i & 0xffffffff)).  `split(key, k)[j]` is threefry2x32(key, (0, j)) and
`fold_in(key, d)` is threefry2x32(key, (0, d)) (prng.py:1138-1170).
"""

from __future__ import annotations

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
# bits: kernel K1 and its plain twin
# ---------------------------------------------------------------------------

def threefry_bits_plain(key, n: int, device) -> torch.Tensor:
    """[n] int32 bit patterns of the xor-folded threefry2x32 stream, in
    int64 torch arithmetic masked to 32 bits."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    i = torch.arange(n, dtype=torch.int64, device=device)
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


def bits(key, shape, device) -> torch.Tensor:
    """Random uint32 words (as int32 bit patterns) of `shape`: K1 on a CUDA
    device, the plain twin on the CPU."""
    device = torch.device(device)
    n = _numel(shape)
    if device.type == "cuda":
        out = torch.empty(n, dtype=torch.int32, device=device)
        kernels.launch_threefry(key, n, 0, out)
    else:
        out = threefry_bits_plain(key, n, device)
    return out.reshape(shape)


def _u32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int64) & M32


def unit_floats(b: torch.Tensor) -> torch.Tensor:
    """jax's mantissa trick: (bits >> 9 | 0x3f800000) as float32, minus 1."""
    fb = (_u32(b) >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform float32 (random.py:435-477)."""
    device = torch.device(device)
    if device.type == "cuda":
        floats = torch.empty(_numel(shape), dtype=torch.float32, device=device)
        kernels.launch_threefry(key, floats.numel(), 1, floats)
        floats = floats.reshape(shape)
    else:
        floats = unit_floats(bits(key, shape, device))
    if minval == 0.0 and maxval == 1.0:
        return floats           # u * 1 + 0, floored at 0, is u itself
    # bounds as float32 values held in Python floats: scalar operands, so no
    # host-to-device copy (which would synchronize the stream)
    lo, hi = f32(minval), f32(maxval)
    span = f32(np.float32(hi) - np.float32(lo))
    return torch.clamp_min(floats * span + lo, lo)


def f32(x: float) -> float:
    """The float32 nearest x, as a Python float (exact in either width)."""
    return float(np.float32(x))


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """jax.random.bernoulli (random.py:1075): uniform < p in float32."""
    return uniform(key, shape, device) < f32(p)


def exponential(key, shape, device) -> torch.Tensor:
    """jax.random.exponential (random.py:1291): -log1p(-u)."""
    return -torch.log1p(-uniform(key, shape, device))


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """jax.random.randint int32 for host-int bounds (random.py:581-646):
    two 32-bit draws from split(key), folded with the multiplier
    (2^16 mod span)^2 mod 2^32 mod span — which wraps to 0 for spans
    above 2^16, exactly as the reference does."""
    k1, k2 = split(key, 2)
    hi = _u32(bits(k1, shape, device))
    lo = _u32(bits(k2, shape, device))
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult + lo % span) & M32) % span
    return (off + minval).to(torch.int32)


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


def normal(key, shape, device) -> torch.Tensor:
    """jax.random.normal float32 (random.py:867): sqrt(2) * erf_inv(u) with
    u uniform on (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, lo, 1.0)
    return f32(np.sqrt(2)) * erf_inv(u)
