// K1 threefry_draws: whole jax.random draws, finished in the kernel, up to
// eight draws ("segments") in one launch.
//
// Replaces: the jax.random draws of the JAX package on its main path —
// rolls.offsets' randint (consul_tpu/ops/rolls.py:27), _probe_round's
// uniform and exponential draws (consul_tpu/models/swim.py:725-778) and
// vivaldi.observe_ring's normal (consul_tpu/models/vivaldi.py:184) — all
// layered on the tick_key threefry streams (consul_tpu/utils/prng.py:14).
// jax 0.9 with jax_threefry_partitionable=True draws element i of a shape
// as x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xffffffff)); each mode
// finishes those bits as jax.random does, bit for bit with the plain twins
// of consul_tpu_torch/utils/prng.py:
//
//   BITS         the int32 bit pattern;
//   UNIFORM      max(lo, u * span + lo), u = (bits >> 9 | 0x3f800000) - 1;
//   EXPONENTIAL  -log1pf(-u);
//   NORMAL       sqrt(2) * erf_inv(max(lo, u * span + lo)), XLA's float32
//                erf_inv (both branches; common.cuh:normal_float, which
//                K13 shares for observe_ring's spring directions);
//   RANDINT      two streams (the host passes split(key)'s two schedules):
//                ((hi % span) * mult + lo % span) % span + minval in 32-bit
//                wrapping arithmetic, mult = (2^16 % span)^2 mod 2^32 % span
//                from the host (0 for spans above 2^16, as jax computes it;
//                common.cuh:randint_lanes, which K14 shares for its ring
//                offsets).
//
// Float steps are explicitly rounded (__fmul_rn, __fadd_rn), so nvcc does
// not contract a multiply and an add into an FMA: the plain twin on the
// card runs them as separate torch kernels.  log1pf and sqrtf are the
// IEEE routines torch's CUDA log1p and sqrt call (no -use_fast_math).
//
// Bound on an H100: every element is ~20 dependent rounds of add/rotate/
// xor against 4 bytes written, so the kernel is bound by the 32-bit lane
// rate, not by memory.  The design: a thread computes 4 consecutive
// elements with the four chains' rounds interleaved (common.cuh:
// threefry_lanes), rotations are compile-time funnel shifts, each
// segment's key schedule is computed once on the host, the 4 results go
// out as one 16-byte store, and the grid is the total work: a segment
// starts on a block's tile (1024 elements), so a block finds its segment
// in the tile prefix of the table (a kernel parameter) and never straddles
// two.  A 3-element randint is one block.
//
// THREEFRY_CENSUS_MODE=m (kernels/build.py:sass_census) compiles the
// kernel for mode m alone and without the scalar tail, so its SASS counts
// the instructions of that mode's elements.

#include "common.cuh"

using namespace consul_kernels;

namespace {

enum Mode : int32_t { kBits = 0, kUniform = 1, kExponential = 2, kNormal = 3,
                      kRandint = 4, kModes = 5 };

constexpr int kMaxSegments = 8;
constexpr int kThreads = 256;
constexpr int kPer = 4;                       // elements a thread
constexpr int64_t kTile = kThreads * kPer;    // elements a block

// The raw bits of elements e .. e + L - 1 of d's stream (no carry from
// the low word into the high one within the L): randint's fold of its two
// streams, or the stream's bits.
template <int M, int L>
__device__ __forceinline__ void bits4_lanes(const DrawSpec& d, uint64_t e, uint32_t (&v)[L]) {
  const uint32_t hi = static_cast<uint32_t>(e >> 32);
  const uint32_t lo = static_cast<uint32_t>(e);
  if (M == kRandint) {
    randint_lanes<L>(d, hi, lo, v);   // common.cuh, shared with K14
    return;
  }
  ThreefryKey key;
#pragma unroll
  for (int j = 0; j < 8; ++j) key.k[j] = d.sched[j];
  threefry_lanes<L>(key, hi, lo, v);
}

// A segment is a common.cuh:DrawSpec, as the host fills it
// (kernels/__init__.py:DrawSpec).

struct DrawTable {
  int first_tile[kMaxSegments];   // unused entries hold the total tile count
  DrawSpec seg[kMaxSegments];
};

// The bits of elements e .. e + 3 of d's stream: four interleaved lanes,
// or one lane each where the four straddle a 2^32 boundary (a block's
// draw starts at any element, prng.draw_blocks).
template <int M>
__device__ __forceinline__ void bits4(const DrawSpec& d, uint64_t e, uint32_t (&v)[kPer]) {
#ifndef THREEFRY_CENSUS_MODE
  if (static_cast<uint32_t>(e) > 0xFFFFFFFFu - (kPer - 1)) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      uint32_t one[1];
      bits4_lanes<M, 1>(d, e + j, one);
      v[j] = one[0];
    }
    return;
  }
#endif
  bits4_lanes<M, kPer>(d, e, v);
}

// Element i .. i + 3 of segment d (i a multiple of 4, i < d.n; elements
// first + i .. of its stream), finished and stored: one 16-byte store
// where the four fit and the output is 16-byte aligned, else (kTail)
// element by element.
template <int M, bool kTail>
__device__ __forceinline__ void draw4(const DrawSpec& d, int64_t i) {
  uint32_t v[kPer];
  bits4<M>(d, static_cast<uint64_t>(d.first + i), v);
  if (M != kRandint) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (M == kBits) continue;
      const float u = unit_float(v[j]);
      float f;
      if (M == kUniform) f = scaled(u, d.lo, d.span);
      else if (M == kExponential) f = -log1pf(-u);
      else f = normal_float(u, d.lo, d.span);
      v[j] = __float_as_uint(f);
    }
  }
  uint32_t* out = static_cast<uint32_t*>(d.out) + i;
  if (!kTail || (i + kPer <= d.n && aligned16(out))) {
    *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (i + j < d.n) out[j] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_draws_kernel(const __grid_constant__ DrawTable t) {
  const int tile = static_cast<int>(blockIdx.x);
  int s = 0;
#pragma unroll
  for (int j = 1; j < kMaxSegments; ++j) s += tile >= t.first_tile[j];
  const DrawSpec& d = t.seg[s];
  const int64_t i = static_cast<int64_t>(tile - t.first_tile[s]) * kTile +
                    threadIdx.x * kPer;
  if (i >= d.n) return;
#ifdef THREEFRY_CENSUS_MODE
  draw4<THREEFRY_CENSUS_MODE, false>(d, i);
#else
  switch (d.mode) {   // block-uniform
    case kBits: draw4<kBits, true>(d, i); break;
    case kUniform: draw4<kUniform, true>(d, i); break;
    case kExponential: draw4<kExponential, true>(d, i); break;
    case kNormal: draw4<kNormal, true>(d, i); break;
    default: draw4<kRandint, true>(d, i); break;
  }
#endif
}

}  // namespace

// specs: `count` DrawSpecs in host memory (1 <= count <= 8), each with
// n >= 1, a mode < 5 and, for RANDINT, range >= 1.
extern "C" int threefry_draws(const void* specs, int count, void* stream) {
  if (count < 1 || count > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  DrawTable t = {};
  int64_t tiles = 0;
  for (int s = 0; s < count; ++s) {
    const DrawSpec& d = static_cast<const DrawSpec*>(specs)[s];
    if (d.n < 1 || d.mode < 0 || d.mode >= kModes ||
        (d.mode == kRandint && d.range == 0))
      return static_cast<int>(cudaErrorInvalidValue);
    t.seg[s] = d;
    t.first_tile[s] = static_cast<int>(tiles);
    tiles += (d.n + kTile - 1) / kTile;
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = count; s < kMaxSegments; ++s) t.first_tile[s] = static_cast<int>(tiles);
  threefry_draws_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
