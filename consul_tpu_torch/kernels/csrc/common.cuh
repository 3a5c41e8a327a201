// Shared helpers for the port's kernels.
//
// Counters: block-level sums of per-thread counters, folded into global
// integer accumulators, with the last block of the grid publishing the
// totals and resetting the accumulators for the next launch (so a launch
// needs no separate memset or finalize kernel).
//
// Rows: a node's [S] row of bool/int8 slots is read as 16-byte vectors
// where the row is 16-byte aligned (S a multiple of 16), byte by byte
// otherwise, and summarized as a 64-bit slot mask (S <= 64).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace consul_kernels {

using u64 = unsigned long long;

__device__ __forceinline__ u64 warp_sum(u64 v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums K per-thread counters over the block into acc[0..K-1] with one
// atomicAdd each, then counts the block into acc[K].  Returns true in
// thread 0 of the last block to finish; that thread may then read the
// totals with take() (which also zeroes them).  blockDim.x must be a
// multiple of 32 and at most 1024.
template <int K>
__device__ bool block_accumulate(const u64 (&v)[K], u64* acc) {
  __shared__ u64 partial[K][32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u64 s = warp_sum(v[k]);
    if (lane == 0) partial[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u64 s = 0;
      for (int w = 0; w < nwarps; ++w) s += partial[k][w];
      if (s) atomicAdd(&acc[k], s);
    }
    __threadfence();
    const u64 done = atomicAdd(&acc[K], 1ull);
    last = (done == static_cast<u64>(gridDim.x) - 1);
  }
  __syncthreads();
  return threadIdx.x == 0 && last;
}

__device__ __forceinline__ u64 take(u64* p) { return atomicExch(p, 0ull); }

// --- slot rows -------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Per byte of x: 0x80 where the byte is nonzero, else 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// Per byte of x read as int8: 0x80 where the byte is > 0, else 0.
__device__ __forceinline__ unsigned positive_bytes(unsigned x) {
  return nonzero_bytes(x) & ~x & 0x80808080u;
}

// The 0x80 flags of a word's four bytes as a 4-bit mask (byte j -> bit j).
__device__ __forceinline__ unsigned flags4(unsigned f) {
  return (((f >> 7) * 0x01020408u) >> 24) & 0xfu;
}

// A 4-bit mask as four 0/1 bytes (bit j -> byte j).
__device__ __forceinline__ unsigned bytes4(unsigned m) {
  return ((m & 0xfu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ unsigned flags16(uint4 f) {
  return flags4(f.x) | (flags4(f.y) << 4) | (flags4(f.z) << 8) | (flags4(f.w) << 12);
}

__device__ __forceinline__ uint4 bytes16(unsigned m) {
  return make_uint4(bytes4(m), bytes4(m >> 4), bytes4(m >> 8), bytes4(m >> 12));
}

// Slots of a bool row that are set.
__device__ __forceinline__ uint64_t row_mask(const uint8_t* k, int S) {
  uint64_t m = 0;
  int u = 0;
  if (aligned16(k)) {
    for (; u + 16 <= S; u += 16) {
      const uint4 w = ld16(k + u);
      const uint4 f = make_uint4(nonzero_bytes(w.x), nonzero_bytes(w.y),
                                 nonzero_bytes(w.z), nonzero_bytes(w.w));
      m |= static_cast<uint64_t>(flags16(f)) << u;
    }
  }
  for (; u < S; ++u) if (k[u]) m |= 1ull << u;
  return m;
}

// Slots of a row that are known (k) with retransmit budget left (sl > 0);
// the budget bytes are read only where a 16-slot block knows something.
__device__ __forceinline__ uint64_t queued_mask(const uint8_t* k,
                                                const int8_t* sl, int S) {
  uint64_t m = 0;
  int u = 0;
  if (aligned16(k) && aligned16(sl)) {
    for (; u + 16 <= S; u += 16) {
      const uint4 w = ld16(k + u);
      if ((w.x | w.y | w.z | w.w) == 0) continue;
      const uint4 b = ld16(sl + u);
      const uint4 f = make_uint4(
          nonzero_bytes(w.x) & positive_bytes(b.x),
          nonzero_bytes(w.y) & positive_bytes(b.y),
          nonzero_bytes(w.z) & positive_bytes(b.z),
          nonzero_bytes(w.w) & positive_bytes(b.w));
      m |= static_cast<uint64_t>(flags16(f)) << u;
    }
  }
  for (; u < S; ++u) if (k[u] && sl[u] > 0) m |= 1ull << u;
  return m;
}

}  // namespace consul_kernels
