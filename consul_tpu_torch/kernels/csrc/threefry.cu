// K1 threefry_bits: counter-based threefry2x32 random bits, one thread per
// output element.
//
// Replaces: the jax.random draws of the JAX package (consul_tpu/utils/
// prng.py tick_key streams under rolls.offsets, gossip.disseminate's
// bernoulli loss mask, _probe_round's uniform/exponential draws and
// vivaldi.observe_ring's normal draw).  jax 0.9 with
// jax_threefry_partitionable=True draws element i of a shape as
// threefry2x32(key, (i >> 32, i & 0xffffffff)) and returns x0 ^ x1; this
// kernel computes exactly that, so the port's streams equal the JAX ones
// bit for bit.
//
// Bound on an H100: each element costs ~20 rounds of 32-bit add/rotate/
// xor (~110 integer operations) against 4 bytes written, so at 1M-3M
// elements the kernel is bound by the integer pipes, not by memory.  The
// design keeps everything in registers: one 64-bit counter in, one word
// out, a grid-stride loop so any n launches a fixed grid.
//
// mode 0 writes the raw 32 bits; mode 1 writes jax.random.uniform's
// float32 in [0, 1): (bits >> 9 | 0x3f800000) reinterpreted, minus 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1,
                                       int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, int64_t n,
                                     int mode, uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t b = threefry_xor(k0, k1, static_cast<uint64_t>(i));
    if (mode == 1) {
      b = __float_as_uint(__uint_as_float((b >> 9) | 0x3f800000u) - 1.0f);
    }
    out[i] = b;
  }
}

}  // namespace

extern "C" int threefry_bits(uint32_t k0, uint32_t k1, int64_t n, int mode,
                             void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  threefry_bits_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, mode, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
