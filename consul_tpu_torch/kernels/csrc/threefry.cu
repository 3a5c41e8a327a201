// K1 threefry_bits: counter-based threefry2x32 random bits, one thread per
// output element.
//
// Replaces: the jax.random draws of the JAX package (consul_tpu/utils/
// prng.py tick_key streams under rolls.offsets, _probe_round's uniform/
// exponential draws and vivaldi.observe_ring's normal draw).  jax 0.9
// with jax_threefry_partitionable=True draws element i of a shape as
// threefry2x32(key, (i >> 32, i & 0xffffffff)) and returns x0 ^ x1; this
// kernel computes exactly that (threefry_xor in common.cuh, which K2's
// fused loss draw shares), so the port's streams equal the JAX ones bit
// for bit.
//
// Bound on an H100: each element costs ~20 rounds of 32-bit add/rotate/
// xor (~110 integer operations) against 4 bytes written, so at 1M-3M
// elements the kernel is bound by the integer pipes, not by memory.  The
// design keeps everything in registers: one 64-bit counter in, one word
// out, a grid-stride loop so any n launches a fixed grid.
//
// mode 0 writes the raw 32 bits; mode 1 writes jax.random.uniform's
// float32 in [0, 1): (bits >> 9 | 0x3f800000) reinterpreted, minus 1.

#include "common.cuh"

using namespace consul_kernels;

namespace {

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, int64_t n,
                                     int mode, uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t b = threefry_xor(k0, k1, static_cast<uint64_t>(i));
    if (mode == 1) b = __float_as_uint(unit_float(b));
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
