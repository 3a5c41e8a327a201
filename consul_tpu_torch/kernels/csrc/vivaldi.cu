// K13 vivaldi_ring: one Vivaldi observation per node against its ring peer,
// every probe tick of the serf pool.
//
// Replaces: consul_tpu/models/vivaldi.py observe_ring (the serf tick's
// coordinate update, models/serf.py), which XLA runs and the port's plain
// twin (models/vivaldi.py:observe_ring_plain) runs as some seventy [N] and
// [N, D] passes: three ring pulls, the norms, the error and force terms,
// jax.random.normal's [N, D] spring directions (a K1 launch of its own),
// the masks, gravity, the window column and its mean.
//
// One thread a node row i, in a persistent grid-stride loop, peer j = (i +
// shift) % N with `shift` read on the device:
//   - rtt = max(rtt_ms[i] / 1000, 1e-6) (IEEE division), dist = |c_i -
//     c_j| + h_i + h_j, w = e_i / max(e_i + e_j, 1e-9), the clipped error,
//     the unit spring direction, force = (w * cc) * (rtt - dist), the new
//     coordinates and height; rows that were not acked keep theirs;
//   - a colocated row (|c_i - c_j| <= 1e-9) points along its own draw of
//     jax.random.normal(tick_key(seed, adj_index, 7), [N, D]): element
//     (i, k) is draw i * D + k of the counter-based threefry stream
//     (common.cuh: threefry_lanes, normal_float, as K1 draws it), computed
//     only for those rows;
//   - gravity on the masked coordinates: c * max(1 - q^2, 0), q = |c| *
//     (1 / rho) (the card's twin divides by a host scalar as a multiply by
//     its float reciprocal);
//   - window column `col` = acked ? (rtt - dist) * 0.5 : old, the row
//     copied whole into the fresh window, adjustment = sum(row) * factor.
// Every elementwise step is an explicitly rounded float op in the twin's
// order (__f*_rn, no contraction into FMAs).  The two reductions, the
// squared norm over D and the window sum over W, follow torch's CUDA
// inner reduction at these widths (ATen/native/cuda/Reduce.cuh): lane t of
// a row's bw = largest power of two <= n lanes holds 0 + x[t] (+ 0 +
// x[t + bw]), and the lanes meet in a shuffle tree of offsets bw/2, ...,
// 1; the mean multiplies the sum by float(N) / float(N * W).
//
// Bound on an H100: memory.  The function reads coords, height and error
// once (the peer reads are the same rows), rtt_ms, acked and the window,
// and writes coords, height, error, adjustment and one window column: at
// N = 1M, D = 8, W = 20 that is 32 + 13 + 80 + 44 + 4 = 173 MB, ~0.052 ms
// at 3.35 TB/s.  Writing the window into a fresh tensor (as K7-K12 write
// fresh outputs) adds the other 76 MB: ~0.074 ms.  A thread's row loads
// are strided across the warp (32 and 80 bytes a row); the L1 keeps the
// sectors between a thread's loads.  The serf pool's widths (D = 8, W =
// 20) are compiled as constants with 16-byte row loads and stores; other
// widths take a form that reads them from the arguments.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16;
constexpr int kMaxW = 32;

struct RingArgs {
  const float* coords;    // [N, D]
  const float* height;    // [N]
  const float* error;     // [N]
  const float* window;    // [N, W]
  const float* rtt_ms;    // [N]
  const uint8_t* acked;   // [N]
  const int32_t* shift;   // one int32, on the device
  int64_t N;
  int D, W, col;
  uint32_t k0, k1;        // the spring directions' key
  float normal_lo, normal_span;
  float ce, cc, error_max, height_min, inv_rho, mean_factor;
  float* coords_out;
  float* height_out;
  float* error_out;
  float* window_out;
  float* adjustment_out;
};

__device__ __forceinline__ int64_t ring_shift(const int32_t* shift, int64_t N) {
  const int64_t d = static_cast<int64_t>(*shift) % N;
  return d < 0 ? d + N : d;
}

__host__ __device__ constexpr int log2_floor(int x) {
  return x <= 1 ? 0 : 1 + log2_floor(x / 2);
}

// torch's CUDA sum of x[0..n), n >= BW, over BW = largest power of two
// <= n lanes (see the header).  Every loop has a constant trip count, so
// the indices are compile-time after unrolling and x and the lanes stay
// in registers.
template <int BW, int kMax>
__device__ __forceinline__ float lane_tree_sum(const float (&x)[kMax], int n) {
  float lane[BW];
#pragma unroll
  for (int t = 0; t < BW; ++t) {
    const float a = __fadd_rn(0.0f, x[t]);
    float b = 0.0f;
    if (t + BW < kMax && t + BW < n) b = __fadd_rn(0.0f, x[t + BW < kMax ? t + BW : 0]);
    // the thread's four accumulators, combined in order (two are empty)
    lane[t] = __fadd_rn(__fadd_rn(__fadd_rn(a, b), 0.0f), 0.0f);
  }
  constexpr int kLevels = log2_floor(BW);
#pragma unroll
  for (int level = 1; level <= kLevels; ++level) {
    const int off = BW >> level;  // bw/2, ..., 1
#pragma unroll
    for (int t = 0; t < BW / 2; ++t) {
      if (t < off) lane[t] = __fadd_rn(lane[t], lane[t + off]);
    }
  }
  return lane[0];
}

template <int kMax>
__device__ __forceinline__ float torch_row_sum(const float (&x)[kMax], int n) {
  if (kMax >= 32 && n >= 32) return lane_tree_sum<(kMax >= 32 ? 32 : 1)>(x, n);
  if (kMax >= 16 && n >= 16) return lane_tree_sum<(kMax >= 16 ? 16 : 1)>(x, n);
  if (n >= 8) return lane_tree_sum<8>(x, n);
  if (n >= 4) return lane_tree_sum<4>(x, n);
  if (n >= 2) return lane_tree_sum<2>(x, n);
  return lane_tree_sum<1>(x, n);
}

// sqrt(sum(x * x)) of a row of n values, as the twin's _norm.
template <int kMax>
__device__ __forceinline__ float row_norm(const float (&x)[kMax], int n) {
  float sq[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) sq[k] = k < n ? __fmul_rn(x[k], x[k]) : 0.0f;
  return __fsqrt_rn(torch_row_sum(sq, n));
}

// Row r of a [rows, n] float matrix into x[0..n) (zeros after): 16-byte
// loads when the width is fixed at a multiple of 4 (the host launches
// that form only on 16-byte aligned tensors), else one float at a time.
template <bool kVec, int kMax>
__device__ __forceinline__ void load_row(float (&x)[kMax], const float* m, int64_t r, int n) {
  if constexpr (kVec) {
    const float4* p = reinterpret_cast<const float4*>(m + r * kMax);
#pragma unroll
    for (int q = 0; q < kMax / 4; ++q) {
      const float4 v = p[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMax; ++k) x[k] = k < n ? m[r * n + k] : 0.0f;
  }
}

template <bool kVec, int kMax>
__device__ __forceinline__ void store_row(float* m, int64_t r, int n, const float (&x)[kMax]) {
  if constexpr (kVec) {
    float4* p = reinterpret_cast<float4*>(m + r * kMax);
#pragma unroll
    for (int q = 0; q < kMax / 4; ++q)
      p[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      if (k < n) m[r * n + k] = x[k];
    }
  }
}

// kD, kW: the widths fixed at compile time (the serf pool's D = 8, W = 20,
// with 16-byte row loads and stores), or 0 for any width up to kMaxD and
// kMaxW read from the arguments.
template <int kD, int kW>
__global__ void __launch_bounds__(kThreads)
vivaldi_ring_kernel(const __grid_constant__ RingArgs a) {
  constexpr int AD = kD > 0 ? kD : kMaxD;
  constexpr int AW = kW > 0 ? kW : kMaxW;
  constexpr bool kVecD = kD > 0 && kD % 4 == 0;
  constexpr bool kVecW = kW > 0 && kW % 4 == 0;
  const int64_t N = a.N;
  const int D = kD > 0 ? kD : a.D, W = kW > 0 ? kW : a.W;
  const int64_t d = ring_shift(a.shift, N);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const int64_t j = i + d >= N ? i + d - N : i + d;
    float ci[AD], cj[AD], diff[AD];
    load_row<kVecD>(ci, a.coords, i, D);
    load_row<kVecD>(cj, a.coords, j, D);
#pragma unroll
    for (int k = 0; k < AD; ++k) diff[k] = __fsub_rn(ci[k], cj[k]);
    const float norm = row_norm(diff, D);
    const float hi = a.height[i], ei = a.error[i];
    const float dist = __fadd_rn(__fadd_rn(norm, hi), a.height[j]);
    const float rtt = fmaxf(__fdiv_rn(a.rtt_ms[i], 1000.0f), 1.0e-6f);
    const float w = __fdiv_rn(ei, fmaxf(__fadd_rn(ei, a.error[j]), 1.0e-9f));
    const float err_sample = __fdiv_rn(fabsf(__fsub_rn(dist, rtt)), rtt);
    float new_err = __fadd_rn(__fmul_rn(__fmul_rn(err_sample, a.ce), w),
                              __fmul_rn(ei, __fsub_rn(1.0f, __fmul_rn(w, a.ce))));
    new_err = fminf(fmaxf(new_err, 1.0e-6f), a.error_max);
    const float force = __fmul_rn(__fmul_rn(w, a.cc), __fsub_rn(rtt, dist));
    const bool m = a.acked[i];

    float unit[AD];
    if (norm > 1.0e-9f) {
#pragma unroll
      for (int k = 0; k < AD; ++k) unit[k] = __fdiv_rn(diff[k], norm);
    } else {
      // colocated: the row's own normal draws, elements i * D + k
      const ThreefryKey key = threefry_key(a.k0, a.k1);
      float r[AD];
#pragma unroll
      for (int k = 0; k < AD; ++k) {
        r[k] = 0.0f;
        if (k < D) {
          const uint64_t e = static_cast<uint64_t>(i) * D + k;
          uint32_t b[1];
          threefry_lanes<1>(key, static_cast<uint32_t>(e >> 32), static_cast<uint32_t>(e), b);
          r[k] = normal_float(unit_float(b[0]), a.normal_lo, a.normal_span);
        }
      }
      const float rn = row_norm(r, D);
#pragma unroll
      for (int k = 0; k < AD; ++k) unit[k] = __fdiv_rn(r[k], rn);
    }

    // the masked coordinates, then gravity
    float c[AD];
#pragma unroll
    for (int k = 0; k < AD; ++k) c[k] = m ? __fadd_rn(ci[k], __fmul_rn(unit[k], force)) : ci[k];
    const float q = __fmul_rn(row_norm(c, D), a.inv_rho);
    const float g = fmaxf(__fsub_rn(1.0f, __fmul_rn(q, q)), 0.0f);
#pragma unroll
    for (int k = 0; k < AD; ++k) c[k] = __fmul_rn(c[k], g);
    store_row<kVecD>(a.coords_out, i, D, c);
    const float new_hi = fmaxf(__fadd_rn(hi, __fmul_rn(__fdiv_rn(hi, fmaxf(dist, 1.0e-9f)), force)),
                               a.height_min);
    a.height_out[i] = m ? new_hi : hi;
    a.error_out[i] = m ? new_err : ei;

    // the adjustment window: one column replaced, the row copied, its mean
    float win[AW];
    load_row<kVecW>(win, a.window, i, W);
    const float sample = __fmul_rn(__fsub_rn(rtt, dist), 0.5f);
#pragma unroll
    for (int t = 0; t < AW; ++t) {
      if (t == a.col && m) win[t] = sample;
    }
    store_row<kVecW>(a.window_out, i, W, win);
    a.adjustment_out[i] = __fmul_rn(torch_row_sum(win, W), a.mean_factor);
  }
}

template <int kD, int kW>
cudaError_t launch_ring(const RingArgs& a, cudaStream_t stream) {
  static int per_card = 0;
  const int blocks = persistent_blocks(vivaldi_ring_kernel<kD, kW>, kThreads, a.N, 1 << 20, per_card);
  vivaldi_ring_kernel<kD, kW><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One observe_ring of the pool: every *_out written whole.  1 <= D <= 16, 1 <= W <= 32, 0 <= col < W.
extern "C" int vivaldi_ring(const void* coords, const void* height, const void* error,
                            const void* window, const void* rtt_ms, const void* acked,
                            const void* shift, int64_t N, int D, int W, int col, uint32_t k0,
                            uint32_t k1, float normal_lo, float normal_span, float ce,
                            float cc, float error_max, float height_min, float inv_rho,
                            float mean_factor, void* coords_out, void* height_out,
                            void* error_out, void* window_out, void* adjustment_out,
                            void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || D < 1 || D > kMaxD || W < 1 || W > kMaxW ||
      col < 0 || col >= W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a;
  a.coords = static_cast<const float*>(coords);
  a.height = static_cast<const float*>(height);
  a.error = static_cast<const float*>(error);
  a.window = static_cast<const float*>(window);
  a.rtt_ms = static_cast<const float*>(rtt_ms);
  a.acked = static_cast<const uint8_t*>(acked);
  a.shift = static_cast<const int32_t*>(shift);
  a.N = N;
  a.D = D;
  a.W = W;
  a.col = col;
  a.k0 = k0;
  a.k1 = k1;
  a.normal_lo = normal_lo;
  a.normal_span = normal_span;
  a.ce = ce;
  a.cc = cc;
  a.error_max = error_max;
  a.height_min = height_min;
  a.inv_rho = inv_rho;
  a.mean_factor = mean_factor;
  a.coords_out = static_cast<float*>(coords_out);
  a.height_out = static_cast<float*>(height_out);
  a.error_out = static_cast<float*>(error_out);
  a.window_out = static_cast<float*>(window_out);
  a.adjustment_out = static_cast<float*>(adjustment_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool rows16 = a16(coords) && a16(window) && a16(coords_out) && a16(window_out);
  if (D == 8 && W == 20 && rows16) return static_cast<int>(launch_ring<8, 20>(a, s));
  return static_cast<int>(launch_ring<0, 0>(a, s));
}
