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
// Per node row i, peer j = (i + shift) % N with `shift` read on the device
// (common to both forms below, observe()):
//   - rtt = max(rtt_ms[i] / 1000, 1e-6) (IEEE division), dist = |c_i -
//     c_j| + h_i + h_j, w = e_i / max(e_i + e_j, 1e-9), the clipped error,
//     the unit spring direction, force = (w * cc) * (rtt - dist), the new
//     coordinates and height; rows that were not acked keep theirs;
//   - a colocated row (|c_i - c_j| <= 1e-9) points along its own draw of
//     jax.random.normal(tick_key(seed, adj_index, 7), [N, D]): element
//     (i, k) is draw i * D + k of the counter-based threefry stream
//     (common.cuh: threefry_lanes, normal_float, as K1 draws it), computed
//     only for those rows, a draw at a time in a function of its own
//     (__noinline__, returning a float: no array on the stack), so the
//     threefry rounds take no registers from the common path;
//   - gravity on the masked coordinates: c * max(1 - q^2, 0), q = |c| *
//     (1 / rho) (the card's twin divides by a host scalar as a multiply by
//     its float reciprocal);
//   - window column `col` = acked ? (rtt - dist) * 0.5 : old, adjustment =
//     sum(row) * factor.
// Every elementwise step is an explicitly rounded float op in the twin's
// order (__f*_rn, no contraction into FMAs).  The two reductions, the
// squared norm over D and the window sum over W, follow torch's CUDA
// inner reduction at these widths (ATen/native/cuda/Reduce.cuh): lane t of
// a row's bw = largest power of two <= n lanes holds 0 + x[t] (+ 0 +
// x[t + bw]), and the lanes meet in a shuffle tree of offsets bw/2, ...,
// 1; the mean multiplies the sum by float(N) / float(N * W).
//
// In place: the window and the adjustment.  The window column is stored
// only on acked rows; adjustment is an output only, written into the
// state's own tensor.  Coordinates, height and
// error are fresh outputs: row i reads them at its peer j, so a kernel
// writing them in place would race with the row whose peer it is, unless
// it held all of the peer data (40 MB at N = 1M) across a grid barrier.
// A fresh output costs no bytes against the bound: gravity rewrites every
// row's coordinates, so those leaves are written whole either way.
//
// The serf pool's widths (D = 8, W = 20) run a tiled form: a persistent
// grid of 64-thread blocks walks tiles of 64 contiguous rows, a thread a
// row.  A tile's own coordinate rows, its peers' rows (the contiguous rows
// (i0 + shift) % N .., split where they wrap past N; 32-byte rows, so
// always 16-byte aligned) and its window rows are staged in shared memory
// by 16-byte cp.async copies, kStages = 4 tiles deep: the next three
// tiles' copies, and the next tile's [N] vectors (height, error, rtt_ms,
// acked at i and at j, loaded into registers), are in flight while this
// tile computes.  Each thread then computes its row from shared memory,
// writes its new coordinates back into the tile, and the block stores the
// tile as coalesced 16-byte vectors.  An acked row stores its window
// column as the whole 32-byte sector around it (the sector's other floats
// from the tile in shared memory, unchanged by the launch), so no partial
// sector is left for the memory to merge.  79 registers and 36 KB of
// dynamic shared memory a block: six blocks an SM.  The depth and the
// tile were chosen on the card: two 128-row tiles a block (twice the
// warps an SM, fewer bytes in flight) ran slower.  Other widths
// (up to kMaxD, kMaxW; the WAN pool's are the same) take a plain form, a
// thread a row, that loads its rows element by element.  Both keep N
// smaller than a tile working (the WAN pool has 15 nodes).
//
// Block form (a node-sharded pool, parallel/mesh.py): a launch a block
// over its rows [row0, row_end), its own leaves at shifted pointers, the
// peer's coordinate row, height and error read through block tables (a
// tile's peer rows split where they wrap past N and, per row, where they
// cross a block: each 16-byte copy finds its row's block).  The
// reductions run row by row as before, so a block's rows get the bits
// the one-device launch gives them (with the mean's factor float(N) /
// float(N * W) of the pool, passed by the host).  The one-device launch
// is the kOne instantiation.
//
// Bound on an H100: memory.  The function reads coords, height and error
// once (the peer reads are the same rows), rtt_ms, acked and the window,
// and writes coords, height, error and adjustment whole and, in place, the
// window column on acked rows: one 32-byte sector a row.  At N = 1M, D =
// 8, W = 20 that is 32 + 12 + 1 + 4 + 80 (reads) + 32 + 8 + 4 + ~32
// (writes) = ~205 MB, ~0.061 ms at 3.35 TB/s
// (chip_smoke.py:_ring_bytes counts it from the run's data).  The tiled
// form moves ~32 MB more: a tile reads its peers' coordinate rows apart
// from their own tile's read of them.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;  // the plain form's block
constexpr int kTile = 64;      // the tiled form's rows a tile, and its block
constexpr int kStages = 4;     // tiles a block has staged or in flight
constexpr int kMaxD = 16;
constexpr int kMaxW = 32;

struct RingArgs {
  const float* coords;    // [N, D]
  const float* height;    // [N]
  const float* error;     // [N]
  float* window;          // [N, W], its column `col` updated in place
  const float* rtt_ms;    // [N]
  const uint8_t* acked;   // [N]
  const int32_t* shift;   // one int32, on the device
  int64_t N;
  int D, W, col;
  uint32_t k0, k1;        // the spring directions' key
  float normal_lo, normal_span;
  float ce, cc, error_max, height_min, inv_rho, mean_factor;
  float* coords_out;      // [N, D], fresh
  float* height_out;      // [N], fresh
  float* error_out;       // [N], fresh
  float* adjustment;      // [N], written whole
  // the launch's rows and the peers' tables (coords rows of D floats)
  int64_t row0, row_end;
  MutRows<float> t_coords, t_height, t_error;
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

// Element e of the colocated rows' normal draws.  Out of line: the
// threefry rounds and erf_inv take their registers only on that path, and
// a float return needs no stack.
__device__ __noinline__ float colocated_draw(uint64_t e, uint32_t k0, uint32_t k1, float lo,
                                             float span) {
  uint32_t b[1];
  threefry_lanes<1>(threefry_key(k0, k1), static_cast<uint32_t>(e >> 32),
                    static_cast<uint32_t>(e), b);
  return normal_float(unit_float(b[0]), lo, span);
}

// One row's observation (see the header).  ci / cj / win hold the row's
// coordinates, its peer's and its window (zeros past D and W); on return
// c holds the new coordinates, win the new window row (column col
// replaced where acked), sample the new column value and the scalars
// their new values.
template <int AD, int AW>
__device__ __forceinline__ void observe(const RingArgs& a, int D, int W, int64_t i,
                                        const float (&ci)[AD], const float (&cj)[AD],
                                        float hi, float ei, float hj, float ej, float rtt_ms,
                                        bool m, float (&win)[AW], float (&c)[AD],
                                        float& h_out, float& e_out, float& adj,
                                        float& sample) {
  float diff[AD];
#pragma unroll
  for (int k = 0; k < AD; ++k) diff[k] = __fsub_rn(ci[k], cj[k]);
  const float norm = row_norm(diff, D);
  const float dist = __fadd_rn(__fadd_rn(norm, hi), hj);
  const float rtt = fmaxf(__fdiv_rn(rtt_ms, 1000.0f), 1.0e-6f);
  const float w = __fdiv_rn(ei, fmaxf(__fadd_rn(ei, ej), 1.0e-9f));
  const float err_sample = __fdiv_rn(fabsf(__fsub_rn(dist, rtt)), rtt);
  float new_err = __fadd_rn(__fmul_rn(__fmul_rn(err_sample, a.ce), w),
                            __fmul_rn(ei, __fsub_rn(1.0f, __fmul_rn(w, a.ce))));
  new_err = fminf(fmaxf(new_err, 1.0e-6f), a.error_max);
  const float force = __fmul_rn(__fmul_rn(w, a.cc), __fsub_rn(rtt, dist));

  float unit[AD];
  if (norm > 1.0e-9f) {
#pragma unroll
    for (int k = 0; k < AD; ++k) unit[k] = __fdiv_rn(diff[k], norm);
  } else {
    // colocated: the row's own normal draws, elements i * D + k
    float r[AD];
#pragma unroll
    for (int k = 0; k < AD; ++k) {
      r[k] = k < D ? colocated_draw(static_cast<uint64_t>(i) * D + k, a.k0, a.k1, a.normal_lo,
                                    a.normal_span)
                   : 0.0f;
    }
    const float rn = row_norm(r, D);
#pragma unroll
    for (int k = 0; k < AD; ++k) unit[k] = __fdiv_rn(r[k], rn);
  }

  // the masked coordinates, then gravity
#pragma unroll
  for (int k = 0; k < AD; ++k) c[k] = m ? __fadd_rn(ci[k], __fmul_rn(unit[k], force)) : ci[k];
  const float q = __fmul_rn(row_norm(c, D), a.inv_rho);
  const float g = fmaxf(__fsub_rn(1.0f, __fmul_rn(q, q)), 0.0f);
#pragma unroll
  for (int k = 0; k < AD; ++k) c[k] = __fmul_rn(c[k], g);
  const float new_hi = fmaxf(__fadd_rn(hi, __fmul_rn(__fdiv_rn(hi, fmaxf(dist, 1.0e-9f)), force)),
                             a.height_min);
  h_out = m ? new_hi : hi;
  e_out = m ? new_err : ei;

  // the adjustment window: one column replaced, its mean
  sample = __fmul_rn(__fsub_rn(rtt, dist), 0.5f);
#pragma unroll
  for (int t = 0; t < AW; ++t) {
    if (t == a.col && m) win[t] = sample;
  }
  adj = __fmul_rn(torch_row_sum(win, W), a.mean_factor);
}

// --- the tiled form (D, W multiples of 4) -----------------------------------

template <int kD, int kW>
struct Tile {
  float own[kTile * kD];   // the tile's coordinate rows, then its new ones
  float peer[kTile * kD];  // its peers' coordinate rows
  float win[kTile * kW];   // its window rows
};

// The [N] vectors of one row and its peer, loaded a tile ahead.
struct RowIn {
  float hi, ei, hj, ej, rtt_ms;
  bool m;
};

template <bool kOne>
__device__ __forceinline__ RowIn load_row_in(const RingArgs& a, int64_t i, int64_t d) {
  RowIn r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  if (i < a.row_end) {
    const int64_t j = i + d >= a.N ? i + d - a.N : i + d;
    r.hi = a.height[i];
    r.ei = a.error[i];
    r.hj = a.t_height.at<kOne>(j);
    r.ej = a.t_error.at<kOne>(j);
    r.rtt_ms = a.rtt_ms[i];
    r.m = a.acked[i];
  }
  return r;
}

__device__ __forceinline__ int tile_rows(int64_t i0, int64_t N) {
  return N - i0 < kTile ? static_cast<int>(N - i0) : kTile;
}

// The block's cp.async copies of the tile from row i0 into t.
template <int kD, int kW, bool kOne>
__device__ __forceinline__ void stage(Tile<kD, kW>& t, const RingArgs& a, int64_t i0, int64_t d) {
  constexpr int cD = kD / 4, cW = kW / 4;  // 16-byte chunks a row
  const int64_t N = a.N;
  const int rows = tile_rows(i0, a.row_end);
  const int64_t j0 = i0 + d >= N ? i0 + d - N : i0 + d;
  for (int c = threadIdx.x; c < rows * cD; c += blockDim.x) {
    const int r = c / cD;
    const int64_t j = j0 + r >= N ? j0 + r - N : j0 + r;
    cp_async16(&t.own[4 * c], a.coords + i0 * kD + 4 * c);
    cp_async16(&t.peer[4 * c], a.t_coords.row<kOne>(j, kD) + 4 * (c - r * cD));
  }
  for (int c = threadIdx.x; c < rows * cW; c += blockDim.x) {
    cp_async16(&t.win[4 * c], a.window + i0 * kW + 4 * c);
  }
}

template <int n>
__device__ __forceinline__ void shared_row(float (&x)[n], const float* s) {
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(s)[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

template <int kD, int kW, bool kOne>
__global__ void __launch_bounds__(kTile)
vivaldi_tile_kernel(const __grid_constant__ RingArgs a) {
  static_assert(kD % 4 == 0 && kW % 4 == 0 && kW >= 8 && kTile * kW % 8 == 0,
                "tiles of whole 16-byte rows and whole 32-byte window sectors");
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<kD, kW>* buf = reinterpret_cast<Tile<kD, kW>*>(smem);  // kStages tiles
  const int64_t N = a.N;
  const int64_t d = ring_shift(a.shift, N);
  const int64_t tiles = (a.row_end - a.row0 + kTile - 1) / kTile;
  const int64_t G = gridDim.x;
  int64_t t = blockIdx.x;
  if (t >= tiles) return;  // block-uniform
  // the copies of this block's first kStages - 1 tiles, a commit group
  // each (empty past the last tile)
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (t + k * G < tiles) stage<kD, kW, kOne>(buf[k], a, a.row0 + (t + k * G) * kTile, d);
    cp_async_commit();
  }
  RowIn cur = load_row_in<kOne>(a, a.row0 + t * kTile + threadIdx.x, d);
  int b = 0;
  for (; t < tiles; t += G) {
    // the tile kStages - 1 ahead, into the buffer the last tile freed
    const int64_t ahead = t + (kStages - 1) * G;
    if (ahead < tiles) {
      stage<kD, kW, kOne>(buf[b == 0 ? kStages - 1 : b - 1], a, a.row0 + ahead * kTile, d);
    }
    cp_async_commit();
    const RowIn nxt =
        t + G < tiles ? load_row_in<kOne>(a, a.row0 + (t + G) * kTile + threadIdx.x, d) : cur;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this tile's copies, every thread's, have landed

    Tile<kD, kW>& tb = buf[b];
    const int64_t i0 = a.row0 + t * kTile;
    const int rows = tile_rows(i0, a.row_end);
    const int r = threadIdx.x;
    if (r < rows) {
      const int64_t i = i0 + r;
      float ci[kD], cj[kD], win[kW], c[kD];
      shared_row(ci, &tb.own[r * kD]);
      shared_row(cj, &tb.peer[r * kD]);
      shared_row(win, &tb.win[r * kW]);
      float h, e, adj, sample;
      observe<kD, kW>(a, kD, kW, i, ci, cj, cur.hi, cur.ei, cur.hj, cur.ej, cur.rtt_ms, cur.m,
                      win, c, h, e, adj, sample);
#pragma unroll
      for (int q = 0; q < kD / 4; ++q) {
        reinterpret_cast<float4*>(&tb.own[r * kD])[q] =
            make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
      }
      a.height_out[i] = h;
      a.error_out[i] = e;
      a.adjustment[i] = adj;
      if (cur.m) {
        // the column's whole 32-byte sector, so no partial sector is left
        // for the memory to merge: the tile's window starts on a sector
        // (kTile * kW floats are whole sectors), and no other row's column
        // lies in the sector (columns are kW >= 8 floats apart), so its
        // other floats are this tile's old values, unchanged by the launch;
        // the float alone where the sector runs past the tile's last row
        const int el = r * kW + a.col, s0 = el & ~7;
        if (s0 + 8 <= rows * kW) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = s0 + k == el ? sample : tb.win[s0 + k];
          float4* dst = reinterpret_cast<float4*>(a.window + i0 * kW + s0);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          a.window[i * kW + a.col] = sample;
        }
      }
    }
    __syncthreads();  // the tile's new coordinates, every row's
    float4* dst = reinterpret_cast<float4*>(a.coords_out + i0 * kD);
    const float4* src = reinterpret_cast<const float4*>(tb.own);
    for (int q = threadIdx.x; q < rows * (kD / 4); q += blockDim.x) dst[q] = src[q];
    __syncthreads();  // the buffer is free for the next iteration's copies
    cur = nxt;
    b = b + 1 < kStages ? b + 1 : 0;
  }
}

// --- the plain form (any width up to kMaxD, kMaxW) ------------------------

template <bool kOne>
__global__ void __launch_bounds__(kThreads)
vivaldi_ring_kernel(const __grid_constant__ RingArgs a) {
  const int64_t N = a.N;
  const int D = a.D, W = a.W;
  const int64_t d = ring_shift(a.shift, N);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = a.row0 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.row_end; i += stride) {
    const int64_t j = i + d >= N ? i + d - N : i + d;
    const float* crow_j = a.t_coords.row<kOne>(j, D);
    float ci[kMaxD], cj[kMaxD], win[kMaxW], c[kMaxD];
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      ci[k] = k < D ? a.coords[i * D + k] : 0.0f;
      cj[k] = k < D ? crow_j[k] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) win[k] = k < W ? a.window[i * W + k] : 0.0f;
    const bool m = a.acked[i];
    float h, e, adj, sample;
    observe<kMaxD, kMaxW>(a, D, W, i, ci, cj, a.height[i], a.error[i],
                          a.t_height.at<kOne>(j), a.t_error.at<kOne>(j), a.rtt_ms[i], m, win,
                          c, h, e, adj, sample);
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      if (k < D) a.coords_out[i * D + k] = c[k];
    }
    a.height_out[i] = h;
    a.error_out[i] = e;
    a.adjustment[i] = adj;
    if (m) a.window[i * W + a.col] = sample;
  }
}

}  // namespace

// One observe_ring of the pool: coords_out, height_out, error_out and
// adjustment written whole, the window's column `col` on acked rows.
// 1 <= D <= 16, 1 <= W <= 32, 0 <= col < W.  The block form: global rows
// [row0, row0 + rows) of N with every leaf of the signature the block's
// own and `tables` the peers' coords, height and error (3 tables of B
// base pointers, L rows a block); the one-device launch passes row0 = 0,
// rows = N and B = 1 tables of its own leaves.
extern "C" int vivaldi_ring(const void* coords, const void* height, const void* error,
                            void* window, const void* rtt_ms, const void* acked,
                            const void* shift, int64_t N, int D, int W, int col, uint32_t k0,
                            uint32_t k1, float normal_lo, float normal_span, float ce,
                            float cc, float error_max, float height_min, float inv_rho,
                            float mean_factor, void* coords_out, void* height_out,
                            void* error_out, void* adjustment, int64_t row0, int64_t rows,
                            const void* tables, int B, int64_t L, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || D < 1 || D > kMaxD || W < 1 || W > kMaxW ||
      col < 0 || col >= W || row0 < 0 || rows < 1 || row0 + rows > N || B < 1 ||
      B > kMaxBlocks || !tables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a;
  a.coords = shifted<const float>(const_cast<void*>(coords), row0, D);
  a.height = shifted<const float>(const_cast<void*>(height), row0);
  a.error = shifted<const float>(const_cast<void*>(error), row0);
  a.window = shifted<float>(window, row0, W);
  a.rtt_ms = shifted<const float>(const_cast<void*>(rtt_ms), row0);
  a.acked = shifted<const uint8_t>(const_cast<void*>(acked), row0);
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
  a.coords_out = shifted<float>(coords_out, row0, D);
  a.height_out = shifted<float>(height_out, row0);
  a.error_out = shifted<float>(error_out, row0);
  a.adjustment = shifted<float>(adjustment, row0);
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.t_coords = mut_rows<float>(tables, 0, B, L);
  a.t_height = mut_rows<float>(tables, 1, B, L);
  a.t_error = mut_rows<float>(tables, 2, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  bool peers16 = true;
  for (int b = 0; b < B; ++b) peers16 = peers16 && a16(a.t_coords.base[b]);
  if (D == 8 && W == 20 && a16(coords) && a16(window) && a16(coords_out) && peers16) {
    constexpr size_t bytes = kStages * sizeof(Tile<8, 20>);
    if (B == 1) {
      static PerCard per_card;
      if (per_card.here() == 0) {  // the attribute is the current card's
        const cudaError_t sized = cudaFuncSetAttribute(
            vivaldi_tile_kernel<8, 20, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (sized != cudaSuccess) return static_cast<int>(sized);
      }
      const int blocks = persistent_blocks(vivaldi_tile_kernel<8, 20, true>, kTile, rows,
                                           1 << 20, per_card, bytes);
      vivaldi_tile_kernel<8, 20, true><<<blocks, kTile, bytes, s>>>(a);
    } else {
      static PerCard per_card;
      if (per_card.here() == 0) {
        const cudaError_t sized = cudaFuncSetAttribute(
            vivaldi_tile_kernel<8, 20, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (sized != cudaSuccess) return static_cast<int>(sized);
      }
      const int blocks = persistent_blocks(vivaldi_tile_kernel<8, 20, false>, kTile, rows,
                                           1 << 20, per_card, bytes);
      vivaldi_tile_kernel<8, 20, false><<<blocks, kTile, bytes, s>>>(a);
    }
  } else if (B == 1) {
    static PerCard per_card;
    const int blocks =
        persistent_blocks(vivaldi_ring_kernel<true>, kThreads, rows, 1 << 20, per_card);
    vivaldi_ring_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    static PerCard per_card;
    const int blocks =
        persistent_blocks(vivaldi_ring_kernel<false>, kThreads, rows, 1 << 20, per_card);
    vivaldi_ring_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
