// Shared helpers for the port's kernels.
//
// Grids: the kernels run a persistent grid (a few blocks per SM, as many
// as the occupancy calculator fits) that walks the rows in a grid-stride
// loop, so per-block set-up is paid once per block rather than once per
// 256 rows.
//
// Counters: each block sums its threads' counters with warp shuffles and
// writes one partial per counter into its own slot of a scratch array;
// one atomic per block counts the blocks done.  The last block sums the
// partials and publishes the totals, then resets the count, so a launch
// needs no memset or finalize kernel and the integer totals are exact.
//
// Random bits: threefry2x32 with the xor fold of jax 0.9's partitionable
// streams, on L interleaved lanes (K1 runs four a thread, K2's fused loss
// draw one).
//
// Rows: a node's [S] row of bool/int8 slots is read as 16-byte vectors
// where the row is 16-byte aligned (S a multiple of 16), byte by byte
// otherwise, and summarized as a 64-bit slot mask (S <= 64).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace consul_kernels {

using u64 = unsigned long long;

// --- grids -----------------------------------------------------------------

// The SM count times a kernel's blocks per SM, asked once per card: a
// launch site keeps one `static PerCard` and reads its entry for the
// current device, so one process can drive the cards of a mesh.
constexpr int kMaxCards = 64;
struct PerCard {
  int blocks[kMaxCards] = {};
  // the current card's entry (0 until asked); a card past kMaxCards gets
  // a scratch entry that is asked again at every launch
  int& here() {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 0 && dev < kMaxCards) return blocks[dev];
    thread_local int spare;
    spare = 0;
    return spare;
  }
};

// Blocks of `threads` for a persistent grid of `kernel` over n rows: all
// the blocks the SMs hold at once (with `smem` bytes of dynamic shared
// memory each), no more than the rows need and no more than `cap` (the
// per-block slots of the counter scratch).  The SM count and the kernel's
// blocks per SM are asked once per card and kept in `per_card`.
template <typename F>
inline int persistent_blocks(F kernel, int threads, int64_t n, int cap,
                             PerCard& cache, size_t smem = 0) {
  int& per_card = cache.here();
  if (per_card == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    per_card = sms * (per_sm > 0 ? per_sm : 1);
  }
  int64_t blocks = per_card;
  const int64_t need = (n + threads - 1) / threads;
  if (blocks > need) blocks = need;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// --- block tables ----------------------------------------------------------

// A node-axis leaf cut into B blocks of L rows (parallel/mesh.py): block
// b holds rows [bL, (b + 1)L) at base[b], on any card whose memory the
// launching card can reach (its own, or a peer's over NVLink).  A kernel
// takes it by value (__grid_constant__) and reads row i at at(i); a leaf
// on one device is the B = 1 table.  N = B * L < 2^31.
constexpr int kMaxBlocks = 16;

template <typename T>
struct BlockRows {
  const T* base[kMaxBlocks];
  int64_t L;
  int B;

  // kOne: the caller knows B == 1 (a kernel compiled for one block
  // keeps no division in its loop)
  template <bool kOne = false>
  __device__ __forceinline__ const T* row(int64_t i) const {
    if (kOne || B == 1) return base[0] + i;
    const uint32_t b = static_cast<uint32_t>(i) / static_cast<uint32_t>(L);
    return base[b] + (i - static_cast<int64_t>(b) * L);
  }
  template <bool kOne = false>
  __device__ __forceinline__ T at(int64_t i) const { return *row<kOne>(i); }
};

// The table of B host-side base pointers (a host array, null for a leaf
// the caller does not pass: then base[0] is null).
template <typename T>
inline BlockRows<T> block_rows(const void* bases, int B, int64_t L) {
  BlockRows<T> t{};
  t.L = L;
  t.B = B;
  const void* const* p = static_cast<const void* const*>(bases);
  for (int b = 0; b < B && b < kMaxBlocks; ++b) {
    t.base[b] = p != nullptr ? static_cast<const T*>(p[b]) : nullptr;
  }
  return t;
}

// A writable table: the same rows for the kernels that write a cell of
// another block (a probe's target, a subject's committed leaves), and
// width-W rows of an [N, W] leaf (row i's first element at row(i, W)).
template <typename T>
struct MutRows {
  T* base[kMaxBlocks];
  int64_t L;
  int B;

  template <bool kOne = false>
  __device__ __forceinline__ T* row(int64_t i, int64_t width = 1) const {
    if (kOne || B == 1) return base[0] + i * width;
    const uint32_t b = static_cast<uint32_t>(i) / static_cast<uint32_t>(L);
    return base[b] + (i - static_cast<int64_t>(b) * L) * width;
  }
  template <bool kOne = false>
  __device__ __forceinline__ T at(int64_t i) const { return *row<kOne>(i); }
};

// Table t of a block form's host table array: `tables` holds T tables of
// B base pointers each, table t at tables[t * B].
template <typename T>
inline MutRows<T> mut_rows(const void* tables, int t, int B, int64_t L) {
  MutRows<T> m{};
  m.L = L;
  m.B = B;
  const void* const* p = static_cast<const void* const*>(tables);
  for (int b = 0; b < B && b < kMaxBlocks; ++b) {
    m.base[b] = p != nullptr ? static_cast<T*>(const_cast<void*>(p[t * B + b])) : nullptr;
  }
  return m;
}

// A block form's pointer to its own leaf (global rows [row0, row0 + L)),
// shifted so that global row i reads local row i - row0 (host side); a
// one-device launch is row0 = 0.
template <typename T>
inline T* shifted(void* p, int64_t row0, int64_t width = 1) {
  return p == nullptr ? nullptr : static_cast<T*>(p) - row0 * width;
}

// --- subjects --------------------------------------------------------------

// A rumor's subject as JAX's scatter takes an index into [N]: one in
// [-N, 0) wraps once to subject + N; the caller drops any result outside
// [0, N).
__device__ __forceinline__ int64_t wrapped(int32_t subject, int64_t N) {
  return subject < 0 ? subject + N : static_cast<int64_t>(subject);
}

// --- copies ----------------------------------------------------------------

// 16 bytes from device memory into shared memory without a register
// (both 16-byte aligned); the copies since the last commit form a group.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` committed groups (the newest) are still in
// flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// --- counters --------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sums of K per-thread counters into red[k][0] (every thread
// must call it; blockDim.x a multiple of 32, at most 1024).  T is u64 for
// exact counts or double (K14's float sums, in a fixed order).
template <int K, typename T>
__device__ void block_sum(const T (&v)[K], T (&red)[K][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // red may still be read from an earlier call
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T s = warp_sum(v[k]);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T s = warp_sum(lane < nwarps ? red[k][lane] : T(0));
      if (lane == 0) red[k][0] = s;
    }
  }
  __syncthreads();
}

// Grid-wide sums of K per-thread counters.  scratch holds one u64 block
// count followed by K partials per block (gridDim.x * K, 8-byte T).
// Returns true in thread 0 of the last block to finish, with the grid
// totals in tot.  Each block's partial has its own slot and the last
// block adds them in block order, so a float total is the same on every
// run of the same grid.
template <int K, typename T>
__device__ bool grid_sum(const T (&v)[K], u64* scratch, T (&tot)[K]) {
  static_assert(sizeof(T) == sizeof(u64), "grid_sum partials are 8 bytes");
  __shared__ T red[K][32];
  __shared__ bool last;
  u64* done = scratch;
  T* partials = reinterpret_cast<T*>(scratch + 1);
  block_sum<K>(v, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[blockIdx.x * K + k] = red[k][0];
    __threadfence();
    last = atomicAdd(done, 1ull) == static_cast<u64>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return false;  // block-uniform
  __threadfence();
  T mine[K];
#pragma unroll
  for (int k = 0; k < K; ++k) mine[k] = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int k = 0; k < K; ++k) mine[k] += __ldcg(&partials[b * K + k]);
  }
  block_sum<K>(mine, red);
  if (threadIdx.x != 0) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) tot[k] = red[k][0];
  *done = 0;  // ready for the next launch
  return true;
}

// Sums of K per-thread values over a cooperative grid, in two halves
// around the caller's grid barrier.  block_partials writes each block's
// sums into its own slots, part[blockIdx.x * stride + k]; after the
// barrier grid_totals gives every block the same totals: thread t adds the
// partials of blocks t, t + blockDim.x, ... in that order, then the block
// adds its threads' sums in block_sum's fixed shuffle order, so every
// block, and every launch of the same grid, gets the same bits.  No slot
// needs a reset (each launch overwrites its own).  Every thread of every
// block must call both.  (K14's float sums, in doubles: every block reads
// every block's partials, so the reads grow with the grid's square.)
template <int K, typename T>
__device__ void block_partials(const T (&v)[K], T (&red)[K][32], T* part, int stride) {
  block_sum<K>(v, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[static_cast<int64_t>(blockIdx.x) * stride + k] = red[k][0];
  }
}

template <int K, typename T>
__device__ void grid_totals(const T* part, int stride, T (&red)[K][32], T (&tot)[K]) {
  T mine[K];
#pragma unroll
  for (int k = 0; k < K; ++k) mine[k] = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int k = 0; k < K; ++k) mine[k] += __ldcg(&part[static_cast<int64_t>(b) * stride + k]);
  }
  block_sum<K>(mine, red);
#pragma unroll
  for (int k = 0; k < K; ++k) tot[k] = red[k][0];
}

// --- random bits -----------------------------------------------------------

// The key schedule of threefry2x32 for key (k0, k1), as the host also
// builds it (kernels/__init__.py:_schedule): k0, k1, k2 = k0 ^ k1 ^
// 0x1BD11BDA, then the x1 injections after each group of four rounds,
// k2 + 1, k0 + 2, k1 + 3, k2 + 4, k0 + 5 (the x0 injections are k1, k2,
// k0, k1, k2).
struct ThreefryKey {
  uint32_t k[8];
};

__device__ __forceinline__ ThreefryKey threefry_key(uint32_t k0, uint32_t k1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  return {{k0, k1, k2, k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u}};
}

// One round on L independent chains, interleaved so the integer pipes
// have L independent instructions between dependent ones; the rotation is
// a compile-time funnel shift.
template <int R, int L>
__device__ __forceinline__ void threefry_mix(uint32_t (&x0)[L], uint32_t (&x1)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    x0[j] += x1[j];
    x1[j] = __funnelshift_l(x1[j], x1[j], R) ^ x0[j];
  }
}

template <int L>
__device__ __forceinline__ void threefry_inject(uint32_t (&x0)[L], uint32_t (&x1)[L],
                                                uint32_t a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    x0[j] += a;
    x1[j] += b;
  }
}

// x0 ^ x1 of threefry2x32(key, (hi, lo + j)) for j < L: elements hi * 2^32
// + lo + j of a jax.random draw (jax 0.9, jax_threefry_partitionable=True;
// lo + L - 1 must not carry into hi).
template <int L>
__device__ __forceinline__ void threefry_lanes(const ThreefryKey& key, uint32_t hi,
                                               uint32_t lo, uint32_t (&out)[L]) {
  const uint32_t* k = key.k;
  uint32_t x0[L], x1[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    x0[j] = hi + k[0];
    x1[j] = lo + static_cast<uint32_t>(j) + k[1];
  }
  threefry_mix<13>(x0, x1); threefry_mix<15>(x0, x1);
  threefry_mix<26>(x0, x1); threefry_mix<6>(x0, x1);
  threefry_inject(x0, x1, k[1], k[3]);
  threefry_mix<17>(x0, x1); threefry_mix<29>(x0, x1);
  threefry_mix<16>(x0, x1); threefry_mix<24>(x0, x1);
  threefry_inject(x0, x1, k[2], k[4]);
  threefry_mix<13>(x0, x1); threefry_mix<15>(x0, x1);
  threefry_mix<26>(x0, x1); threefry_mix<6>(x0, x1);
  threefry_inject(x0, x1, k[0], k[5]);
  threefry_mix<17>(x0, x1); threefry_mix<29>(x0, x1);
  threefry_mix<16>(x0, x1); threefry_mix<24>(x0, x1);
  threefry_inject(x0, x1, k[1], k[6]);
  threefry_mix<13>(x0, x1); threefry_mix<15>(x0, x1);
  threefry_mix<26>(x0, x1); threefry_mix<6>(x0, x1);
  threefry_inject(x0, x1, k[2], k[7]);
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = x0[j] ^ x1[j];
}

// x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xffffffff)): element i of a
// jax.random draw (K2's fused loss draw; K1 runs four lanes a thread).
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 uint64_t i) {
  uint32_t out[1];
  threefry_lanes<1>(threefry_key(k0, k1), static_cast<uint32_t>(i >> 32),
                    static_cast<uint32_t>(i), out);
  return out[0];
}

// jax.random.uniform's float32 in [0, 1) from 32 random bits.
__device__ __forceinline__ float unit_float(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3f800000u), 1.0f);
}

// XLA's float32 erf_inv (Giles' single-precision polynomial in w =
// -log1p(-x*x), branches w < 5 and w >= 5), the coefficients as the bit
// patterns of prng.py's _ERFINV_LT5 / _ERFINV_GE5.
__device__ __forceinline__ float erf_inv(float x) {
  constexpr uint32_t kLt5[9] = {0x32f16588u, 0x34b84b36u, 0xb66c7357u,
                                0xb6935ac1u, 0x396532dbu, 0xbaa45408u,
                                0xbb88e4efu, 0x3e7c8f63u, 0x3fc02e2fu};
  constexpr uint32_t kGe5[9] = {0xb951f09bu, 0x38d3b56bu, 0x3ab0dc72u,
                                0xbb70bde7u, 0x3bbc127bu, 0xbbf9c5d7u,
                                0x3c1aa57eu, 0x3f8036dbu, 0x40354f7eu};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = __uint_as_float(lt ? kLt5[0] : kGe5[0]);
#pragma unroll
  for (int c = 1; c < 9; ++c)
    p = __fadd_rn(__uint_as_float(lt ? kLt5[c] : kGe5[c]), __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __uint_as_float(0x7f800000u))
                          : __fmul_rn(p, x);
}

__device__ __forceinline__ float scaled(float u, float lo, float span) {
  return fmaxf(lo, __fadd_rn(__fmul_rn(u, span), lo));
}

// jax.random.normal's float32 from the unit float u of its bits: sqrt(2) *
// erf_inv(max(lo, u * span + lo)) with lo = nextafter(-1, 0) and span =
// 1 - lo (the host passes both; prng.py:_segment).  K1's NORMAL mode and
// K13's fused spring directions.
__device__ __forceinline__ float normal_float(float u, float lo, float span) {
  return __fmul_rn(__uint_as_float(0x3fb504f3u),   // float32(sqrt(2))
                   erf_inv(scaled(u, lo, span)));
}

// One draw of a K1 launch as the host fills it (kernels/__init__.py:
// DrawSpec): its output and element count, the key schedules (the stream,
// then randint's second), the mode (threefry.cu's Mode) and the constants
// that finish an element; out[0] is element `first` of the stream (a
// block of a node-sharded draw's rows).  K14 takes a randint spec with no
// output and draws its ring offsets itself.
struct DrawSpec {
  void* out;
  int64_t n;
  uint32_t sched[16];   // key schedules: the stream, then randint's second
  int32_t mode;
  float lo;
  float span;
  uint32_t minval;
  uint32_t range;
  uint32_t mult;
  int64_t first;
};
static_assert(sizeof(DrawSpec) == 112, "DrawSpec layout changed: update kernels/__init__.py");

// jax.random.randint's elements hi * 2^32 + lo + j (j < L) of the randint
// spec d: b1 and b2 the elements' bits of split(key)'s two streams (d's
// two key schedules), ((b1 % range) * mult + b2 % range) % range + minval
// in 32-bit wrapping arithmetic, mult = (2^16 % range)^2 mod 2^32 % range
// from the host (0 for ranges above 2^16, as jax computes it).  K1's
// RANDINT mode and K14's ring offsets.
template <int L>
__device__ __forceinline__ void randint_lanes(const DrawSpec& d, uint32_t hi, uint32_t lo,
                                              uint32_t (&v)[L]) {
  ThreefryKey key;
  uint32_t b1[L], b2[L];
#pragma unroll
  for (int j = 0; j < 8; ++j) key.k[j] = d.sched[j];
  threefry_lanes<L>(key, hi, lo, b1);
#pragma unroll
  for (int j = 0; j < 8; ++j) key.k[j] = d.sched[8 + j];
  threefry_lanes<L>(key, hi, lo, b2);
  const uint32_t span = d.range, mult = d.mult;
#pragma unroll
  for (int j = 0; j < L; ++j) v[j] = ((b1[j] % span) * mult + b2[j] % span) % span + d.minval;
}

// --- slot rows -------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

__device__ __forceinline__ unsigned flags16(uint4 f) {
  return flags4(f.x) | (flags4(f.y) << 4) | (flags4(f.z) << 8) | (flags4(f.w) << 12);
}

// Slots of a bool row that are set.
__device__ __forceinline__ uint64_t row_mask(const uint8_t* k, int S) {
  uint64_t m = 0;
  int u = 0;
  if (aligned16(k)) {
    for (; u + 16 <= S; u += 16) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>(k + u));
      const uint4 f = make_uint4(nonzero_bytes(w.x), nonzero_bytes(w.y),
                                 nonzero_bytes(w.z), nonzero_bytes(w.w));
      m |= static_cast<uint64_t>(flags16(f)) << u;
    }
  }
  for (; u < S; ++u) if (k[u]) m |= 1ull << u;
  return m;
}

// The 32 x 32 bit matrix whose row r is lane r's x, transposed: lane l
// gets column l (bit r = bit l of lane r's x).  Five shuffle stages, each
// swapping the off-diagonal blocks of the next smaller size.
__device__ __forceinline__ uint32_t warp_transpose(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint32_t m = j == 16 ? 0x0000ffffu : j == 8 ? 0x00ff00ffu
                     : j == 4 ? 0x0f0f0f0fu : j == 2 ? 0x33333333u : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

// Column counts of [N, S] bool rows over a warp: each lane passes its
// row's slot mask m (0 for a row that does not count) and lane l adds,
// for slots l and l + 32, how many of the warp's 32 masks hold the slot:
// the popcount of column l of the masks' bit matrix, one transpose a
// 32-slot half; a warp whose masks are all 0 adds nothing.  Every lane of
// the warp must call it.  (The [N, U] -> [U] live-coverage reduction of
// mass_detection_stats, _expire and _originate: K5, K12, K8.)
__device__ __forceinline__ void warp_column_counts(uint64_t m, int S,
                                                   uint32_t (&cnt)[2]) {
  if (!__any_sync(0xffffffffu, m != 0)) return;
  cnt[0] += __popc(warp_transpose(static_cast<uint32_t>(m)));
  if (S > 32) cnt[1] += __popc(warp_transpose(static_cast<uint32_t>(m >> 32)));
}

// The [S] bool vector v as a slot mask, read by one full warp: lane = slot,
// two ballots for S <= 64.  Every lane gets the mask.
__device__ __forceinline__ uint64_t warp_slot_mask(const uint8_t* v, int S) {
  const int lane = threadIdx.x & 31;
  const unsigned lo = __ballot_sync(0xffffffffu, lane < S && v[lane]);
  const unsigned hi = __ballot_sync(0xffffffffu, lane + 32 < S && v[lane + 32]);
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

// The 64-bit masks of a warp's lanes or-ed together; every lane gets it.
__device__ __forceinline__ u64 warp_or(u64 m) {
  for (int off = 16; off > 0; off >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, off);
  return m;
}

// The mask of slots 0..S-1.
__device__ __forceinline__ uint64_t all_slots(int S) {
  return S >= 64 ? ~0ull : (1ull << S) - 1;
}

// --- _release: freeing done slots, committing what a majority heard --------
// (swim.py _release; K8's pressure eviction and K12's expire)

// A slot's live coverage, count / max(n_live, 1) in IEEE division: the
// counts are exact integers and the quotient sits exactly at the 0.995
// and 0.5 bars, so no approximate division may replace it.
__device__ __forceinline__ float live_coverage(u64 count, u64 n_live) {
  return __fdiv_rn(__ull2float_rn(count), __ull2float_rn(n_live < 1 ? 1 : n_live));
}

// _release's commit masks of one slot: a done slot whose coverage reached
// 0.5 commits its dead, left or alive belief (kinds 2, 3, 0).
struct Commits {
  bool dead, left, alive;
};

__device__ __forceinline__ Commits release_commits(bool done, float cov, int kind) {
  const bool commit = done && cov >= 0.5f;
  return {commit && kind == 2, commit && kind == 3, commit && kind == 0};
}

// _release's committed scatters read at node i: committed_dead and
// committed_left take an or over the committing slots whose subject is i,
// committed_inc a max of their r_inc; the slots outside the alive commit
// scatter-max 0 into index 0 (jnp's .at[where(mask, subject, 0)]).
// subj/inc are the [U] table (shared memory), the masks over its slots.
__device__ __forceinline__ void release_node(int64_t i, uint64_t c_dead, uint64_t c_left,
                                             uint64_t c_alive, uint64_t slots,
                                             const int32_t* subj, const int32_t* inc,
                                             bool& cd, bool& cl, int32_t& ci) {
  for (uint64_t m = c_dead; m; m &= m - 1) cd = cd || subj[__ffsll(m) - 1] == i;
  for (uint64_t m = c_left; m; m &= m - 1) cl = cl || subj[__ffsll(m) - 1] == i;
  for (uint64_t m = c_alive; m; m &= m - 1) {
    const int u = __ffsll(m) - 1;
    if (subj[u] == i && inc[u] > ci) ci = inc[u];
  }
  if (i == 0 && (c_alive & slots) != slots && ci < 0) ci = 0;
}

// Four slot bits as four byte masks (bit j -> 0xff in byte j).
__device__ __forceinline__ uint32_t byte_masks(uint32_t bits4) {
  return ((bits4 * 0x00204081u) & 0x01010101u) * 0xffu;
}

// The lanes of a 32-bit word of E-byte elements (E = 1 or 2) that the low
// 4 / E bits of `bits` select, as a byte mask.
template <int E>
__device__ __forceinline__ uint32_t lane_mask(uint32_t bits) {
  if (E == 1) return byte_masks(bits & 0xfu);
  return ((bits & 1u) ? 0x0000ffffu : 0u) | ((bits & 2u) ? 0xffff0000u : 0u);
}

// One thread's in-place write of its [U] row r of 1- or 2-byte elements:
// each slot of `sel` becomes v where `hi` holds it, else 0 (hi within
// sel).  Where the row is 16-byte aligned and U elements are whole 16-byte
// vectors, it goes four vectors (64 bytes) at a time: every vector of the
// four that the slots touch is loaded before any is stored, and a vector
// is written back only when one of its bytes changes; element by element
// otherwise, each written only where it changes.  (K10's apply, K11's
// stamps of the converted columns, K12's refuted and freed columns.)
template <typename T>
__device__ __forceinline__ void row_write(T* r, int U, uint64_t sel, uint64_t hi, T v) {
  constexpr int E = sizeof(T);
  constexpr int kPer = 16 / E;      // slots a vector
  constexpr int kVecs = 64 / kPer;  // vectors of a 64-slot row
  constexpr int kWord = 4 / E;      // slots a 32-bit word
  static_assert(E == 1 || E == 2, "row_write takes 1- and 2-byte rows");
  if (!sel) return;
  if (!aligned16(r) || U % kPer) {
    for (uint64_t m = sel; m; m &= m - 1) {
      const int u = __ffsll(m) - 1;
      const T want = ((hi >> u) & 1ull) ? v : T(0);
      if (r[u] != want) r[u] = want;
    }
    return;
  }
  const uint32_t fill = E == 1 ? static_cast<uint32_t>(static_cast<uint8_t>(v)) * 0x01010101u
                               : static_cast<uint32_t>(static_cast<uint16_t>(v)) * 0x00010001u;
  uint4* vec = reinterpret_cast<uint4*>(r);
#pragma unroll
  for (int c0 = 0; c0 < kVecs; c0 += 4) {
    if (!((sel >> (c0 * kPer)) & (~0ull >> (64 - 4 * kPer)))) continue;
    uint4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = make_uint4(0, 0, 0, 0);
      if ((sel >> ((c0 + k) * kPer)) & ((1ull << kPer) - 1)) w[k] = vec[c0 + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t s = static_cast<uint32_t>(sel >> ((c0 + k) * kPer)) & ((1u << kPer) - 1);
      if (!s) continue;
      const uint32_t h = static_cast<uint32_t>(hi >> ((c0 + k) * kPer)) & s;
      uint4 n;
      n.x = (w[k].x & ~lane_mask<E>(s)) | (lane_mask<E>(h) & fill);
      n.y = (w[k].y & ~lane_mask<E>(s >> kWord)) | (lane_mask<E>(h >> kWord) & fill);
      n.z = (w[k].z & ~lane_mask<E>(s >> 2 * kWord)) | (lane_mask<E>(h >> 2 * kWord) & fill);
      n.w = (w[k].w & ~lane_mask<E>(s >> 3 * kWord)) | (lane_mask<E>(h >> 3 * kWord) & fill);
      if (n.x != w[k].x || n.y != w[k].y || n.z != w[k].z || n.w != w[k].w) vec[c0 + k] = n;
    }
  }
}

// --- the SWIM detector's per-slot values ------------------------------------

// lax's int32 product and sum, wrapping: r_inc * U + slot (the alive map's
// value) and inc + 1 (a refutation's incarnation).
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// The int32 difference a - b of a tick and a stamp, wrapping as torch's
// and XLA's int32 subtraction does.
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// A Lifeguard confirmation count as an index of the [65] timeout table.
__device__ __forceinline__ int timeout_index(int c) {
  return c < 0 ? 0 : (c > 64 ? 64 : c);
}

}  // namespace consul_kernels
