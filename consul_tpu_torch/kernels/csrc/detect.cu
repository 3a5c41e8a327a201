// K5 mass_detect: recall and false positives of a correlated-failure
// experiment, every tick of the mass-event bench.
//
// Replaces: consul_tpu/models/swim.py mass_detection_stats, which XLA runs
// as an [N, U] live-column reduction (each slot's coverage among live
// members), a [U] dead/left-rumor mask at the 0.99 bar, a [U] -> [N]
// scatter-max of the detected rumors' subjects and four [N] count
// reductions (live, victims, detected victims, detected live members).
//
// Bound on an H100: memory.  The function must read the know rows of the
// live members (U bytes each), six [N] bool leaves (up, member,
// committed_dead, committed_left, bulk_member, victim) and bulk_cov only
// where a bulk subject is not committed yet (the 32-byte sectors holding
// one): ~38 MB at N = 1M, U = 32 with 1% of the nodes in the bulk
// channel, ~0.011 ms at 3.35 TB/s.  The kernel reads every row's know
// bytes (a dead row's too: its live flag masks them after the load), so
// it moves N * U bytes of know where the bound counts n_live * U.
//
// One launch, a block per tile of T consecutive rows (as many as
// kTileBytes of know hold, a multiple of 16, at most kMaxRows: 2,048 at
// U = 32):
//   * the block stages the tile's know bytes in shared memory with 16-byte
//     cp.async copies, every copy issued at once, so no load waits for a
//     live flag; meanwhile thread t loads 16 rows of each of the six [N]
//     leaves (16-byte loads, issued together), writes their live flags
//     (member & up, one byte a row) to shared memory, and issues the
//     bulk_cov loads of its uncommitted bulk members (independent,
//     predicated loads), used only after the stream;
//   * the stream: thread t takes the rows' W-byte chunk q = t % (U / W)
//     (W = 16 where U allows, else 8, 4, 2 or 1) and adds its W slot
//     bytes, masked by the row's live flag, into byte lanes (W / 4 words
//     of four 8-bit lanes), flushed into shared counts at least every
//     kFlush rows;
//   * the leaf threads form the four counters with byte masks and
//     popcounts: live, victims (victim & member), and the rows the base
//     mask already counts as believed down (committed dead or left, or a
//     bulk-channel subject whose own coverage is >= 0.99) among victims
//     and among live rows;
//   * at the tile's end the lanes holding one chunk sum their counts
//     with shuffles (16-bit halves of the byte lanes) where U / W is a
//     power of two, else by shared atomics; each block adds its slot
//     counts and counters to a per-device scratch (one global atomic a
//     word) and counts itself done (a fence and a done count);
//   * the last block's first warp is the tail: lane u takes slots u and
//     u + 32, its coverage float32 count / float32 max(n_live, 1) in IEEE
//     division as jnp computes it, a ballot the detected (active dead or
//     left) slots at the 0.99 bar; __match_any_sync drops a slot whose
//     subject a lower detected slot names (a masked slot names none; a
//     subject in [-N, 0) names subject + N, as JAX's scatter wraps it, and
//     one outside [-N, N) counts nowhere); each lane loads the base
//     mask's leaves, member, victim and up at its subjects at once, warp
//     sums add the subjects the base mask did not already count, and lane
//     0 writes recall = float32(detected victims) / float32(max(victims,
//     1)) and the int32 false-positive count; the warp zeroes the scratch
//     for the next launch.
// Integer counts make the result independent of the order blocks finish.
//
// Built with -DDETECT_PHASE_TIMES (build.variant; chip_smoke.py's K5
// phases), the kernel stamps %globaltimer into its scratch: block 0's
// start, the last block's arrival, the tail's end.

#include "common.cuh"

using namespace consul_kernels;

namespace {

#ifdef DETECT_PHASE_TIMES
__device__ __forceinline__ void stamp(u64* stamps, int k) {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  atomicMax(stamps + k, t);
}
#else
__device__ __forceinline__ void stamp(u64*, int) {}
#endif

constexpr int kThreads = 256;
constexpr int kTileBytes = 65536;         // know bytes a block stages
constexpr int kMaxRows = 4096;            // rows a block at most (U <= 16)
constexpr int kLeafBytes = 16;            // leaf bytes a leaf thread loads
constexpr int kFlush = 255;               // most rows one byte lane adds
constexpr int kCounters = 4;  // live, victims, base & victims, base & live
constexpr int kSlots = 64;
constexpr int kDead = 2, kLeft = 3;
// scratch words: the done count, the counters, the slot counts, the stamps
constexpr int kCol0 = 1 + kCounters;
constexpr int kStampAt = kCol0 + kSlots;  // the instrumented build's stamps

// Rows a tile: as many as kTileBytes of know hold, a multiple of 16, at
// most kMaxRows.
inline int tile_rows(int U) {
  const int r = (kTileBytes / U) & ~15;
  return r < kMaxRows ? r : kMaxRows;
}

struct Args {
  const uint8_t* know;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* cdead;
  const uint8_t* cleft;
  const uint8_t* bulk;
  const float* bulk_cov;
  const uint8_t* victim;
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  int64_t N;
  int U;
  int T;               // rows a tile (tile_rows(U))
  int leaves_aligned;  // the six leaves 16-byte aligned: vector loads
  int know_aligned;    // know 16-byte aligned: cp.async copies
  u64* scratch;
  float* recall;
  int32_t* fp;
};

// W bytes of know as ceil(W / 4) words of byte lanes.
template <int W>
struct Chunk {
  static constexpr int kWords = W >= 4 ? W / 4 : 1;
  uint32_t w[kWords];
};

// A row's W slot bytes from the staged tile (W-byte aligned).
template <int W>
__device__ __forceinline__ Chunk<W> load_chunk(const uint8_t* p) {
  Chunk<W> c;
  if constexpr (W == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    c.w[0] = v.x; c.w[1] = v.y; c.w[2] = v.z; c.w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    c.w[0] = v.x; c.w[1] = v.y;
  } else if constexpr (W == 4) {
    c.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (W == 2) {
    c.w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    c.w[0] = *p;
  }
  return c;
}

// 16 bytes of a leaf at rows i .. i + 15 (0 beyond N) as four words.
__device__ __forceinline__ uint4 load_leaf(const uint8_t* p, int64_t i, int64_t N,
                                           bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p + i));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (i + b < N) w[b >> 2] |= static_cast<uint32_t>(p[i + b] != 0) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Adds the byte lanes of acc (the chunk q's slot bytes) to the block's
// shared slot counts, then clears them.
template <int W>
__device__ __forceinline__ void flush_shared(uint32_t (&acc)[Chunk<W>::kWords], int q,
                                             uint32_t* s_col) {
#pragma unroll
  for (int w = 0; w < Chunk<W>::kWords; ++w) {
#pragma unroll
    for (int b = 0; b < (W >= 4 ? 4 : W); ++b) {
      const uint32_t c = (acc[w] >> (8 * b)) & 0xffu;
      if (c != 0) atomicAdd(&s_col[q * W + 4 * w + b], c);
    }
    acc[w] = 0;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) mass_detect_kernel(Args a) {
  constexpr int NW = Chunk<W>::kWords;
  extern __shared__ __align__(16) uint8_t s_know[];  // the tile's rows, T * U bytes
  __shared__ __align__(16) uint8_t s_live[kMaxRows];
  __shared__ uint32_t s_col[kSlots];
  __shared__ u64 red[kCounters][32];
  __shared__ bool last;
  const int t = threadIdx.x;
  if (t < kSlots) s_col[t] = 0;
  if (blockIdx.x == 0 && t == 0) stamp(a.scratch + kStampAt, 0);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * a.T;
  const int rows = static_cast<int>(a.N - base < a.T ? a.N - base : a.T);

  // the tile's know bytes staged in shared memory, every copy issued at once
  {
    const uint8_t* g = a.know + base * a.U;
    const int bytes = rows * a.U;
    const int whole = a.know_aligned ? bytes & ~15 : 0;
    for (int o = 16 * t; o < whole; o += 16 * kThreads) cp_async16(s_know + o, g + o);
    cp_async_commit();
    for (int o = whole + t; o < bytes; o += kThreads) s_know[o] = g[o];
  }

  // the leaves, while the copies fly: the live flags now, bulk_cov's loads
  // issued at the uncommitted bulk members (used after the stream)
  const bool leaves = t * kLeafBytes < rows;
  const int64_t i = base + t * kLeafBytes;
  uint32_t live[4] = {0, 0, 0, 0}, vic[4] = {0, 0, 0, 0}, down[4] = {0, 0, 0, 0};
  float cov[kLeafBytes];
  if (leaves) {
    const bool vec = a.leaves_aligned && i + kLeafBytes <= a.N;
    const uint4 mem = load_leaf(a.member, i, a.N, vec);
    const uint4 up = load_leaf(a.up, i, a.N, vec);
    const uint4 vc = load_leaf(a.victim, i, a.N, vec);
    const uint4 cd = load_leaf(a.cdead, i, a.N, vec);
    const uint4 cl = load_leaf(a.cleft, i, a.N, vec);
    const uint4 bm = load_leaf(a.bulk, i, a.N, vec);
    const uint32_t m[4] = {mem.x, mem.y, mem.z, mem.w};
    const uint32_t u[4] = {up.x, up.y, up.z, up.w};
    const uint32_t x[4] = {vc.x, vc.y, vc.z, vc.w};
    const uint32_t d[4] = {cd.x, cd.y, cd.z, cd.w};
    const uint32_t l[4] = {cl.x, cl.y, cl.z, cl.w};
    const uint32_t b[4] = {bm.x, bm.y, bm.z, bm.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      live[w] = m[w] & u[w];
      vic[w] = m[w] & x[w];
      down[w] = d[w] | l[w];
    }
    *reinterpret_cast<uint4*>(s_live + t * kLeafBytes) =
        make_uint4(live[0], live[1], live[2], live[3]);
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k) {  // independent loads, issued together
      const bool need = ((b[k >> 2] & ~down[k >> 2]) >> (8 * (k & 3))) & 1u;
      cov[k] = need ? __ldcs(a.bulk_cov + i + k) : 0.0f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the stream: thread t adds chunk q of rows r0, r0 + R, ... into byte
  // lanes masked by the live flags
  const int cpr = a.U / W;                 // chunks a row
  const int R = kThreads / cpr;            // rows an iteration
  const bool streams = t < R * cpr;
  const int q = t % cpr;
  const int r0 = t / cpr;
  const int mine = streams && r0 < rows ? (rows - r0 + R - 1) / R : 0;
  uint32_t acc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0;
  int since = 0;
#pragma unroll 4
  for (int j = 0; j < mine; ++j) {
    const int r = r0 + j * R;
    const Chunk<W> v = load_chunk<W>(s_know + r * a.U + q * W);
    const uint32_t keep = 0u - static_cast<uint32_t>(s_live[r]);
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] += v.w[w] & keep;
    if (++since == kFlush) {
      flush_shared<W>(acc, q, s_col);
      since = 0;
    }
  }

  // the four counters: a bulk member not committed counts as believed
  // down at its own 0.99 bar (cov is 0 where none was read)
  u64 cnt[kCounters] = {0, 0, 0, 0};
  if (leaves) {
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k) {
      if (cov[k] >= 0.99f) down[k >> 2] |= 1u << (8 * (k & 3));
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      cnt[0] += __popc(live[w]);
      cnt[1] += __popc(vic[w]);
      cnt[2] += __popc(down[w] & vic[w]);
      cnt[3] += __popc(down[w] & live[w]);
    }
  }

  // the tile's slot counts: lanes of one chunk summed, then shared
  const int lane = t & 31;
  if ((cpr & (cpr - 1)) == 0 && cpr <= 32 && W >= 4) {  // block-uniform
    uint32_t lo[NW], hi[NW];  // 16-bit halves: lanes 0, 2 and 1, 3
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      lo[w] = acc[w] & 0x00ff00ffu;
      hi[w] = (acc[w] >> 8) & 0x00ff00ffu;
    }
    for (int off = 16; off >= cpr; off >>= 1) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        lo[w] += __shfl_xor_sync(0xffffffffu, lo[w], off);
        hi[w] += __shfl_xor_sync(0xffffffffu, hi[w], off);
      }
    }
    if (lane < cpr) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t c[4] = {lo[w] & 0xffffu, hi[w] & 0xffffu, lo[w] >> 16, hi[w] >> 16};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c[k] != 0) atomicAdd(&s_col[q * W + 4 * w + k], c[k]);
        }
      }
    }
  } else if (streams) {
    flush_shared<W>(acc, q, s_col);
  }
  block_sum<kCounters>(cnt, red);  // its syncs also publish s_col
  if (t < kCounters && red[t][0] != 0) atomicAdd(&a.scratch[1 + t], red[t][0]);
  if (t < a.U && s_col[t] != 0) atomicAdd(&a.scratch[kCol0 + t], static_cast<u64>(s_col[t]));
  if (t < a.U || t < kCounters) __threadfence();  // the adding threads
  __syncthreads();
  if (t == 0) last = atomicAdd(&a.scratch[0], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (!last || t >= 32) return;

  // the tail: one warp, lane = slot (and slot + 32)
  __threadfence();
  if (lane == 0) stamp(a.scratch + kStampAt, 1);
  const u64 n_live = __ldcg(&a.scratch[1]);
  const u64 victims = __ldcg(&a.scratch[2]);
  const u64 base_found = __ldcg(&a.scratch[3]);
  const u64 base_fp = __ldcg(&a.scratch[4]);
  const float live_f = __ull2float_rn(n_live < 1 ? 1 : n_live);
  bool det[2];
  int32_t subj[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int u = lane + 32 * p;
    det[p] = false;
    subj[p] = 0;
    if (u < a.U) {
      const int kind = a.r_kind[u];
      const int64_t w = wrapped(a.r_subject[u], a.N);
      subj[p] = w >= 0 && w < a.N ? static_cast<int32_t>(w) : -1;
      const float cov = __fdiv_rn(__ull2float_rn(__ldcg(&a.scratch[kCol0 + u])), live_f);
      det[p] = a.r_active[u] && (kind == kDead || kind == kLeft) && cov >= 0.99f;
    }
  }
  // a detected slot keeps its subject unless a lower detected slot names it
  const unsigned below = (1u << lane) - 1u;
  const unsigned det0 = __ballot_sync(0xffffffffu, det[0]);
  bool keep[2];
  {
    // every lane takes part in each match (no short circuit before one)
    const u64 key0 = det[0] ? static_cast<uint32_t>(subj[0]) : (1ull << 32) | lane;
    const unsigned same0 = __match_any_sync(0xffffffffu, key0);
    keep[0] = det[0] && (same0 & below) == 0;
    const u64 key1 = det[1] ? static_cast<uint32_t>(subj[1]) : (1ull << 32) | lane;
    bool dup = (__match_any_sync(0xffffffffu, key1) & below) != 0;
    for (unsigned m = a.U > 32 ? det0 : 0u; m; m &= m - 1) {  // warp-uniform
      dup |= __shfl_sync(0xffffffffu, subj[0], __ffs(m) - 1) == subj[1];
    }
    keep[1] = det[1] && !dup;
  }
  bool found[2], false_pos[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int64_t s = subj[p];
    found[p] = false_pos[p] = false;
    if (keep[p] && s >= 0 && s < a.N) {
      const bool mem = a.member[s] != 0, vic = a.victim[s] != 0, up = a.up[s] != 0;
      const bool cd = a.cdead[s] != 0, cl = a.cleft[s] != 0, bm = a.bulk[s] != 0;
      const float cov = a.bulk_cov[s];
      const bool down = cd || cl || (bm && cov >= 0.99f);
      found[p] = !down && mem && vic;
      false_pos[p] = !down && mem && up;
    }
  }
  const u64 found_n = base_found + __popc(__ballot_sync(0xffffffffu, found[0])) +
                      __popc(__ballot_sync(0xffffffffu, found[1]));
  const u64 fp_n = base_fp + __popc(__ballot_sync(0xffffffffu, false_pos[0])) +
                   __popc(__ballot_sync(0xffffffffu, false_pos[1]));
  __syncwarp();
  for (int k = lane; k < kStampAt; k += 32) a.scratch[k] = 0;  // ready for the next launch
  if (lane == 0) {
    *a.recall = __fdiv_rn(__ull2float_rn(found_n),
                          __ull2float_rn(victims < 1 ? 1 : victims));
    *a.fp = static_cast<int32_t>(fp_n);
    stamp(a.scratch + kStampAt, 2);
  }
}


// One launch of the W-byte form; the first also lets it take kTileBytes
// of dynamic shared memory.
template <int W>
int launch(unsigned blocks, size_t smem, cudaStream_t s, const Args& a) {
  static const int set = static_cast<int>(cudaFuncSetAttribute(
      mass_detect_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes));
  if (set != 0) return set;
  mass_detect_kernel<W><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: kStampAt zeroed u64 (the done count, the counters, 64 slot
// counts; the last block zeroes them again), then 3 phase stamps.
extern "C" int mass_detect(const void* know, const void* up, const void* member,
                           const void* committed_dead,
                           const void* committed_left,
                           const void* bulk_member, const void* bulk_cov,
                           const void* victim, const void* r_active,
                           const void* r_kind, const void* r_subject,
                           int64_t N, int U, void* scratch, void* recall,
                           void* fp, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > kSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* leaves[6] = {up, member, committed_dead, committed_left, bulk_member, victim};
  int aligned = 1;
  for (const void* p : leaves) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  int W = 16;  // the widest chunk that divides a row
  while (W > 1 && U % W != 0) W >>= 1;
  const int T = tile_rows(U);
  const Args a{static_cast<const uint8_t*>(know), static_cast<const uint8_t*>(up),
               static_cast<const uint8_t*>(member),
               static_cast<const uint8_t*>(committed_dead),
               static_cast<const uint8_t*>(committed_left),
               static_cast<const uint8_t*>(bulk_member), static_cast<const float*>(bulk_cov),
               static_cast<const uint8_t*>(victim), static_cast<const uint8_t*>(r_active),
               static_cast<const int8_t*>(r_kind), static_cast<const int32_t*>(r_subject),
               N, U, T, aligned, static_cast<int>(reinterpret_cast<uintptr_t>(know) % 16 == 0),
               static_cast<u64*>(scratch), static_cast<float*>(recall),
               static_cast<int32_t*>(fp)};
  const unsigned blocks = static_cast<unsigned>((N + T - 1) / T);
  const size_t smem = static_cast<size_t>(T) * U;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 16: return launch<16>(blocks, smem, s, a);
    case 8: return launch<8>(blocks, smem, s, a);
    case 4: return launch<4>(blocks, smem, s, a);
    case 2: return launch<2>(blocks, smem, s, a);
    default: return launch<1>(blocks, smem, s, a);
  }
}
