// K8 originate: allocate up to A rumor slots for the subjects that want
// one, every probe round (suspect rumors), dense expiry (dead rumors) and
// command (rejoin, leave, inject_suspicion).
//
// Replaces: consul_tpu/models/swim.py _originate, which XLA runs as a
// demand/free count, a lax.cond around the pressure eviction (the [N, U]
// live-coverage reduction and _release: the done mask at 99.5% coverage,
// the committed scatters at 50%, the column clears), _top_k_sharded over
// the [N] wants, lax.top_k over the [U] free slots, six [U] table scatters
// and an [N, A] subject match that seeds the originating rows.
//
// Three launches behind one entry point:
//   1. select, a persistent grid over N: each warp keeps the top A of
//      (want, index) as a sorted list spread over its lanes (a 64-bit key:
//      the order-preserving want above the complemented index, so "larger
//      key" is lax.top_k's order, earlier index first among equals); a
//      batch of 32 keys is filtered against the list's last entry with one
//      ballot and only the survivors are inserted (two ballots and three
//      shuffles each).  The block merges its warps' lists and writes its
//      top A; it adds its count of wants > 0 to the demand.  The last
//      block to finish merges every block's list into the global top A and
//      sets the device flag evicting = demand > free slots;
//   2. commit, a persistent grid over N that reads the flag: when evicting
//      it counts live rows and, per slot, the live rows that know it
//      (common.cuh:warp_column_counts); otherwise its blocks only count
//      themselves done.  The last block computes coverage = count /
//      max(n_live, 1) in IEEE division (the 0.995 and 0.5 bars), the done
//      mask and the three commit masks, r_coverage = evicting ? (done ? 0 :
//      coverage) : r_coverage, the free-slot top A (free slots ascending,
//      then the rest), ok = want > 0 and a free slot, and writes the [U]
//      table, the (subject, slot, ok) outputs and the plan of launch 3;
//   3. seed, a persistent grid over N: each warp copies its 32 rows of
//      know / learn_tick / sends_left into the fresh outputs with 16-byte
//      vectors (_release's column clears, when a slot was evicted, as a
//      byte mask on each vector: common.cuh:warp_copy_rows) and each thread
//      seeds its row's cell (row_subject[i] matched against the A
//      allocated subjects) and writes committed dead / left / inc with the
//      commit scatters at its index.
// The scratch (counts, the plan, the block lists) is reset by the kernels
// that consume it, so a call needs no memset.
//
// Bound on an H100: memory.  The function must read want (4 bytes a row)
// and write the seeded cells and the [U] table; with an eviction, also
// know and up/member (U + 2 bytes a row) and the committed leaves of the
// committed subjects: ~4 MB without eviction at N = 1M, ~38 MB with one
// (~0.0013 and ~0.011 ms at 3.35 TB/s).  The fresh-output row copy this
// kernel also makes (4U bytes read and written a row, 128 MB each way at
// U = 32, plus the committed leaves' 6 MB) is the price of never writing
// a tensor it was given.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSuspect = 1;
constexpr unsigned kFull = 0xffffffffu;

// scratch layout, in u64 words
constexpr int kSelectDone = 0, kCommitDone = 1, kDemand = 2, kLive = 3;
constexpr int kCols = 4;      // 64 per-slot live coverage counts
constexpr int kEvicting = 68, kKeep = 69, kCommitDead = 70,
              kCommitLeft = 71, kCommitAlive = 72;
constexpr int kPairs = 73;    // 64 (match subject, slot) pairs
constexpr int kTop = 137;     // 64 global top keys
constexpr int kLists = 201;   // A keys a block of launch 1

struct OriginateArgs {
  const int32_t* want;
  const int32_t* row_subject;
  const int32_t* inc_of_subject;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* know;
  const int16_t* learn_tick;
  const int8_t* sends_left;
  const uint8_t* committed_dead;
  const uint8_t* committed_left;
  const int32_t* committed_inc;
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  const int32_t* r_start;
  const int8_t* r_confirm;
  const float* r_coverage;
  int64_t N;
  int U, A, kind, tick, tick16, limit;
  u64* scratch;
  uint8_t* know_out;
  int16_t* learn_out;
  int8_t* sends_out;
  uint8_t* committed_dead_out;
  uint8_t* committed_left_out;
  int32_t* committed_inc_out;
  uint8_t* r_active_out;
  int8_t* r_kind_out;
  int32_t* r_subject_out;
  int32_t* r_inc_out;
  int32_t* r_start_out;
  int8_t* r_confirm_out;
  float* r_coverage_out;
  int32_t* subjects_out;
  int32_t* slots_out;
  uint8_t* ok_out;
};

// (want, index) as one key: larger key = larger want, then smaller index.
// Every real key is > 0, so 0 marks an empty list entry.
__device__ __forceinline__ u64 make_key(int32_t v, int64_t i) {
  return (static_cast<u64>(static_cast<uint32_t>(v) ^ 0x80000000u) << 32) |
         static_cast<u64>(0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ int32_t key_value(u64 key) {
  return static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t key_index(u64 key) {
  return static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// A warp's top A <= 64 keys, descending: lane l holds entries l (lo) and
// 32 + l (hi); entries past A, and entries not filled yet, are 0.
struct WarpTop {
  u64 lo = 0, hi = 0;
};

__device__ __forceinline__ void top_insert(WarpTop& t, u64 x, int A, int lane) {
  const int p = __popc(__ballot_sync(kFull, t.lo > x)) + __popc(__ballot_sync(kFull, t.hi > x));
  if (p >= A) return;  // warp-uniform
  const u64 lo_up = __shfl_up_sync(kFull, t.lo, 1);
  const u64 hi_up = __shfl_up_sync(kFull, t.hi, 1);
  const u64 lo_31 = __shfl_sync(kFull, t.lo, 31);
  const int e_lo = lane, e_hi = lane + 32;
  const u64 lo = e_lo < p ? t.lo : (e_lo == p ? x : lo_up);
  const u64 hi = e_hi < p ? t.hi : (e_hi == p ? x : (lane == 0 ? lo_31 : hi_up));
  t.lo = e_lo < A ? lo : 0;
  t.hi = e_hi < A ? hi : 0;
}

// Offer one key a lane (0 for none): the ones above the list's last
// entry are inserted, in lane order.
__device__ __forceinline__ void top_offer(WarpTop& t, u64 key, int A, int lane) {
  const u64 bar = A <= 32 ? __shfl_sync(kFull, t.lo, A - 1) : __shfl_sync(kFull, t.hi, A - 33);
  unsigned pending = __ballot_sync(kFull, key > bar);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    top_insert(t, __shfl_sync(kFull, key, src), A, lane);
  }
}

// The block's warps' lists merged into warp 0's (every thread calls it).
__device__ void block_top(WarpTop& t, int A, u64* lists, int lane, int warp) {
  __syncthreads();
  lists[warp * 64 + lane] = t.lo;
  lists[warp * 64 + 32 + lane] = t.hi;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) {
      top_offer(t, lists[w * 64 + lane], A, lane);
      top_offer(t, lists[w * 64 + 32 + lane], A, lane);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
originate_select_kernel(const __grid_constant__ OriginateArgs a) {
  __shared__ u64 lists[kWarps * 64];
  __shared__ u64 red[1][32];
  __shared__ bool last;
  u64* sc = a.scratch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  WarpTop t;
  u64 demand[1] = {0};
  for (int64_t i0 = gwarp * 32; i0 < a.N; i0 += warps * 32) {
    const int64_t i = i0 + lane;
    u64 key = 0;
    if (i < a.N) {
      const int32_t w = a.want[i];
      demand[0] += w > 0;
      key = make_key(w, i);
    }
    top_offer(t, key, a.A, lane);
  }
  block_top(t, a.A, lists, lane, warp);
  if (warp == 0) {
    u64* mine = sc + kLists + static_cast<int64_t>(blockIdx.x) * a.A;
    if (lane < a.A) mine[lane] = t.lo;
    if (lane + 32 < a.A) mine[lane + 32] = t.hi;
  }
  block_sum<1>(demand, red);
  if (threadIdx.x == 0 && red[0][0]) atomicAdd(&sc[kDemand], red[0][0]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sc[kSelectDone], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  WarpTop g;
  const int64_t total = static_cast<int64_t>(gridDim.x) * a.A;
  for (int64_t c0 = static_cast<int64_t>(warp) * 32; c0 < total; c0 += kWarps * 32) {
    const int64_t c = c0 + lane;
    top_offer(g, c < total ? __ldcg(&sc[kLists + c]) : 0ull, a.A, lane);
  }
  block_top(g, a.A, lists, lane, warp);
  if (warp == 0) {
    if (lane < a.A) sc[kTop + lane] = g.lo;
    if (lane + 32 < a.A) sc[kTop + 32 + lane] = g.hi;
    const uint64_t active = warp_slot_mask(a.r_active, a.U);
    if (lane == 0) {
      const u64 free_slots = static_cast<u64>(a.U - __popcll(active));
      sc[kEvicting] = __ldcg(&sc[kDemand]) > free_slots ? 1 : 0;
      sc[kDemand] = 0;
      sc[kSelectDone] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
originate_commit_kernel(const __grid_constant__ OriginateArgs a) {
  __shared__ uint32_t s_col[64];
  __shared__ u64 red[1][32];
  __shared__ bool last;
  __shared__ uint32_t s_masks[2][5];  // per half: done, dead, left, alive, active after
  __shared__ int32_t s_slot[64], s_fscore[64], s_score[64], s_subj[64];
  __shared__ bool s_ok[64];
  u64* sc = a.scratch;
  const int U = a.U, A = a.A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool evicting = __ldcg(&sc[kEvicting]) != 0;  // block-uniform
  if (threadIdx.x < 64) s_col[threadIdx.x] = 0;
  __syncthreads();
  u64 live[1] = {0};
  if (evicting) {
    uint32_t cnt[2] = {0, 0};
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    for (int64_t i0 = tid - lane; i0 < a.N; i0 += stride) {
      const int64_t i = i0 + lane;
      uint64_t m = 0;
      if (i < a.N && a.up[i] && a.member[i]) {
        live[0] += 1;
        m = row_mask(a.know + i * U, U);
      }
      warp_column_counts(m, U, cnt);
    }
    atomicAdd(&s_col[lane], cnt[0]);
    if (U > 32) atomicAdd(&s_col[lane + 32], cnt[1]);
  }
  block_sum<1>(live, red);  // its syncs also publish s_col
  if (evicting) {
    if (threadIdx.x == 0) atomicAdd(&sc[kLive], red[0][0]);
    if (threadIdx.x < U && s_col[threadIdx.x]) {
      atomicAdd(&sc[kCols + threadIdx.x], static_cast<u64>(s_col[threadIdx.x]));
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sc[kCommitDone], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // per slot (warps 0 and 1): coverage, done, the commit masks
  if (warp < 2) {
    const int u = threadIdx.x;
    bool active = false, done = false, c_dead = false, c_left = false, c_alive = false;
    if (u < U) {
      active = a.r_active[u];
      const int kind = a.r_kind[u];
      float cov_out = a.r_coverage[u];
      if (evicting) {
        const float cov = live_coverage(__ldcg(&sc[kCols + u]), __ldcg(&sc[kLive]));
        done = active && cov >= 0.995f && kind != kSuspect;
        const Commits c = release_commits(done, cov, kind);
        c_dead = c.dead;
        c_left = c.left;
        c_alive = c.alive;
        cov_out = done ? 0.0f : cov;
      }
      a.r_coverage_out[u] = cov_out;
      sc[kCols + u] = 0;
    }
    const uint32_t m_done = __ballot_sync(kFull, done);
    const uint32_t m_dead = __ballot_sync(kFull, c_dead);
    const uint32_t m_left = __ballot_sync(kFull, c_left);
    const uint32_t m_alive = __ballot_sync(kFull, c_alive);
    const uint32_t m_after = __ballot_sync(kFull, active && !done);
    if (lane == 0) {
      s_masks[warp][0] = m_done;
      s_masks[warp][1] = m_dead;
      s_masks[warp][2] = m_left;
      s_masks[warp][3] = m_alive;
      s_masks[warp][4] = m_after;
    }
  }
  __syncthreads();
  auto mask = [&](int w) -> uint64_t {
    return static_cast<uint64_t>(s_masks[0][w]) | (static_cast<uint64_t>(s_masks[1][w]) << 32);
  };
  const uint64_t after = mask(4);
  if (threadIdx.x == 0) {
    // lax.top_k of (active ? 0 : 1) * (U - slot): the free slots
    // ascending, then the others ascending (score 0)
    int n = 0;
    for (int u = 0; u < U && n < A; ++u) {
      if (!((after >> u) & 1ull)) {
        s_slot[n] = u;
        s_fscore[n++] = U - u;
      }
    }
    for (int u = 0; u < U && n < A; ++u) {
      if ((after >> u) & 1ull) {
        s_slot[n] = u;
        s_fscore[n++] = 0;
      }
    }
    for (int k = 0; k < A; ++k) {
      const u64 key = __ldcg(&sc[kTop + k]);
      s_score[k] = key_value(key);
      s_subj[k] = key_index(key);
      s_ok[k] = s_score[k] > 0 && s_fscore[k] > 0;
    }
    sc[kKeep] = ~mask(0);
    sc[kCommitDead] = mask(1);
    sc[kCommitLeft] = mask(2);
    sc[kCommitAlive] = mask(3);
    sc[kLive] = 0;
    sc[kCommitDone] = 0;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < A) {
    a.subjects_out[t] = s_subj[t];
    a.slots_out[t] = s_slot[t];
    a.ok_out[t] = s_ok[t];
    const int32_t match = s_ok[t] ? s_subj[t] : -2;
    sc[kPairs + t] = (static_cast<u64>(static_cast<uint32_t>(match)) << 32) |
                     static_cast<uint32_t>(s_slot[t]);
  }
  if (t < U) {
    bool active = (after >> t) & 1ull;
    int kind = a.r_kind[t];
    int32_t subject = a.r_subject[t], inc = a.r_inc[t], start = a.r_start[t];
    int confirm = a.r_confirm[t];
    for (int k = 0; k < A; ++k) {
      if (s_ok[k] && s_slot[k] == t) {
        active = true;
        kind = a.kind;
        subject = s_subj[k];
        inc = a.inc_of_subject[subject];
        start = a.tick;
        confirm = 1;
      }
    }
    a.r_active_out[t] = active;
    a.r_kind_out[t] = static_cast<int8_t>(kind);
    a.r_subject_out[t] = subject;
    a.r_inc_out[t] = inc;
    a.r_start_out[t] = start;
    a.r_confirm_out[t] = static_cast<int8_t>(confirm);
  }
}

__global__ void __launch_bounds__(kThreads)
originate_seed_kernel(const __grid_constant__ OriginateArgs a) {
  __shared__ int32_t s_match[64], s_slot[64], s_rsubj[64], s_rinc[64];
  const u64* sc = a.scratch;
  const int U = a.U, A = a.A;
  const int64_t N = a.N;
  for (int k = threadIdx.x; k < A; k += blockDim.x) {
    const u64 p = sc[kPairs + k];
    s_match[k] = static_cast<int32_t>(p >> 32);
    s_slot[k] = static_cast<int32_t>(static_cast<uint32_t>(p));
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_rsubj[u] = a.r_subject[u];
    s_rinc[u] = a.r_inc[u];
  }
  __syncthreads();
  const uint64_t slots = all_slots(U);
  const uint64_t keep = sc[kKeep] & slots;
  const uint64_t c_dead = sc[kCommitDead], c_left = sc[kCommitLeft],
                 c_alive = sc[kCommitAlive];
  const bool keep_all = keep == slots;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t rb = U;
  for (int64_t i0 = gwarp * 32; i0 < N; i0 += warps * 32) {
    const int64_t i = i0 + lane;
    int slot = -1;
    if (i < N) {
      const int32_t rs = a.row_subject[i];
      for (int k = 0; k < A; ++k) {
        if (s_match[k] == rs && s_slot[k] > slot) slot = s_slot[k];
      }
      // _release's committed scatters, at this index
      bool cd = a.committed_dead[i], cl = a.committed_left[i];
      int32_t ci = a.committed_inc[i];
      release_node(i, c_dead, c_left, c_alive, slots, s_rsubj, s_rinc, cd, cl, ci);
      a.committed_dead_out[i] = cd;
      a.committed_left_out[i] = cl;
      a.committed_inc_out[i] = ci;
    }
    const int64_t rows = N - i0 < 32 ? N - i0 : 32;
    warp_copy(a.learn_out + i0 * rb, a.learn_tick + i0 * rb, rows * 2 * rb, lane);
    if (keep_all) {
      warp_copy(a.know_out + i0 * rb, a.know + i0 * rb, rows * rb, lane);
      warp_copy(a.sends_out + i0 * rb, a.sends_left + i0 * rb, rows * rb, lane);
    } else {
      // an evicted slot: know & keep, its budgets cleared
      warp_copy_rows(a.know_out + i0 * rb, a.know + i0 * rb, rows * rb, U, keep, lane);
      warp_copy_rows(a.sends_out + i0 * rb, a.sends_left + i0 * rb, rows * rb, U, keep, lane);
    }
    __syncwarp();
    if (slot >= 0) {
      a.know_out[i * rb + slot] = 1;
      a.learn_out[i * rb + slot] = static_cast<int16_t>(a.tick16);
      a.sends_out[i * rb + slot] = static_cast<int8_t>(a.limit);
    }
    __syncwarp();
  }
}

}  // namespace

// scratch: kLists + A * list_blocks u64, zeroed once (each kernel resets
// what it consumed).
extern "C" int originate(const void* want, const void* row_subject,
                         const void* inc_of_subject, const void* up,
                         const void* member, const void* know,
                         const void* learn_tick, const void* sends_left,
                         const void* committed_dead,
                         const void* committed_left,
                         const void* committed_inc, const void* r_active,
                         const void* r_kind, const void* r_subject,
                         const void* r_inc, const void* r_start,
                         const void* r_confirm, const void* r_coverage,
                         int64_t N, int U, int A, int kind, int tick,
                         int tick16, int limit, void* scratch, int list_blocks,
                         void* know_out, void* learn_out, void* sends_out,
                         void* committed_dead_out, void* committed_left_out,
                         void* committed_inc_out, void* r_active_out,
                         void* r_kind_out, void* r_subject_out,
                         void* r_inc_out, void* r_start_out,
                         void* r_confirm_out, void* r_coverage_out,
                         void* subjects_out, void* slots_out, void* ok_out,
                         void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || A < 1 ||
      A > U || A > N || list_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OriginateArgs a;
  a.want = static_cast<const int32_t*>(want);
  a.row_subject = static_cast<const int32_t*>(row_subject);
  a.inc_of_subject = static_cast<const int32_t*>(inc_of_subject);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.know = static_cast<const uint8_t*>(know);
  a.learn_tick = static_cast<const int16_t*>(learn_tick);
  a.sends_left = static_cast<const int8_t*>(sends_left);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_left = static_cast<const uint8_t*>(committed_left);
  a.committed_inc = static_cast<const int32_t*>(committed_inc);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<const int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_start = static_cast<const int32_t*>(r_start);
  a.r_confirm = static_cast<const int8_t*>(r_confirm);
  a.r_coverage = static_cast<const float*>(r_coverage);
  a.N = N;
  a.U = U;
  a.A = A;
  a.kind = kind;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.scratch = static_cast<u64*>(scratch);
  a.know_out = static_cast<uint8_t*>(know_out);
  a.learn_out = static_cast<int16_t*>(learn_out);
  a.sends_out = static_cast<int8_t*>(sends_out);
  a.committed_dead_out = static_cast<uint8_t*>(committed_dead_out);
  a.committed_left_out = static_cast<uint8_t*>(committed_left_out);
  a.committed_inc_out = static_cast<int32_t*>(committed_inc_out);
  a.r_active_out = static_cast<uint8_t*>(r_active_out);
  a.r_kind_out = static_cast<int8_t*>(r_kind_out);
  a.r_subject_out = static_cast<int32_t*>(r_subject_out);
  a.r_inc_out = static_cast<int32_t*>(r_inc_out);
  a.r_start_out = static_cast<int32_t*>(r_start_out);
  a.r_confirm_out = static_cast<int8_t*>(r_confirm_out);
  a.r_coverage_out = static_cast<float*>(r_coverage_out);
  a.subjects_out = static_cast<int32_t*>(subjects_out);
  a.slots_out = static_cast<int32_t*>(slots_out);
  a.ok_out = static_cast<uint8_t*>(ok_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int per_card[3] = {0, 0, 0};
  const int b1 = persistent_blocks(originate_select_kernel, kThreads, N,
                                   list_blocks, per_card[0]);
  originate_select_kernel<<<b1, kThreads, 0, s>>>(a);
  const int b2 = persistent_blocks(originate_commit_kernel, kThreads, N,
                                   1 << 20, per_card[1]);
  originate_commit_kernel<<<b2, kThreads, 0, s>>>(a);
  const int b3 = persistent_blocks(originate_seed_kernel, kThreads, N,
                                   1 << 20, per_card[2]);
  originate_seed_kernel<<<b3, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
