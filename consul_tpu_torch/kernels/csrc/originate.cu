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
// In place: the kernel updates the state's know / learn_tick / sends_left
// rows, its committed dead / left / inc and its [U] rumor table where
// their values change, and writes nothing else of the state.  The
// (subject, slot, ok) outputs are fresh tensors.
//
// One cooperative launch (cudaLaunchCooperativeKernel: the persistent
// grid of common.cuh:persistent_blocks is co-resident) in up to three
// phases:
//   1. select, over N: each warp keeps the top A of (want, index) as a
//      sorted list spread over its lanes (a 64-bit key: the
//      order-preserving want above the complemented index, so "larger
//      key" is lax.top_k's order, earlier index first among equals); it
//      loads kBatches batches of 32 keys together, then offers them in row
//      order: a batch is filtered against the list's last entry with one
//      ballot and only the survivors are inserted (two ballots and three
//      shuffles each), filtered again after each insert.  The block
//      merges its warps' lists in a three-level tree and writes its top
//      A; it adds its count of wants > 0 to the demand.  The last block to
//      finish merges every block's list into the global top A (kBatches
//      batches loaded together) and compares the demand with the free
//      slots.  Without an eviction it decides the call (below) at once;
//   2. only when evicting (a flag every block reads after the first grid
//      barrier): count the live rows and, per slot, the live rows that
//      know it (common.cuh:warp_column_counts); the last block to finish
//      decides with coverage = count / max(n_live, 1) in IEEE division
//      (the 0.995 and 0.5 bars), then a second grid barrier;
//   3. seed (after the last barrier): each thread matches rows'
//      row_subject against the A allocated subjects and writes the matched
//      cell (know = 1, learn_tick = tick16, sends_left = limit).  Without
//      an eviction the rows are the ones phase 1 found naming a subject
//      (up to kSeedRows a block, kept in shared memory); with one, or past
//      that many, a warp walks 32 rows a step over N, first clearing the
//      evicted columns' know and sends_left cells (16-byte vectors,
//      written back only where a byte was set).
// The decision, by one block: the done mask and the three commit masks,
// r_coverage = evicting ? (done ? 0 : coverage) : r_coverage, the
// free-slot top A (free slots ascending, then the rest), ok = want > 0 and
// a free slot, the plan of phase 3 in the scratch, the (subject, slot,
// ok) outputs.  Its thread 0 applies _release's committed scatters at the
// committing slots' subjects (an or for dead and left, a max of r_inc for
// inc, and the scatter-max of 0 into node 0 that the slots outside the
// alive commit make) from the old table, before the block's threads write
// the new table: the release reads the table the allocation then
// overwrites, and both happen in the deciding block, in that order, so no
// copy of the old table is kept.
// The scratch counters are reset by the block that consumed them, so a
// call needs no memset.
//
// Block form (a node-sharded pool, parallel/mesh.py), launches in turn:
//   select, a launch a block over its rows [row0, row_end): phase 1 over
//     the block's rows, its last CUDA block merging the launch's lists and
//     writing the block's top A keys (global indices) and its demand into
//     the block's slot of a [B, kPartWords] partial buffer;
//   cover, a launch a block: each decides `evicting` from the blocks'
//     demands and the free slots, and only then counts its live rows and
//     per-slot live knowers (phase 2) into its slot;
//   combine, one block on the mesh's first device: the top A of the B * A
//     candidates (the same merge, so among equal wants the earlier global
//     index wins, and with A > L every block gave all its rows), the
//     demand and counts added in block order, then the decision itself
//     (decide, unchanged): the table, the outputs, and the committed
//     scatters at the subjects' cells through writable tables; it writes
//     the plan (pairs, the kept slots, evicting) for the seeds;
//   seed, a launch a block: the evicted columns cleared and the rows
//     seeded over its rows (phase 3's walk).
// The one-device launch is mode 0, the cooperative kernel as before (its
// tables of one block are its own pointers).
//
// Bound on an H100: memory.  The function must read want and row_subject
// (8 bytes a row) and write the seeded cells and the [U] table; with an
// eviction, also read know and up/member (U + 2 bytes a row) and clear
// the evicted columns' set cells: ~8 MB without eviction at N = 1M (~0.0024
// ms at 3.35 TB/s), ~42 MB with one.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace consul_kernels;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSuspect = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatches = 4;  // 32-row steps whose loads a warp issues together
constexpr int kSeedRows = 512;  // rows with a row_subject a block keeps

// launch modes: the one-device cooperative launch, then the block form's
enum Mode { kOneDevice = 0, kSelect = 1, kCover = 2, kCombine = 3, kSeed = 4 };
// a block's partial slot, in u64 words: demand, live rows, 64 per-slot
// live counts, A top keys; the plan after the B slots: A pairs, the kept
// slots, evicting
constexpr int kPDemand = 0, kPLive = 1, kPCols = 2, kPTops = 66, kPartWords = 130;
constexpr int kPlanKeep = 64, kPlanEvicting = 65, kPlanWords = 66;

// scratch layout, in u64 words
constexpr int kSelectDone = 0, kCoverDone = 1, kDemand = 2, kLive = 3;
constexpr int kCols = 4;      // 64 per-slot live coverage counts
constexpr int kEvicting = 68, kKeep = 69;
constexpr int kPairs = 70;    // 64 (match subject, slot) pairs
constexpr int kTop = 134;     // 64 global top keys
constexpr int kLists = 198;   // A keys a block of phase 1

// Built with -DORIGINATE_PHASE_TIMES (build.variant; chip_smoke.py's
// phase split), the kernel stamps %globaltimer into scratch words
// kStamps.. (free while A <= 58; the caller zeroes them): 0 block 0's
// start, then the latest block at 1 the end of its select, 2 the global
// merge and decision, 3 the barrier after them, 4 the start of the seed
// (after the eviction's count, decision and barrier), 5 its end.
constexpr int kStamps = 192;
#ifdef ORIGINATE_PHASE_TIMES
__device__ __forceinline__ void stamp(u64* sc, int k) {
  if (threadIdx.x == 0) {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(&sc[kStamps + k], t);
  }
}
#else
__device__ __forceinline__ void stamp(u64*, int) {}
#endif

struct OriginateArgs {
  const int32_t* want;
  const int32_t* row_subject;
  const int32_t* inc_of_subject;
  const uint8_t* up;
  const uint8_t* member;
  // the state's leaves, updated in place
  uint8_t* know;
  int16_t* learn_tick;
  int8_t* sends_left;
  uint8_t* committed_dead;
  uint8_t* committed_left;
  int32_t* committed_inc;
  uint8_t* r_active;
  int8_t* r_kind;
  int32_t* r_subject;
  int32_t* r_inc;
  int32_t* r_start;
  int8_t* r_confirm;
  float* r_coverage;
  int64_t N;
  int U, A, kind, tick, tick16, limit;
  u64* scratch;
  // the allocation, fresh outputs
  int32_t* subjects_out;
  int32_t* slots_out;
  uint8_t* ok_out;
  // the block form: the launch's mode and rows, the pool's B, the [B,
  // kPartWords] partials (this launch's slot at part_b) and the plan, and
  // the tables of the leaves read or written at a subject
  int mode;
  int64_t row0, row_end;
  int B, part_b;
  u64* part;
  u64* plan;
  MutRows<int32_t> t_inc_of, t_cinc;
  MutRows<uint8_t> t_cdead, t_cleft;
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

// The list's last entry (A - 1), every lane.
__device__ __forceinline__ u64 top_bar(const WarpTop& t, int A) {
  return A <= 32 ? __shfl_sync(kFull, t.lo, A - 1) : __shfl_sync(kFull, t.hi, A - 33);
}

// Offer one key a lane (0 for none): the ones above the list's last
// entry are inserted, in lane order; after each insert the pending keys
// are filtered again against the new last entry (a key at or below it
// would not be inserted), so a batch that fills the list stops early.
__device__ __forceinline__ void top_offer(WarpTop& t, u64 key, int A, int lane) {
  unsigned pending = __ballot_sync(kFull, key > top_bar(t, A));
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    top_insert(t, __shfl_sync(kFull, key, src), A, lane);
    if (pending) pending &= __ballot_sync(kFull, key > top_bar(t, A));
  }
}

// The block's warps' lists merged into warp 0's in a tree: at each level
// warp w takes warp w + step's list (lo half, then hi half), for w a
// multiple of 2 step (every thread calls it).
__device__ void block_top(WarpTop& t, int A, u64* lists, int lane, int warp) {
  for (int step = 1; step < kWarps; step <<= 1) {
    __syncthreads();
    if ((warp & (2 * step - 1)) == step) {
      lists[warp * 64 + lane] = t.lo;
      lists[warp * 64 + 32 + lane] = t.hi;
    }
    __syncthreads();
    if ((warp & (2 * step - 1)) == 0) {
      const int w = warp + step;
      top_offer(t, lists[w * 64 + lane], A, lane);
      top_offer(t, lists[w * 64 + 32 + lane], A, lane);
    }
  }
}

// The keys of `lists` lists of A entries (list l's entry e at
// src[l * stride + e]) merged into warp 0's top A, g (every thread of the
// block calls it; the other warps' g is scratch).
__device__ void merge_lists(const OriginateArgs& a, const u64* src, int64_t lists_n,
                            int64_t stride, u64* lists, int lane, int warp, WarpTop& g) {
  const int64_t total = lists_n * a.A;
  const int64_t step = kWarps * 32 * kBatches;
  auto load = [&](u64 (&keys)[kBatches], int64_t c0) {
#pragma unroll
    for (int r = 0; r < kBatches; ++r) {
      const int64_t c = c0 + r * kWarps * 32 + lane;
      keys[r] = c < total ? __ldcg(&src[(c / a.A) * stride + c % a.A]) : 0ull;
    }
  };
  u64 next[kBatches];  // the next group's keys load while this one is offered
  load(next, static_cast<int64_t>(warp) * 32);
  for (int64_t c0 = static_cast<int64_t>(warp) * 32; c0 < total; c0 += step) {
    u64 keys[kBatches];
#pragma unroll
    for (int r = 0; r < kBatches; ++r) keys[r] = next[r];
    if (c0 + step < total) load(next, c0 + step);
#pragma unroll
    for (int r = 0; r < kBatches; ++r) top_offer(g, keys[r], a.A, lane);
  }
  block_top(g, a.A, lists, lane, warp);
}

// Phase 1's last block: every block's list merged into the global top A
// (kept in the scratch); returns the eviction flag (block-uniform).  In
// the block form (kSelect) the launch's top A and demand go to its slot.
__device__ bool select_finish(const OriginateArgs& a, u64* lists, int lane, int warp) {
  __shared__ bool s_evicting;
  u64* sc = a.scratch;
  // the free slots, loaded before the merge so the load overlaps it
  const uint64_t active = warp == 0 ? warp_slot_mask(a.r_active, a.U) : 0;
  WarpTop g;
  merge_lists(a, sc + kLists, gridDim.x, a.A, lists, lane, warp, g);
  if (warp == 0) {
    u64* top = a.mode == kSelect ? a.part + a.part_b * kPartWords + kPTops : sc + kTop;
    if (lane < a.A) top[lane] = g.lo;
    if (lane + 32 < a.A) top[32 + lane] = g.hi;
    if (lane == 0) {
      const u64 demand = __ldcg(&sc[kDemand]);
      if (a.mode == kSelect) {
        a.part[a.part_b * kPartWords + kPDemand] = demand;
        s_evicting = false;
      } else {
        const u64 free_slots = static_cast<u64>(a.U - __popcll(active));
        s_evicting = demand > free_slots;
        sc[kEvicting] = s_evicting ? 1 : 0;
      }
      sc[kDemand] = 0;
      sc[kSelectDone] = 0;
    }
  }
  __syncthreads();
  return s_evicting;
}

// The call's decision, by every thread of one block, once per call (see
// the header), with `row` the table row of slot threadIdx.x as the block
// loaded it (before the global merge when there is no eviction, so the
// load overlaps it).  Without an eviction, done and the commits are empty
// and r_coverage stays.  The table, the top keys and their subjects'
// incarnations are kept in shared memory; every later read is of those
// copies, so each table leaf is written only where its new value differs
// from the copy.
struct SlotRow {  // slot t's row of the table, as a thread t < U loads it
  bool active;
  int8_t kind, confirm;
  int32_t subject, inc, start;
  float cov;
};

__device__ __forceinline__ SlotRow load_row(const OriginateArgs& a, int t) {
  SlotRow r{};
  if (t < a.U) {
    r.active = a.r_active[t];
    r.kind = a.r_kind[t];
    r.confirm = a.r_confirm[t];
    r.subject = a.r_subject[t];
    r.inc = a.r_inc[t];
    r.start = a.r_start[t];
    r.cov = a.r_coverage[t];
  }
  return r;
}

__device__ void decide(const OriginateArgs& a, bool evicting, const SlotRow& row) {
  __shared__ uint32_t s_masks[2][5];  // per half: done, dead, left, alive, active after
  __shared__ int32_t s_slot[64], s_fscore[64], s_subj[64], s_score[64], s_newinc[64];
  __shared__ bool s_ok[64];
  __shared__ bool s_active[64];
  __shared__ int8_t s_kind[64], s_confirm[64];
  __shared__ int32_t s_subject[64], s_inc[64], s_start[64];
  __shared__ float s_cov[64];
  __shared__ u64 s_count[64], s_live;
  __shared__ int32_t s_ci0;
  u64* sc = a.scratch;
  const int U = a.U, A = a.A;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t < U) {
    s_active[t] = row.active;
    s_kind[t] = row.kind;
    s_subject[t] = row.subject;
    s_inc[t] = row.inc;
    s_start[t] = row.start;
    s_confirm[t] = row.confirm;
    s_cov[t] = row.cov;
    if (evicting) s_count[t] = __ldcg(&sc[kCols + t]);
  }
  if (t >= 64 && t < 64 + A) {
    const u64 key = __ldcg(&sc[kTop + t - 64]);
    s_subj[t - 64] = key_index(key);
    s_score[t - 64] = key_value(key);
  }
  if (t == 128) {
    s_ci0 = a.t_cinc.at(0);
    s_live = evicting ? __ldcg(&sc[kLive]) : 0;
  }
  __syncthreads();
  if (t >= 64 && t < 64 + A) s_newinc[t - 64] = a.t_inc_of.at(s_subj[t - 64]);

  // per slot (warps 0 and 1): coverage, done, the commit masks
  if (warp < 2) {
    const int u = t;
    bool active = false, done = false, c_dead = false, c_left = false, c_alive = false;
    if (u < U) {
      active = s_active[u];
      if (evicting) {
        const float cov = live_coverage(s_count[u], s_live);
        const int kind = s_kind[u];
        done = active && cov >= 0.995f && kind != kSuspect;
        const Commits c = release_commits(done, cov, kind);
        c_dead = c.dead;
        c_left = c.left;
        c_alive = c.alive;
        const float cov_out = done ? 0.0f : cov;
        if (__float_as_uint(cov_out) != __float_as_uint(s_cov[u])) a.r_coverage[u] = cov_out;
        sc[kCols + u] = 0;
      }
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
  if (t == 0) {
    // _release's committed scatters, from the table before this call
    const uint64_t slots = all_slots(U);
    for (uint64_t m = mask(1); m; m &= m - 1) {
      const int32_t x = s_subject[__ffsll(m) - 1];
      if (x >= 0 && x < a.N && !a.t_cdead.at(x)) *a.t_cdead.row(x) = 1;
    }
    for (uint64_t m = mask(2); m; m &= m - 1) {
      const int32_t x = s_subject[__ffsll(m) - 1];
      if (x >= 0 && x < a.N && !a.t_cleft.at(x)) *a.t_cleft.row(x) = 1;
    }
    const uint64_t c_alive = mask(3);
    int32_t ci0 = s_ci0;  // node 0's committed inc as the scatters leave it
    for (uint64_t m = c_alive; m; m &= m - 1) {
      const int u = __ffsll(m) - 1;
      const int32_t x = s_subject[u];
      if (x < 0 || x >= a.N) continue;
      const int32_t old = x == 0 ? ci0 : a.t_cinc.at(x);
      if (s_inc[u] > old) {
        *a.t_cinc.row(x) = s_inc[u];
        if (x == 0) ci0 = s_inc[u];
      }
    }
    if ((c_alive & slots) != slots && ci0 < 0) *a.t_cinc.row(0) = 0;
    sc[kKeep] = ~mask(0);
    sc[kLive] = 0;
    sc[kCoverDone] = 0;
  }
  if (t >= 64 && t < 64 + U) {
    // lax.top_k of (active ? 0 : 1) * (U - slot): the free slots
    // ascending, then the others ascending (score 0); slot u's rank
    const int u = t - 64;
    const uint64_t below = (1ull << u) - 1;
    const uint64_t open = ~after & all_slots(U);
    const bool is_free = (open >> u) & 1ull;
    const int rank = is_free ? __popcll(open & below)
                             : __popcll(open) + __popcll(after & below);
    if (rank < A) {
      s_slot[rank] = u;
      s_fscore[rank] = is_free ? U - u : 0;
    }
  }
  __syncthreads();
  if (t < A) s_ok[t] = s_score[t] > 0 && s_fscore[t] > 0;
  __syncthreads();

  if (t < A) {
    a.subjects_out[t] = s_subj[t];
    a.slots_out[t] = s_slot[t];
    a.ok_out[t] = s_ok[t];
    const int32_t match = s_ok[t] ? s_subj[t] : -2;
    sc[kPairs + t] = (static_cast<u64>(static_cast<uint32_t>(match)) << 32) |
                     static_cast<uint32_t>(s_slot[t]);
  }
  if (t < U) {
    // slot t's row of the new table, written where it changes
    bool active = (after >> t) & 1ull;
    int k_new = -1;
    for (int k = 0; k < A; ++k) {
      if (s_ok[k] && s_slot[k] == t) k_new = k;
    }
    if (k_new >= 0) {
      active = true;
      const int32_t subject = s_subj[k_new], inc = s_newinc[k_new];
      if (s_kind[t] != a.kind) a.r_kind[t] = static_cast<int8_t>(a.kind);
      if (s_subject[t] != subject) a.r_subject[t] = subject;
      if (s_inc[t] != inc) a.r_inc[t] = inc;
      if (s_start[t] != a.tick) a.r_start[t] = a.tick;
      if (s_confirm[t] != 1) a.r_confirm[t] = 1;
    }
    if (active != s_active[t]) a.r_active[t] = active;
  }
  __threadfence();
}

// The [rows, U] byte rows from a row boundary, with the slots in `clear`
// set to 0 where they are not, by the 32 lanes of a warp: 16-byte vectors
// read once and written back only when one of their bytes changes (both
// aligned, U a multiple of 16), bytes otherwise.  (K8's in-place column
// clears of _release.)
__device__ __forceinline__ void warp_clear_rows(uint8_t* d, int64_t bytes, int U,
                                                uint64_t clear, int lane) {
  int64_t done = 0;
  if (aligned16(d) && U % 16 == 0) {
    const int64_t vecs = bytes >> 4;
    for (int64_t v = lane; v < vecs; v += 32) {
      const uint32_t c16 = static_cast<uint32_t>(clear >> ((v << 4) % U)) & 0xffffu;
      if (!c16) continue;
      uint4* p = reinterpret_cast<uint4*>(d) + v;
      const uint4 w = *p;
      uint4 k = w;
      k.x &= ~byte_masks(c16 & 0xfu);
      k.y &= ~byte_masks((c16 >> 4) & 0xfu);
      k.z &= ~byte_masks((c16 >> 8) & 0xfu);
      k.w &= ~byte_masks(c16 >> 12);
      if (k.x != w.x || k.y != w.y || k.z != w.z || k.w != w.w) *p = k;
    }
    done = vecs << 4;
  }
  for (int64_t x = done + lane; x < bytes; x += 32) {
    if (((clear >> (x % U)) & 1ull) && d[x]) d[x] = 0;
  }
}

// Phase 1 over the launch's rows (see the header); in mode 0 its last
// block decides at once when there is no eviction.
__device__ void select_phase(const OriginateArgs& a, u64* lists, int32_t* s_row,
                             int32_t* s_rsubj, int& s_nrows, int lane, int warp) {
  __shared__ u64 red[1][32];
  __shared__ bool last;
  u64* sc = a.scratch;
  const int A = a.A;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  WarpTop t;
  u64 demand[1] = {0};
  for (int64_t i0 = a.row0 + gwarp * 32; i0 < a.row_end; i0 += warps * 32 * kBatches) {
    u64 keys[kBatches];  // the warp's next batches, offered in row order
    int32_t rs[kBatches];
#pragma unroll
    for (int r = 0; r < kBatches; ++r) {
      const int64_t i = i0 + r * warps * 32 + lane;
      keys[r] = 0;
      rs[r] = -1;
      if (i < a.row_end) {
        const int32_t w = a.want[i];
        rs[r] = a.row_subject[i];
        demand[0] += w > 0;
        keys[r] = make_key(w, i);
      }
    }
#pragma unroll
    for (int r = 0; r < kBatches; ++r) {
      top_offer(t, keys[r], A, lane);
      if (rs[r] >= 0 && a.mode == kOneDevice) {
        const int at = atomicAdd(&s_nrows, 1);
        if (at < kSeedRows) {
          s_row[at] = static_cast<int32_t>(i0 + r * warps * 32 + lane);
          s_rsubj[at] = rs[r];
        }
      }
    }
  }
  block_top(t, A, lists, lane, warp);
  if (warp == 0) {
    u64* mine = sc + kLists + static_cast<int64_t>(blockIdx.x) * A;
    if (lane < A) mine[lane] = t.lo;
    if (lane + 32 < A) mine[lane + 32] = t.hi;
  }
  block_sum<1>(demand, red);
  if (threadIdx.x == 0 && red[0][0]) atomicAdd(&sc[kDemand], red[0][0]);
  stamp(sc, 1);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sc[kSelectDone], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    const SlotRow row = load_row(a, threadIdx.x);
    if (!select_finish(a, lists, lane, warp) && a.mode == kOneDevice) decide(a, false, row);
    stamp(sc, 2);
  }
}

// Phase 2 over the launch's rows: the live rows and per-slot live
// knowers; the last block decides (mode 0) or writes the launch's counts
// into its slot (kCover).
__device__ void cover_phase(const OriginateArgs& a, int lane) {
  __shared__ uint32_t s_col[64];
  __shared__ u64 red[1][32];
  __shared__ bool last;
  u64* sc = a.scratch;
  const int U = a.U;
  if (threadIdx.x < 64) s_col[threadIdx.x] = 0;
  __syncthreads();
  u64 live[1] = {0};
  uint32_t cnt[2] = {0, 0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i0 = a.row0 + tid - lane; i0 < a.row_end; i0 += stride * kBatches) {
    uint64_t m[kBatches];  // the rows' loads issued together
#pragma unroll
    for (int r = 0; r < kBatches; ++r) {
      const int64_t i = i0 + r * stride + lane;
      bool is_live = false;
      uint64_t k = 0;
      if (i < a.row_end) {
        is_live = (a.up[i] != 0) & (a.member[i] != 0);
        k = row_mask(a.know + i * U, U);
      }
      live[0] += is_live;
      m[r] = is_live ? k : 0;
    }
#pragma unroll
    for (int r = 0; r < kBatches; ++r) warp_column_counts(m[r], U, cnt);
  }
  atomicAdd(&s_col[lane], cnt[0]);
  if (U > 32) atomicAdd(&s_col[lane + 32], cnt[1]);
  block_sum<1>(live, red);  // its syncs also publish s_col
  if (threadIdx.x == 0) atomicAdd(&sc[kLive], red[0][0]);
  if (threadIdx.x < U && s_col[threadIdx.x]) {
    atomicAdd(&sc[kCols + threadIdx.x], static_cast<u64>(s_col[threadIdx.x]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sc[kCoverDone], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.mode == kOneDevice) {
    decide(a, true, load_row(a, threadIdx.x));
    return;
  }
  u64* mine = a.part + a.part_b * kPartWords;
  for (int u = threadIdx.x; u < 64; u += blockDim.x) {
    mine[kPCols + u] = u < U ? __ldcg(&sc[kCols + u]) : 0;
    sc[kCols + u] = 0;
  }
  if (threadIdx.x == 0) {
    mine[kPLive] = __ldcg(&sc[kLive]);
    sc[kLive] = 0;
    sc[kCoverDone] = 0;
  }
}

// Phase 3 over the launch's rows: the evicted columns cleared (when
// `evicted`) and the rows naming an allocated subject seeded, from the
// (subject, slot) pairs `pairs`.
__device__ void seed_phase(const OriginateArgs& a, const u64* pairs, uint64_t evicted,
                           const int32_t* s_row, const int32_t* s_rsubj, int s_nrows,
                           int lane, int warp) {
  __shared__ int32_t s_match[64], s_slot[64];
  u64* sc = a.scratch;
  const int U = a.U, A = a.A;
  for (int k = threadIdx.x; k < A; k += blockDim.x) {
    const u64 p = __ldcg(&pairs[k]);
    s_match[k] = static_cast<int32_t>(p >> 32);
    s_slot[k] = static_cast<int32_t>(static_cast<uint32_t>(p));
  }
  __syncthreads();
  auto seed = [&](int64_t row, int32_t rs) {
    int slot = -1;
    for (int k = 0; k < A; ++k) {
      if (s_match[k] == rs && s_slot[k] > slot) slot = s_slot[k];
    }
    if (slot >= 0) {
      const int64_t cell = row * U + slot;
      a.know[cell] = 1;
      a.learn_tick[cell] = static_cast<int16_t>(a.tick16);
      a.sends_left[cell] = static_cast<int8_t>(a.limit);
    }
  };
  if (a.mode == kOneDevice && !evicted && s_nrows <= kSeedRows) {
    // no column to clear: the rows phase 1 kept are all a seed can take
    for (int e = threadIdx.x; e < s_nrows; e += blockDim.x) seed(s_row[e], s_rsubj[e]);
    __syncthreads();
    stamp(sc, 5);
    return;
  }
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t end = a.row_end;
  for (int64_t i0 = a.row0 + gwarp * 32; i0 < end; i0 += warps * 32 * kBatches) {
    int32_t rs[kBatches];
#pragma unroll
    for (int r = 0; r < kBatches; ++r) {
      const int64_t i = i0 + r * warps * 32 + lane;
      rs[r] = i < end ? a.row_subject[i] : -1;
    }
#pragma unroll
    for (int r = 0; r < kBatches; ++r) {
      const int64_t b0 = i0 + r * warps * 32;  // warp-uniform
      if (b0 >= end) break;
      if (evicted) {
        // _release's column clears (know & keep, the freed slots' budgets)
        const int64_t bytes = (end - b0 < 32 ? end - b0 : 32) * U;
        warp_clear_rows(a.know + b0 * U, bytes, U, evicted, lane);
        warp_clear_rows(reinterpret_cast<uint8_t*>(a.sends_left) + b0 * U, bytes, U,
                        evicted, lane);
        __syncwarp();  // a cleared cell a lane's seed may take again
      }
      if (b0 + lane < end) seed(b0 + lane, rs[r]);
    }
  }
  __syncthreads();
  stamp(sc, 5);
}

// The block form's combine, one block: the B blocks' top A keys merged,
// their demands and counts added in block order, the decision, the plan.
__device__ void combine(const OriginateArgs& a, u64* lists, int lane, int warp) {
  __shared__ bool s_evicting;
  u64* sc = a.scratch;
  const int U = a.U, A = a.A;
  const uint64_t active = warp == 0 ? warp_slot_mask(a.r_active, U) : 0;
  WarpTop g;
  merge_lists(a, a.part + kPTops, a.B, kPartWords, lists, lane, warp, g);
  if (warp == 0) {
    if (lane < A) sc[kTop + lane] = g.lo;
    if (lane + 32 < A) sc[kTop + 32 + lane] = g.hi;
    if (lane == 0) {
      u64 demand = 0;
      for (int b = 0; b < a.B; ++b) demand += a.part[b * kPartWords + kPDemand];
      s_evicting = demand > static_cast<u64>(U - __popcll(active));
    }
  }
  __syncthreads();
  const bool evicting = s_evicting;
  if (evicting) {
    for (int u = threadIdx.x; u <= U; u += blockDim.x) {
      const int w = u < U ? kPCols + u : kPLive;
      u64 t = 0;
      for (int b = 0; b < a.B; ++b) t += a.part[b * kPartWords + w];
      sc[u < U ? kCols + u : kLive] = t;
    }
  }
  __threadfence_block();
  __syncthreads();
  decide(a, evicting, load_row(a, threadIdx.x));
  __syncthreads();
  for (int k = threadIdx.x; k < A; k += blockDim.x) a.plan[k] = sc[kPairs + k];
  if (threadIdx.x == 0) {
    a.plan[kPlanKeep] = evicting ? sc[kKeep] : ~0ull;
    a.plan[kPlanEvicting] = evicting;
  }
}

// kCombineLaunch: the block form's combine, an instantiation of its own (so a
// profile tells it from the blocks' launches)
template <bool kCombineLaunch>
__global__ void __launch_bounds__(kThreads)
originate_kernel(const __grid_constant__ OriginateArgs a) {
  __shared__ u64 lists[kWarps * 64];
  // the block's rows of phase 1 that name a row_subject (a seed can take
  // no other row), kept for phase 3 unless there are more than kSeedRows
  __shared__ int32_t s_row[kSeedRows], s_rsubj[kSeedRows];
  __shared__ int s_nrows;
  __shared__ bool s_evicting;
  u64* sc = a.scratch;
  const int U = a.U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kCombineLaunch) {
    combine(a, lists, lane, warp);
    return;
  }
  if (a.mode == kSeed) {
    const uint64_t evicted = a.plan[kPlanEvicting] ? ~a.plan[kPlanKeep] & all_slots(U) : 0;
    seed_phase(a, a.plan, evicted, s_row, s_rsubj, 0, lane, warp);
    return;
  }
  if (a.mode == kCover) {
    const uint64_t active = warp == 0 ? warp_slot_mask(a.r_active, U) : 0;
    if (threadIdx.x == 0) {
      u64 demand = 0;
      for (int b = 0; b < a.B; ++b) demand += a.part[b * kPartWords + kPDemand];
      s_evicting = demand > static_cast<u64>(U - __popcll(active));
    }
    __syncthreads();
    if (s_evicting) cover_phase(a, lane);
    return;
  }
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) stamp(sc, 0);
  if (threadIdx.x == 0) s_nrows = 0;
  __syncthreads();

  // 1. select
  select_phase(a, lists, s_row, s_rsubj, s_nrows, lane, warp);
  if (a.mode == kSelect) return;
  __threadfence();
  grid.sync();
  stamp(sc, 3);

  // 2. the live coverage, only when evicting
  const bool evicting = __ldcg(&sc[kEvicting]) != 0;  // grid-uniform
  if (evicting) {
    cover_phase(a, lane);
    __threadfence();
    grid.sync();
  }

  // 3. seed
  stamp(sc, 4);
  const uint64_t evicted = evicting ? ~__ldcg(&sc[kKeep]) & all_slots(U) : 0;
  seed_phase(a, sc + kPairs, evicted, s_row, s_rsubj, s_nrows, lane, warp);
}

}  // namespace

// scratch: kLists + A * list_blocks u64, zeroed once (each phase resets
// what it consumed).  `mode` is Mode: 0 the one-device cooperative launch
// (rows = N, row0 = 0, B = 1 tables of its own pointers, part and plan
// null); the block form's select, cover and seed over global rows [row0,
// row0 + rows) with the leaves read at a row (want, row_subject, up,
// member, know, learn_tick, sends_left) local to the block, and its
// combine (one block, the first device).  tables: 4 tables of B base
// pointers (inc_of_subject, committed_dead, committed_left,
// committed_inc), L rows a block; part: [B, kPartWords] u64 (the launch's
// slot at part_b); plan: [kPlanWords] u64.
extern "C" int originate(const void* want, const void* row_subject,
                         const void* inc_of_subject, const void* up,
                         const void* member, void* know, void* learn_tick,
                         void* sends_left, void* committed_dead,
                         void* committed_left, void* committed_inc,
                         void* r_active, void* r_kind, void* r_subject,
                         void* r_inc, void* r_start, void* r_confirm,
                         void* r_coverage, int64_t N, int U, int A, int kind,
                         int tick, int tick16, int limit, void* scratch,
                         int list_blocks, void* subjects_out, void* slots_out,
                         void* ok_out, int mode, int64_t row0, int64_t rows,
                         const void* tables, int B, int64_t L, int part_b,
                         void* part, void* plan, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || A < 1 ||
      A > U || A > N || list_blocks < 1 || mode < kOneDevice || mode > kSeed ||
      row0 < 0 || rows < 1 || row0 + rows > N || B < 1 || B > kMaxBlocks || !tables ||
      (mode != kOneDevice && (!part || !plan || part_b < 0 || part_b >= B))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OriginateArgs a;
  a.want = shifted<const int32_t>(const_cast<void*>(want), row0);
  a.row_subject = shifted<const int32_t>(const_cast<void*>(row_subject), row0);
  a.inc_of_subject = static_cast<const int32_t*>(inc_of_subject);
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.know = shifted<uint8_t>(know, row0, U);
  a.learn_tick = shifted<int16_t>(learn_tick, row0, U);
  a.sends_left = shifted<int8_t>(sends_left, row0, U);
  a.committed_dead = static_cast<uint8_t*>(committed_dead);
  a.committed_left = static_cast<uint8_t*>(committed_left);
  a.committed_inc = static_cast<int32_t*>(committed_inc);
  a.r_active = static_cast<uint8_t*>(r_active);
  a.r_kind = static_cast<int8_t*>(r_kind);
  a.r_subject = static_cast<int32_t*>(r_subject);
  a.r_inc = static_cast<int32_t*>(r_inc);
  a.r_start = static_cast<int32_t*>(r_start);
  a.r_confirm = static_cast<int8_t*>(r_confirm);
  a.r_coverage = static_cast<float*>(r_coverage);
  a.N = N;
  a.U = U;
  a.A = A;
  a.kind = kind;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.scratch = static_cast<u64*>(scratch);
  a.subjects_out = static_cast<int32_t*>(subjects_out);
  a.slots_out = static_cast<int32_t*>(slots_out);
  a.ok_out = static_cast<uint8_t*>(ok_out);
  a.mode = mode;
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.B = B;
  a.part_b = part_b;
  a.part = static_cast<u64*>(part);
  a.plan = static_cast<u64*>(plan);
  a.t_inc_of = mut_rows<int32_t>(tables, 0, B, L);
  a.t_cdead = mut_rows<uint8_t>(tables, 1, B, L);
  a.t_cleft = mut_rows<uint8_t>(tables, 2, B, L);
  a.t_cinc = mut_rows<int32_t>(tables, 3, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static PerCard per_card;
  const int blocks = persistent_blocks(originate_kernel<false>, kThreads, rows,
                                       list_blocks, per_card);
  if (mode == kCombine) {
    originate_kernel<true><<<1, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != kOneDevice) {
    originate_kernel<false><<<blocks, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(originate_kernel<false>), dim3(blocks),
      dim3(kThreads), args, 0, s));
}
