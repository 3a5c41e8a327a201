// K12 refutation + expire: a live subject that hears it is suspected (or
// declared dead) refutes, then slots whose dissemination window passed are
// freed, committing what a majority heard, every probe tick.
//
// Replaces: consul_tpu/models/swim.py _refutation, which XLA runs as [U]
// gathers of the subjects' knowledge and ground truth, [U] -> [N]
// scatter-max / scatter-add of the incarnation and the Lifeguard score and
// three [N, U] selects that reseed the refuted columns at their subjects;
// and _expire with _release, which XLA runs as an [N, U] live-coverage
// reduction, the [U] done and commit masks, three [U] -> [N] scatters into
// the committed leaves and two [N, U] column clears.
//
// In place: refutation updates the state's incarnation, awareness, know,
// learn_tick, sends_left, r_kind, r_inc and r_start; expire its know,
// sends_left, committed_dead / left / inc, r_active and r_coverage.  Each
// writes a value only where it changes (a row's 16-byte vectors only when
// one of their bytes changes, common.cuh:row_write), and neither copies a
// row.
//
// refutation, one launch over a persistent grid:
//   1. every block computes need[u] = an active suspect or dead slot whose
//      subject knows it, is up and a member, and whose r_inc >= the
//      subject's incarnation (<= 64 gathers, a lane a slot, redundantly
//      per block), then counts itself done deciding (one atomic);
//   2. the Lifeguard score of every node (when awareness_max > 0): int8(a
//      + the needing slots whose subject is the node), clamped to [0,
//      awareness_max - 1], 16 nodes a thread (__vadd4 wraps a byte as the
//      int8 cast does, __vmaxs4 / __vmins4 clamp), a vector written only
//      when it changes.  _refutation clamps every node, not only the
//      subjects, so this pass runs on every call (1 MB at N = 1M);
//   3. only when some slot needs: thread i rewrites the needing columns of
//      row i: know = one-hot at the subject, sends_left = the budget there
//      and 0 elsewhere, learn_tick = t16(tick) at the subject;
//   4. the last block to count itself done writes the [U] table (ALIVE,
//      r_inc = the subject's new incarnation, r_start = tick) and the
//      subjects' incarnations: the max of r_inc + 1 over the needing slots
//      whose subject is the node, and node 0's max with -1 when a slot does
//      not need (the masked scatter-max sends -1 into index 0), written
//      only where it changes.  It resets the count.  Two needing slots of
//      one subject both refute: the score rises by two and both take the
//      larger incarnation, as the scatter-add and scatter-max give.
// Why the writes in place are race-free: the decision reads r_active,
// r_kind, r_inc, r_subject, the subjects' incarnation, up and member and
// know[subject, u].  The table and the incarnations are written in step 4
// alone, by the last block, after every block has counted itself done,
// and so after every block's decision read them.  Steps 2 and 3 run
// while other blocks still decide, and neither touches a cell the
// decision reads: the score is not read, and a needing column's rewrite
// leaves know[subject, u] set (the subject's own cell is the one-hot 1),
// the only cell of those columns that the test reads; the columns of the
// slots that do not need are not written.  Thread i writes only row i.
//
// expire, one cooperative launch (cudaLaunchCooperativeKernel on the
// co-resident grid of common.cuh:persistent_blocks):
//   1. every block reads the [U] table into shared memory, then counts,
//      over a grid-stride walk of N, the live rows and, per slot, the live
//      rows that know it (common.cuh:warp_column_counts) into the scratch;
//      one grid barrier;
//   2. every block computes, from the grid totals and its own copy of the
//      table, coverage = count / max(n_live, 1) (IEEE division: the 0.995
//      and 0.5 bars), life (the suspect or the gossip window by kind), age
//      = tick - r_start, done = active & age >= life & (coverage >= 0.995
//      | age >= 4 life) and _release's commit masks
//      (common.cuh:release_commits).  Block 0 writes r_active and
//      r_coverage and the committed leaves at the committing slots'
//      subjects (or for dead / left, max for inc) and node 0's rule
//      (common.cuh:release_node), reading every node it writes before it
//      writes any.  The last block to read the totals resets the scratch;
//   3. only when some slot is done: thread i clears the done columns of
//      row i of know and sends_left.  learn_tick is not an output: expire
//      leaves it as it was.
// Why the writes in place are race-free: the table is read before the
// grid barrier and written after it, by block 0 alone; every block
// decides from its own shared copy and the totals, which nothing writes
// after the barrier until their last reader resets them.  The count reads
// know before the barrier and the clears write it after.  The committed
// leaves are read nowhere else in the launch.
//
// Block form (a node-sharded pool, parallel/mesh.py).  refutation: a
// launch a block over its rows [row0, row_end) runs steps 1-3 (the
// decision reads the subjects' know cell, up, member and incarnation
// through block tables, the same in every launch, since the table and the
// incarnations are written only after the last launch), then one
// refutation combine (one block, the mesh's first device) decides again
// and runs step 4, the incarnations written in the subjects' blocks
// through a writable table.  expire: count, a launch a block whose last
// CUDA block writes the launch's live rows and per-slot counts into the
// block's slot of a [B, 65] partial buffer; combine, one block: the B
// slots added in block order, step 2's decision and writes (the committed
// leaves at the subjects' cells through writable tables) and the done
// mask into the plan; clear, a launch a block, step 3 on its rows.  The
// one-device launches are mode 0, as before (their tables of one block
// are their own pointers).
//
// Bound on an H100: memory.  refutation needs the [U] table, a 32-byte
// sector of know, up, member, incarnation and the score at each refutable
// slot's subject, the score of every node (N bytes, when awareness_max >
// 0) and, in place, the 32-byte sectors that change: the subjects'
// incarnations and scores and, when a slot refutes, the needing columns'
// cells of know and sends_left that change and the subjects' learn ticks.
// At the main path's mid-convergence state no slot refutes: ~1 MB,
// ~0.0003 ms at 3.35 TB/s, so its time is a launch and the prelude's
// dependent gathers.  expire must read know and up/member (U + 2 bytes a
// row, ~34 MB at N = 1M, U = 32, ~0.010 ms), gather the committed leaves
// at the freed slots' subjects and write in place the sectors of the done
// columns and committed leaves that change.  chip_smoke.py:_detector_bytes
// counts both from the run's data.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace consul_kernels;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kAlive = 0, kSuspect = 1, kDead = 2;
// refutation's scratch: the blocks done deciding
constexpr int kDecided = 0;
// expire's scratch layout, in u64 words: live rows, 64 per-slot counts,
// the blocks that read them
constexpr int kLive = 0, kCols = 1, kRead = 65;
// launch modes: the one-device launch, then the block form's (kBlock:
// refutation's per-block launch; kCount, kClear: expire's)
enum Mode { kOneDevice = 0, kBlock = 1, kCombine = 2, kCount = 3, kClear = 4 };
constexpr int kExpirePart = 65;  // a block's partial: live rows, 64 counts

struct RefuteArgs {
  // the state's leaves (incarnation, awareness, know, learn_tick,
  // sends_left, r_kind, r_inc and r_start updated in place)
  int32_t* incarnation;
  int8_t* awareness;  // null when awareness_max == 0
  const uint8_t* up;
  const uint8_t* member;
  uint8_t* know;
  int16_t* learn_tick;
  int8_t* sends_left;
  const uint8_t* r_active;
  int8_t* r_kind;
  const int32_t* r_subject;
  int32_t* r_inc;
  int32_t* r_start;
  int64_t N;
  int U, amax, tick, tick16, limit;
  u64* scratch;
  // the block form: mode, the launch's rows (awareness is the block's
  // own, unshifted), the subjects' cells' tables
  int mode;
  int64_t row0, row_end;
  MutRows<uint8_t> t_know, t_up, t_member;
  MutRows<int32_t> t_inc;
};

// node i's incarnation after the refutations: the scatter-max of r_inc + 1
// over the needing slots, -1 from the others into index 0
__device__ __forceinline__ int32_t refuted_inc(int64_t i, int32_t inc, u64 need, bool masked,
                                               const int32_t* subj, const int32_t* r_inc) {
  for (u64 m = need; m; m &= m - 1) {
    const int u = __ffsll(m) - 1;
    if (subj[u] != i) continue;
    const int32_t v = wrap_add(r_inc[u], 1);
    inc = v > inc ? v : inc;
  }
  if (i == 0 && masked && inc < -1) inc = -1;
  return inc;
}

// The scores of nodes v0 .. v0 + 3 (a 32-bit word of awareness): each
// byte plus the needing slots whose subject it is, wrapped to int8, then
// clamped to [0, hi].
__device__ __forceinline__ uint32_t score_word(uint32_t w, int64_t v0, u64 need,
                                               const int32_t* subj, uint32_t hi4) {
  uint32_t add = 0;
  for (u64 m = need; m; m &= m - 1) {
    const int64_t off = subj[__ffsll(m) - 1] - v0;
    if (off >= 0 && off < 4) add += 1u << (8 * off);
  }
  return __vmins4(__vmaxs4(__vadd4(w, add), 0u), hi4);
}

// kCombineLaunch: the block form's combine, an instantiation of its own (so a
// profile tells it from the blocks' launches); likewise expire_kernel's
template <bool kCombineLaunch>
__global__ void __launch_bounds__(kThreads)
refutation_kernel(const __grid_constant__ RefuteArgs a) {
  __shared__ int32_t s_subj[64], s_inc[64];
  __shared__ unsigned s_words[2];
  __shared__ bool last;
  const int U = a.U;
  const int64_t N = a.N;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_subj[u] = a.r_subject[u];
    s_inc[u] = a.r_inc[u];
  }
  // 1. the decision, from the old table
  if (threadIdx.x < 64) {  // warps 0 and 1, whole: a lane a slot
    const int u = threadIdx.x;
    bool need = false;
    if (u < U && a.r_active[u] && (a.r_kind[u] == kSuspect || a.r_kind[u] == kDead)) {
      const int32_t subj = a.r_subject[u];
      need = subj >= 0 && subj < N && a.t_know.row(subj, U)[u] && a.t_up.at(subj) &&
             a.t_member.at(subj) && a.r_inc[u] >= a.t_inc.at(subj);
    }
    const unsigned w = __ballot_sync(0xffffffffu, need);
    if ((u & 31) == 0) s_words[u >> 5] = w;
  }
  __syncthreads();
  const bool combine = kCombineLaunch;
  if (threadIdx.x == 0 && !combine) {
    __threadfence();  // this block's reads of the table come before its count
    last = atomicAdd(&a.scratch[kDecided], 1ull) == static_cast<u64>(gridDim.x) - 1;
  }
  const u64 need = static_cast<u64>(s_words[0]) | (static_cast<u64>(s_words[1]) << 32);
  const bool masked = need != all_slots(U);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row0 = a.row0, rows = a.row_end - a.row0;

  // 2. every node's score (the launch's nodes; awareness is its own)
  if (a.amax > 0 && !combine) {
    const uint32_t hi4 = static_cast<uint32_t>(a.amax - 1) * 0x01010101u;
    int64_t done = 0;
    if (aligned16(a.awareness)) {
      uint4* vec = reinterpret_cast<uint4*>(a.awareness);
      const int64_t vecs = rows >> 4;
      for (int64_t v = tid; v < vecs; v += stride) {
        const uint4 w = vec[v];
        const int64_t v0 = row0 + (v << 4);
        const uint4 n = make_uint4(score_word(w.x, v0, need, s_subj, hi4),
                                   score_word(w.y, v0 + 4, need, s_subj, hi4),
                                   score_word(w.z, v0 + 8, need, s_subj, hi4),
                                   score_word(w.w, v0 + 12, need, s_subj, hi4));
        if (n.x != w.x || n.y != w.y || n.z != w.z || n.w != w.w) vec[v] = n;
      }
      done = vecs << 4;
    }
    for (int64_t i = done + tid; i < rows; i += stride) {
      const uint32_t w = static_cast<uint8_t>(a.awareness[i]);
      const uint32_t n = score_word(w, row0 + i, need, s_subj, hi4) & 0xffu;
      if (n != w) a.awareness[i] = static_cast<int8_t>(n);
    }
  }

  // 3. the needing columns of row i
  if (need && !combine) {
    for (int64_t i = row0 + tid; i < a.row_end; i += stride) {
      u64 at = 0;
      for (u64 m = need; m; m &= m - 1) {
        const int u = __ffsll(m) - 1;
        if (s_subj[u] == i) at |= 1ull << u;
      }
      row_write<uint8_t>(a.know + i * U, U, need, at, 1);
      row_write<int8_t>(a.sends_left + i * U, U, need, at, static_cast<int8_t>(a.limit));
      row_write<int16_t>(a.learn_tick + i * U, U, at, at, static_cast<int16_t>(a.tick16));
    }
  }

  // 4. the last block: every block has decided (the block form: its
  // combine, after every block's launch)
  __syncthreads();
  if (a.mode == kBlock) {
    if (threadIdx.x == 0 && last) a.scratch[kDecided] = 0;
    return;
  }
  if (!combine && !last) return;  // block-uniform
  __threadfence();
  int32_t old = 0, inc = 0;
  int64_t node = -1;
  const int t = threadIdx.x;
  if (t < U && ((need >> t) & 1ull)) node = s_subj[t];  // a lane a needing slot
  else if (t == 64 && masked) node = 0;                 // node 0's masked rule
  if (node >= 0) {
    old = a.t_inc.at(node);
    inc = refuted_inc(node, old, need, masked, s_subj, s_inc);
  }
  __syncthreads();  // every old incarnation read before any is written
  if (node >= 0 && inc != old) *a.t_inc.row(node) = inc;
  if (t < U && ((need >> t) & 1ull)) {
    a.r_kind[t] = static_cast<int8_t>(kAlive);
    a.r_inc[t] = inc;
    a.r_start[t] = a.tick;
  }
  if (threadIdx.x == 0 && !combine) a.scratch[kDecided] = 0;  // ready for the next launch
}

struct ExpireArgs {
  // the state's leaves (know, sends_left, the committed leaves, r_active
  // and r_coverage updated in place)
  uint8_t* know;
  int8_t* sends_left;
  const uint8_t* up;
  const uint8_t* member;
  uint8_t* committed_dead;
  uint8_t* committed_left;
  int32_t* committed_inc;
  uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  const int32_t* r_start;
  float* r_coverage;
  int64_t N;
  int U, tick, life_gossip, life_suspect;
  u64* scratch;
  // the block form: mode, B, the launch's rows, the partials (the
  // launch's slot, or all B for the combine), the plan word (done), the
  // committed leaves' tables
  int mode, B;
  int64_t row0, row_end;
  u64* part;
  u64* plan;
  MutRows<uint8_t> t_cdead, t_cleft;
  MutRows<int32_t> t_cinc;
};

template <bool kCombineLaunch>
__global__ void __launch_bounds__(kThreads)
expire_kernel(const __grid_constant__ ExpireArgs a) {
  __shared__ int32_t s_subj[64], s_inc[64], s_start[64];
  __shared__ int8_t s_kind[64];
  __shared__ bool s_active[64];
  __shared__ uint32_t s_col[64];
  __shared__ u64 red[1][32];
  __shared__ uint32_t s_masks[2][4];  // per half: done, dead, left, alive
  u64* sc = a.scratch;
  const int U = a.U;
  const int64_t N = a.row_end;  // the launch's rows end (N for one device)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (a.mode == kClear) {
    const u64 done = __ldcg(a.plan);
    if (!done) return;
    for (int64_t i = a.row0 + tid; i < N; i += stride) {
      row_write<uint8_t>(a.know + i * U, U, done, 0, 0);
      row_write<int8_t>(a.sends_left + i * U, U, done, 0, 0);
    }
    return;
  }

  // 1. the table, then the count
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_subj[u] = a.r_subject[u];
    s_inc[u] = a.r_inc[u];
    s_start[u] = a.r_start[u];
    s_kind[u] = a.r_kind[u];
    s_active[u] = a.r_active[u];
  }
  if (threadIdx.x < 64) s_col[threadIdx.x] = 0;
  __syncthreads();
  const bool combine = kCombineLaunch;
  if (combine) {
    // the B blocks' counts, added in block order, where the count leaves
    // them
    for (int k = threadIdx.x; k <= U; k += blockDim.x) {
      u64 t = 0;
      for (int b = 0; b < a.B; ++b) t += a.part[b * kExpirePart + k];
      sc[k] = t;
    }
    __threadfence_block();
    __syncthreads();
  } else {
    u64 live[1] = {0};
    uint32_t cnt[2] = {0, 0};
    for (int64_t i0 = a.row0 + tid - lane; i0 < N; i0 += stride) {
      const int64_t i = i0 + lane;
      uint64_t m = 0;
      if (i < N && a.up[i] && a.member[i]) {
        live[0] += 1;
        m = row_mask(a.know + i * U, U);
      }
      warp_column_counts(m, U, cnt);
    }
    atomicAdd(&s_col[lane], cnt[0]);
    if (U > 32) atomicAdd(&s_col[lane + 32], cnt[1]);
    block_sum<1>(live, red);  // its syncs also publish s_col
    if (threadIdx.x == 0 && red[0][0]) atomicAdd(&sc[kLive], red[0][0]);
    if (threadIdx.x < U && s_col[threadIdx.x]) {
      atomicAdd(&sc[kCols + threadIdx.x], static_cast<u64>(s_col[threadIdx.x]));
    }
    __threadfence();
    if (a.mode == kCount) {
      // the launch's counts into its slot, by its last block
      __shared__ bool last;
      __syncthreads();
      if (threadIdx.x == 0) {
        last = atomicAdd(&sc[kRead], 1ull) == static_cast<u64>(gridDim.x) - 1;
      }
      __syncthreads();
      if (!last) return;
      __threadfence();
      for (int k = threadIdx.x; k <= U; k += blockDim.x) {
        a.part[k] = __ldcg(&sc[k]);
        sc[k] = 0;
      }
      for (int k = U + 1 + threadIdx.x; k < kRead; k += blockDim.x) sc[k] = 0;
      if (threadIdx.x == 0) sc[kRead] = 0;
      return;
    }
    cg::grid_group grid = cg::this_grid();
    grid.sync();
  }

  // 2. per slot (warps 0 and 1): coverage, done, the commit masks
  if (warp < 2) {
    const int u = threadIdx.x;
    bool done = false;
    Commits c = {false, false, false};
    if (u < U) {
      const bool active = s_active[u];
      const int kind = s_kind[u];
      const float cov = live_coverage(__ldcg(&sc[kCols + u]), __ldcg(&sc[kLive]));
      const int32_t life = kind == kSuspect ? a.life_suspect : a.life_gossip;
      const int32_t age = wrap_sub(a.tick, s_start[u]);
      done = active && age >= life && (cov >= 0.995f || age >= wrap_mul(4, life));
      c = release_commits(done, cov, kind);
      if (blockIdx.x == 0) {
        if (done) a.r_active[u] = 0;
        a.r_coverage[u] = done ? 0.0f : cov;
      }
    }
    const uint32_t m_done = __ballot_sync(0xffffffffu, done);
    const uint32_t m_dead = __ballot_sync(0xffffffffu, c.dead);
    const uint32_t m_left = __ballot_sync(0xffffffffu, c.left);
    const uint32_t m_alive = __ballot_sync(0xffffffffu, c.alive);
    if (lane == 0) {
      s_masks[warp][0] = m_done;
      s_masks[warp][1] = m_dead;
      s_masks[warp][2] = m_left;
      s_masks[warp][3] = m_alive;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the totals read before the count that lets them be reset
    if (combine || atomicAdd(&sc[kRead], 1ull) == static_cast<u64>(gridDim.x) - 1) {
      for (int k = 0; k < kRead; ++k) sc[k] = 0;
      sc[kRead] = 0;  // ready for the next launch
    }
  }
  auto mask = [&](int w) -> u64 {
    return static_cast<u64>(s_masks[0][w]) | (static_cast<u64>(s_masks[1][w]) << 32);
  };
  const u64 slots = all_slots(U);
  const u64 done = mask(0), c_dead = mask(1), c_left = mask(2), c_alive = mask(3);

  // block 0: the committed leaves at the committing subjects and node 0
  if (blockIdx.x == 0) {
    int64_t node = -1;
    bool cd = false, cl = false, cd0 = false, cl0 = false;
    int32_t ci = 0, ci0 = 0;
    const int t = threadIdx.x;
    if (t < U && (((c_dead | c_left | c_alive) >> t) & 1ull)) node = s_subj[t];
    else if (t == 64) node = 0;  // node 0's rule (a max with 0)
    if (node >= a.N) node = -1;
    if (node >= 0) {
      cd0 = cd = a.t_cdead.at(node);
      cl0 = cl = a.t_cleft.at(node);
      ci0 = ci = a.t_cinc.at(node);
      release_node(node, c_dead, c_left, c_alive, slots, s_subj, s_inc, cd, cl, ci);
    }
    __syncthreads();  // every node read before any is written
    if (node >= 0) {
      if (cd != cd0) *a.t_cdead.row(node) = cd;
      if (cl != cl0) *a.t_cleft.row(node) = cl;
      if (ci != ci0) *a.t_cinc.row(node) = ci;
    }
  }
  if (combine) {
    if (threadIdx.x == 0) *a.plan = done;
    return;
  }
  if (!done) return;  // grid-uniform

  // 3. the done columns of row i cleared
  for (int64_t i = a.row0 + tid; i < N; i += stride) {
    row_write<uint8_t>(a.know + i * U, U, done, 0, 0);
    row_write<int8_t>(a.sends_left + i * U, U, done, 0, 0);
  }
}

}  // namespace

// scratch: 1 u64, zeroed once (the last block resets it).
// mode: 0 the one-device launch (row0 = 0, rows = N, B = 1 tables of its
// own pointers); the block form's per-block launch (1: rows [row0, row0
// + rows), incarnation ... sends_left the block's own) and its combine
// (2: one block).  tables: know, up, member, incarnation, B base pointers
// each, L rows a block.
extern "C" int refutation(void* incarnation, void* awareness, const void* up, const void* member,
                          void* know, void* learn_tick, void* sends_left, const void* r_active,
                          void* r_kind, const void* r_subject, void* r_inc, void* r_start,
                          int64_t N, int U, int amax, int tick, int tick16, int limit,
                          void* scratch, int mode, int64_t row0, int64_t rows,
                          const void* tables, int B, int64_t L, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || amax < 0 || amax > 127 ||
      (amax > 0 && !awareness) || mode < kOneDevice || mode > kCombine || row0 < 0 ||
      rows < 1 || row0 + rows > N || B < 1 || B > kMaxBlocks || !tables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RefuteArgs a;
  a.incarnation = shifted<int32_t>(incarnation, row0);
  a.awareness = static_cast<int8_t*>(awareness);
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.know = shifted<uint8_t>(know, row0, U);
  a.learn_tick = shifted<int16_t>(learn_tick, row0, U);
  a.sends_left = shifted<int8_t>(sends_left, row0, U);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<int32_t*>(r_inc);
  a.r_start = static_cast<int32_t*>(r_start);
  a.N = N;
  a.U = U;
  a.amax = amax;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.scratch = static_cast<u64*>(scratch);
  a.mode = mode;
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.t_know = mut_rows<uint8_t>(tables, 0, B, L);
  a.t_up = mut_rows<uint8_t>(tables, 1, B, L);
  a.t_member = mut_rows<uint8_t>(tables, 2, B, L);
  a.t_inc = mut_rows<int32_t>(tables, 3, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCombine) {
    refutation_kernel<true><<<1, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  static PerCard per_card;
  const int blocks =
      persistent_blocks(refutation_kernel<false>, kThreads, rows, 1 << 20, per_card);
  refutation_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// scratch: kRead + 1 u64, zeroed once (the totals' last reader resets
// them).
// mode: 0 the one-device cooperative launch (row0 = 0, rows = N, B = 1
// tables of its committed leaves); the block form's count (3: part the
// block's [65] slot) and clear (4: plan the done word) over rows [row0,
// row0 + rows), know ... member the block's own, and its combine (2: one
// block, part the B slots).  tables: committed_dead, committed_left,
// committed_inc, B base pointers each, L rows a block.
extern "C" int expire(void* know, void* sends_left, const void* up, const void* member,
                      void* committed_dead, void* committed_left, void* committed_inc,
                      void* r_active, const void* r_kind, const void* r_subject,
                      const void* r_inc, const void* r_start, void* r_coverage, int64_t N,
                      int U, int tick, int life_gossip, int life_suspect, void* scratch,
                      int mode, int64_t row0, int64_t rows, const void* tables, int B,
                      int64_t L, void* part, void* plan, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 ||
      (mode != kOneDevice && mode != kCombine && mode != kCount && mode != kClear) ||
      row0 < 0 || rows < 1 || row0 + rows > N || B < 1 || B > kMaxBlocks || !tables ||
      ((mode == kCount || mode == kCombine) && !part) ||
      ((mode == kClear || mode == kCombine) && !plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExpireArgs a;
  a.know = shifted<uint8_t>(know, row0, U);
  a.sends_left = shifted<int8_t>(sends_left, row0, U);
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.committed_dead = static_cast<uint8_t*>(committed_dead);
  a.committed_left = static_cast<uint8_t*>(committed_left);
  a.committed_inc = static_cast<int32_t*>(committed_inc);
  a.r_active = static_cast<uint8_t*>(r_active);
  a.r_kind = static_cast<const int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_start = static_cast<const int32_t*>(r_start);
  a.r_coverage = static_cast<float*>(r_coverage);
  a.N = N;
  a.U = U;
  a.tick = tick;
  a.life_gossip = life_gossip;
  a.life_suspect = life_suspect;
  a.scratch = static_cast<u64*>(scratch);
  a.mode = mode;
  a.B = B;
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.part = static_cast<u64*>(part);
  a.plan = static_cast<u64*>(plan);
  a.t_cdead = mut_rows<uint8_t>(tables, 0, B, L);
  a.t_cleft = mut_rows<uint8_t>(tables, 1, B, L);
  a.t_cinc = mut_rows<int32_t>(tables, 2, B, L);
  static PerCard per_card;
  const int blocks =
      persistent_blocks(expire_kernel<false>, kThreads, rows, 1 << 20, per_card);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCombine) {
    expire_kernel<true><<<1, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != kOneDevice) {
    expire_kernel<false><<<blocks, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(expire_kernel<false>), dim3(blocks), dim3(kThreads),
      args, 0, s));
}
