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
// refutation, one launch: each block computes need[u] = an active suspect
// or dead slot whose subject knows it, is up and a member, and whose
// r_inc >= the subject's incarnation (<= 64 gathers, redundantly per
// block).  Thread i writes its fresh incarnation (the max of r_inc + 1 over
// the needing slots whose subject is i) and Lifeguard score (plus their
// count, cast to int8, clamped to [0, awareness_max - 1]); each warp
// copies its 32 rows of know / learn_tick / sends_left and every thread
// rewrites its row's needing columns: one-hot at the subject, t16(tick)
// and the budget there, 0 elsewhere.  Block 0 writes the [U] table: ALIVE,
// r_inc = the subject's new incarnation, r_start = tick.  Two needing
// slots of one subject both refute: the score rises by two and both take
// the larger incarnation, as the scatter-add and scatter-max give.
//
// expire, two launches behind one entry point:
//   1. count, a persistent grid over N: live rows and, per slot, the live
//      rows that know it (common.cuh:warp_column_counts); the last block
//      to finish computes coverage = count / max(n_live, 1) (IEEE
//      division: the 0.995 and 0.5 bars), life (the suspect or the gossip
//      window by kind), age = tick - r_start, done = active & age >= life &
//      (coverage >= 0.995 | age >= 4 life), _release's commit masks
//      (common.cuh:release_commits), r_active and r_coverage, and the keep
//      and commit words of launch 2;
//   2. apply, a persistent grid over N: the warp's rows of know and
//      sends_left copied with the done columns cleared
//      (common.cuh:warp_copy_rows) and committed dead / left / inc read as
//      per-node lookups of the committing slots (common.cuh:release_node).
//      learn_tick is not an output: expire leaves it as it was.
//
// Bound on an H100: memory.  refutation needs the [U] table, a 32-byte
// sector of know, up, member, incarnation and the score at each refutable
// slot's subject, and, writing in place, the sectors that change: the
// subjects' incarnations and scores and the needing columns' cells (a few
// KB with no refutation; the columns' know sectors, up to U bytes a row,
// when one refutes).  expire must read know and up/member (U + 2 bytes a
// row, ~34 MB at N = 1M, U = 32, ~0.010 ms at 3.35 TB/s), the committed
// leaves at the freed slots' subjects, and write in place the sectors of
// the done columns and committed leaves that change.  The fresh-output row
// copies (refutation 4U bytes read and written a row, 128 MB each way;
// expire 2U and the committed leaves, 70 MB each way) are the price of
// never writing a tensor it was given.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAlive = 0, kSuspect = 1, kDead = 2;
// expire's scratch layout, in u64 words
constexpr int kDone = 0, kLive = 1, kCols = 2;  // 64 per-slot counts
constexpr int kKeep = 66, kCommitDead = 67, kCommitLeft = 68, kCommitAlive = 69;

struct RefuteArgs {
  const int32_t* incarnation;
  const int8_t* awareness;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* know;
  const int16_t* learn_tick;
  const int8_t* sends_left;
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  const int32_t* r_start;
  int64_t N;
  int U, amax, tick, tick16, limit;
  int32_t* incarnation_out;
  int8_t* awareness_out;  // null when awareness_max == 0
  uint8_t* know_out;
  int16_t* learn_out;
  int8_t* sends_out;
  int8_t* r_kind_out;
  int32_t* r_inc_out;
  int32_t* r_start_out;
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

__global__ void __launch_bounds__(kThreads)
refutation_kernel(const __grid_constant__ RefuteArgs a) {
  __shared__ int32_t s_subj[64], s_inc[64];
  __shared__ unsigned s_words[2];
  const int U = a.U;
  const int64_t N = a.N;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_subj[u] = a.r_subject[u];
    s_inc[u] = a.r_inc[u];
  }
  if (threadIdx.x < 64) {  // warps 0 and 1, whole: a lane a slot
    const int u = threadIdx.x;
    bool need = false;
    if (u < U && a.r_active[u] && (a.r_kind[u] == kSuspect || a.r_kind[u] == kDead)) {
      const int32_t subj = a.r_subject[u];
      need = subj >= 0 && subj < N && a.know[subj * static_cast<int64_t>(U) + u] &&
             a.up[subj] && a.member[subj] && a.r_inc[u] >= a.incarnation[subj];
    }
    const unsigned w = __ballot_sync(0xffffffffu, need);
    if ((u & 31) == 0) s_words[u >> 5] = w;
  }
  __syncthreads();
  const u64 need = static_cast<u64>(s_words[0]) | (static_cast<u64>(s_words[1]) << 32);
  const bool masked = need != all_slots(U);
  if (blockIdx.x == 0) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const bool n = (need >> u) & 1ull;
      int32_t inc = a.r_inc[u];
      if (n) {
        const int32_t subj = s_subj[u];
        inc = refuted_inc(subj, a.incarnation[subj], need, masked, s_subj, s_inc);
      }
      a.r_kind_out[u] = n ? static_cast<int8_t>(kAlive) : a.r_kind[u];
      a.r_inc_out[u] = inc;
      a.r_start_out[u] = n ? a.tick : a.r_start[u];
    }
  }
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t rb = U;
  for (int64_t i0 = gwarp * 32; i0 < N; i0 += warps * 32) {
    const int64_t i = i0 + lane;
    if (i < N) {
      a.incarnation_out[i] = refuted_inc(i, a.incarnation[i], need, masked, s_subj, s_inc);
      if (a.amax > 0) {
        int bumped = a.awareness[i];
        for (u64 m = need; m; m &= m - 1) bumped += s_subj[__ffsll(m) - 1] == i;
        int c = static_cast<int8_t>(bumped);
        c = c < 0 ? 0 : (c > a.amax - 1 ? a.amax - 1 : c);
        a.awareness_out[i] = static_cast<int8_t>(c);
      }
    }
    const int64_t rows = N - i0 < 32 ? N - i0 : 32;
    warp_copy(a.know_out + i0 * rb, a.know + i0 * rb, rows * rb, lane);
    warp_copy(a.learn_out + i0 * rb, a.learn_tick + i0 * rb, rows * 2 * rb, lane);
    warp_copy(a.sends_out + i0 * rb, a.sends_left + i0 * rb, rows * rb, lane);
    __syncwarp();
    if (need && i < N) {
      for (u64 m = need; m; m &= m - 1) {
        const int u = __ffsll(m) - 1;
        const bool at = s_subj[u] == i;
        a.know_out[i * rb + u] = at;
        a.sends_out[i * rb + u] = at ? static_cast<int8_t>(a.limit) : 0;
        if (at) a.learn_out[i * rb + u] = static_cast<int16_t>(a.tick16);
      }
    }
    __syncwarp();
  }
}

struct ExpireArgs {
  const uint8_t* know;
  const int8_t* sends_left;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* committed_dead;
  const uint8_t* committed_left;
  const int32_t* committed_inc;
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  const int32_t* r_start;
  int64_t N;
  int U, tick, life_gossip, life_suspect;
  u64* scratch;
  uint8_t* know_out;
  int8_t* sends_out;
  uint8_t* committed_dead_out;
  uint8_t* committed_left_out;
  int32_t* committed_inc_out;
  uint8_t* r_active_out;
  float* r_coverage_out;
};

__global__ void __launch_bounds__(kThreads)
expire_count_kernel(const __grid_constant__ ExpireArgs a) {
  __shared__ uint32_t s_col[64];
  __shared__ u64 red[1][32];
  __shared__ bool last;
  __shared__ uint32_t s_masks[2][5];  // per half: done, dead, left, alive, keep
  u64* sc = a.scratch;
  const int U = a.U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 64) s_col[threadIdx.x] = 0;
  __syncthreads();
  u64 live[1] = {0};
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
  block_sum<1>(live, red);  // its syncs also publish s_col
  if (threadIdx.x == 0 && red[0][0]) atomicAdd(&sc[kLive], red[0][0]);
  if (threadIdx.x < U && s_col[threadIdx.x]) {
    atomicAdd(&sc[kCols + threadIdx.x], static_cast<u64>(s_col[threadIdx.x]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sc[kDone], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // per slot (warps 0 and 1): coverage, done, the commit masks
  if (warp < 2) {
    const int u = threadIdx.x;
    bool done = false, keep = false;
    Commits c = {false, false, false};
    if (u < U) {
      const bool active = a.r_active[u];
      const int kind = a.r_kind[u];
      const float cov = live_coverage(__ldcg(&sc[kCols + u]), __ldcg(&sc[kLive]));
      const int32_t life = kind == kSuspect ? a.life_suspect : a.life_gossip;
      const int32_t age = wrap_sub(a.tick, a.r_start[u]);
      done = active && age >= life && (cov >= 0.995f || age >= wrap_mul(4, life));
      c = release_commits(done, cov, kind);
      keep = !done;
      a.r_active_out[u] = active && !done;
      a.r_coverage_out[u] = done ? 0.0f : cov;
      sc[kCols + u] = 0;
    }
    const uint32_t m_done = __ballot_sync(0xffffffffu, done);
    const uint32_t m_dead = __ballot_sync(0xffffffffu, c.dead);
    const uint32_t m_left = __ballot_sync(0xffffffffu, c.left);
    const uint32_t m_alive = __ballot_sync(0xffffffffu, c.alive);
    const uint32_t m_keep = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) {
      s_masks[warp][0] = m_done;
      s_masks[warp][1] = m_dead;
      s_masks[warp][2] = m_left;
      s_masks[warp][3] = m_alive;
      s_masks[warp][4] = m_keep;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    auto mask = [&](int w) -> u64 {
      return static_cast<u64>(s_masks[0][w]) | (static_cast<u64>(s_masks[1][w]) << 32);
    };
    sc[kKeep] = mask(4);
    sc[kCommitDead] = mask(1);
    sc[kCommitLeft] = mask(2);
    sc[kCommitAlive] = mask(3);
    sc[kLive] = 0;
    sc[kDone] = 0;  // ready for the next launch
  }
}

__global__ void __launch_bounds__(kThreads)
expire_apply_kernel(const __grid_constant__ ExpireArgs a) {
  __shared__ int32_t s_subj[64], s_inc[64];
  const u64* sc = a.scratch;
  const int U = a.U;
  const int64_t N = a.N;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_subj[u] = a.r_subject[u];
    s_inc[u] = a.r_inc[u];
  }
  __syncthreads();
  const uint64_t slots = all_slots(U);
  const uint64_t keep = sc[kKeep] & slots;
  const uint64_t c_dead = sc[kCommitDead], c_left = sc[kCommitLeft],
                 c_alive = sc[kCommitAlive];
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t rb = U;
  for (int64_t i0 = gwarp * 32; i0 < N; i0 += warps * 32) {
    const int64_t i = i0 + lane;
    if (i < N) {
      bool cd = a.committed_dead[i], cl = a.committed_left[i];
      int32_t ci = a.committed_inc[i];
      release_node(i, c_dead, c_left, c_alive, slots, s_subj, s_inc, cd, cl, ci);
      a.committed_dead_out[i] = cd;
      a.committed_left_out[i] = cl;
      a.committed_inc_out[i] = ci;
    }
    const int64_t rows = N - i0 < 32 ? N - i0 : 32;
    warp_copy_rows(a.know_out + i0 * rb, a.know + i0 * rb, rows * rb, U, keep, lane);
    warp_copy_rows(a.sends_out + i0 * rb, a.sends_left + i0 * rb, rows * rb, U, keep, lane);
  }
}

}  // namespace

extern "C" int refutation(const void* incarnation, const void* awareness, const void* up,
                          const void* member, const void* know, const void* learn_tick,
                          const void* sends_left, const void* r_active, const void* r_kind,
                          const void* r_subject, const void* r_inc, const void* r_start,
                          int64_t N, int U, int amax, int tick, int tick16, int limit,
                          void* incarnation_out, void* awareness_out, void* know_out,
                          void* learn_out, void* sends_out, void* r_kind_out,
                          void* r_inc_out, void* r_start_out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || amax < 0 || amax > 127 ||
      (amax > 0 && (!awareness || !awareness_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RefuteArgs a;
  a.incarnation = static_cast<const int32_t*>(incarnation);
  a.awareness = static_cast<const int8_t*>(awareness);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.know = static_cast<const uint8_t*>(know);
  a.learn_tick = static_cast<const int16_t*>(learn_tick);
  a.sends_left = static_cast<const int8_t*>(sends_left);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<const int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_start = static_cast<const int32_t*>(r_start);
  a.N = N;
  a.U = U;
  a.amax = amax;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.incarnation_out = static_cast<int32_t*>(incarnation_out);
  a.awareness_out = static_cast<int8_t*>(awareness_out);
  a.know_out = static_cast<uint8_t*>(know_out);
  a.learn_out = static_cast<int16_t*>(learn_out);
  a.sends_out = static_cast<int8_t*>(sends_out);
  a.r_kind_out = static_cast<int8_t*>(r_kind_out);
  a.r_inc_out = static_cast<int32_t*>(r_inc_out);
  a.r_start_out = static_cast<int32_t*>(r_start_out);
  static int per_card = 0;
  const int blocks = persistent_blocks(refutation_kernel, kThreads, N, 1 << 20, per_card);
  refutation_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// scratch: kCommitAlive + 1 u64, zeroed once (the count's last block resets
// what it consumed).
extern "C" int expire(const void* know, const void* sends_left, const void* up,
                      const void* member, const void* committed_dead,
                      const void* committed_left, const void* committed_inc,
                      const void* r_active, const void* r_kind, const void* r_subject,
                      const void* r_inc, const void* r_start, int64_t N, int U, int tick,
                      int life_gossip, int life_suspect, void* scratch, void* know_out,
                      void* sends_out, void* committed_dead_out, void* committed_left_out,
                      void* committed_inc_out, void* r_active_out, void* r_coverage_out,
                      void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExpireArgs a;
  a.know = static_cast<const uint8_t*>(know);
  a.sends_left = static_cast<const int8_t*>(sends_left);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_left = static_cast<const uint8_t*>(committed_left);
  a.committed_inc = static_cast<const int32_t*>(committed_inc);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<const int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_start = static_cast<const int32_t*>(r_start);
  a.N = N;
  a.U = U;
  a.tick = tick;
  a.life_gossip = life_gossip;
  a.life_suspect = life_suspect;
  a.scratch = static_cast<u64*>(scratch);
  a.know_out = static_cast<uint8_t*>(know_out);
  a.sends_out = static_cast<int8_t*>(sends_out);
  a.committed_dead_out = static_cast<uint8_t*>(committed_dead_out);
  a.committed_left_out = static_cast<uint8_t*>(committed_left_out);
  a.committed_inc_out = static_cast<int32_t*>(committed_inc_out);
  a.r_active_out = static_cast<uint8_t*>(r_active_out);
  a.r_coverage_out = static_cast<float*>(r_coverage_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int per_card[2] = {0, 0};
  const int b1 = persistent_blocks(expire_count_kernel, kThreads, N, 1 << 20, per_card[0]);
  expire_count_kernel<<<b1, kThreads, 0, s>>>(a);
  const int b2 = persistent_blocks(expire_apply_kernel, kThreads, N, 1 << 20, per_card[1]);
  expire_apply_kernel<<<b2, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
