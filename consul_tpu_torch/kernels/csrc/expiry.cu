// K10 suspicion_expiry: holders whose suspicion timer expired convert the
// suspect slot into its dead rumor in place, every probe tick.
//
// Replaces: consul_tpu/models/swim.py _suspicion_expiry, which XLA runs as
// an [N, U] int16 age against the Lifeguard timeout of each slot, a [U, U]
// same-subject alive max (the slot's refuting alive rumor, if any), an
// [N, U] column gather of that alive slot, the committed-incarnation
// staleness test, an [N, U] -> [U] any, and three [N, U] selects that
// rewrite the converted columns.
//
// In place: the kernel updates the state's know / learn_tick / sends_left
// rows in the converted columns, only where a value changes, and r_kind /
// r_start at the converted slots; convert [U] is a fresh output.
//
// One cooperative launch (cudaLaunchCooperativeKernel on the co-resident
// grid of common.cuh:persistent_blocks), in three steps:
//   1. prelude, in every block: the [U] table into shared memory and, by a
//      lane a slot of warps 0-1, is_suspect, the same-subject alive max
//      av = max(r_inc * U + slot) with a_slot and refutable (a_inc >
//      r_inc), the staleness r_inc < committed_inc[r_subject], the
//      same-subject dead rumor, committed_dead[r_subject] and the int16
//      timeout of each slot (the int16 timeout table at r_confirm), as
//      slot words.  This is the only read of the table in the launch.
//   2. scan, a grid-stride walk over N, a warp taking 32 rows a step and
//      kBatches steps' up / member loaded together: a live row reads its
//      know row; where it knows a suspect slot it reads the learn ticks of
//      those cells only (2 bytes each) and sets expired[u] = age >=
//      timeout & ~refuted, refuted = refutable & know[i, a_slot] | stale;
//      the age is the int16 difference t16(tick) - learn_tick, which
//      wraps.  The warps or their rows' masks together (shuffles), the
//      blocks theirs into the scratch word; then one grid barrier.
//   3. decision and apply: every block reads the word and computes
//      convert = any_exp & ~dead_exists & ~committed_dead[r_subject] from
//      its own shared prelude, so no block reads the table from global
//      memory after the barrier; block 0 writes convert, and r_kind = DEAD
//      and r_start = tick at the converted slots.  When no slot converts
//      (nearly every probe tick) the launch ends there, with nothing read
//      over N after the scan.  Otherwise each thread recomputes its row's
//      expired bits of the converted columns from the same inputs and
//      writes, a 16-byte vector at a time and only the vectors whose
//      bytes change (common.cuh:row_write): know = expired, learn_tick =
//      t16(tick) where expired, sends_left = expired ? limit : 0.
// Why the writes in place are race-free: the table is read in step 1 and
// written in step 3, after the grid barrier, by block 0 alone; the
// decision reads only the scratch word and shared memory.  Thread i reads
// and writes only row i in step 3, and every row read in step 2 happens
// before the barrier.  The scratch word is reset by the last block to read
// it (a count of readers, each read fenced before its count), so the next
// launch finds it zero without a memset.
//
// Block form (a node-sharded pool, parallel/mesh.py), three launches in
// turn: scan, a launch a block over its rows [row0, row_end), whose last
// CUDA block writes the launch's expired-slot word into the block's slot
// of a [B] partial buffer; combine, one block on the mesh's first device:
// the prelude (the subjects' committed cells read through block tables),
// the or of the B words, the decision, convert_out, the converted slots'
// kind and start, and the convert word into the plan; apply, a launch a
// block, its rows' converted columns rewritten from the plan's word.  The
// one-device launch is mode 0, the cooperative kernel as before.
//
// Bound on an H100: memory.  The function must read know for the live rows
// (U bytes a row), up and member, the 32-byte learn_tick sector of each
// live row that knows a suspect slot and the table with its committed
// gathers, and write in place the 32-byte sectors of the converted columns
// whose values change: ~34 MB at N = 1M, U = 32 with no conversion (~0.010
// ms at 3.35 TB/s; chip_smoke.py:_detector_bytes counts it from the run's
// data).  It copies no row.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace consul_kernels;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatches = 4;  // 32-row steps whose loads a warp issues together
constexpr int kAlive = 0, kSuspect = 1, kDead = 2;
// scratch layout, in u64 words: the grid's expired slots, its readers
constexpr int kAny = 0, kRead = 1;
// launch modes: the one-device cooperative launch, the block form's
enum Mode { kOneDevice = 0, kScan = 1, kCombine = 2, kApply = 3 };

struct ExpiryArgs {
  // the state's leaves (know, learn_tick, sends_left, r_kind and r_start
  // updated in place)
  uint8_t* know;
  int16_t* learn_tick;
  int8_t* sends_left;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* committed_dead;
  const int32_t* committed_inc;
  const uint8_t* r_active;
  int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  int32_t* r_start;
  const int8_t* r_confirm;
  const int16_t* timeouts;  // [65]
  int64_t N;
  int U, tick, tick16, limit;
  u64* scratch;
  uint8_t* convert_out;  // fresh
  // the block form: mode, rows, the partial words (the launch's own for
  // scan, all B for combine), the plan word, the subjects' cells' tables
  int mode, B;
  int64_t row0, row_end;
  u64* part;
  u64* plan;
  MutRows<int32_t> t_cinc;
  MutRows<uint8_t> t_cdead;
};

// The [U] prelude, in shared memory (every thread calls it).
struct Prelude {
  u64 suspect, refutable, stale, dead_exists, committed;
  int8_t a_slot[64];
  int16_t timeout[64];
};

__device__ void prelude(const ExpiryArgs& a, Prelude& p) {
  __shared__ int32_t s_subj[64], s_inc[64];
  __shared__ int8_t s_kind[64];
  __shared__ bool s_active[64];
  __shared__ unsigned s_words[5][2];
  const int U = a.U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_subj[u] = a.r_subject[u];
    s_inc[u] = a.r_inc[u];
    s_kind[u] = a.r_kind[u];
    s_active[u] = a.r_active[u];
  }
  __syncthreads();
  if (threadIdx.x < 64) {  // warps 0 and 1, whole: a lane a slot
    const int u = threadIdx.x;
    bool suspect = false, refutable = false, stale = false, dead = false, cd = false;
    if (u < U) {
      const int32_t subj = s_subj[u], inc = s_inc[u];
      suspect = s_active[u] && s_kind[u] == kSuspect;
      int32_t av = -1;
      for (int v = 0; v < U; ++v) {
        if (s_subj[v] != subj || !s_active[v]) continue;
        if (s_kind[v] == kAlive) {
          const int32_t val = wrap_add(wrap_mul(s_inc[v], U), v);
          av = val > av ? val : av;
        }
        dead = dead || s_kind[v] == kDead;
      }
      p.a_slot[u] = static_cast<int8_t>(av >= 0 ? av % U : 0);
      refutable = av >= 0 && av / U > inc;
      if (subj >= 0 && subj < a.N) {
        stale = inc < a.t_cinc.at(subj);
        cd = a.t_cdead.at(subj);
      }
      p.timeout[u] = a.timeouts[timeout_index(a.r_confirm[u])];
    }
    const unsigned w0 = __ballot_sync(0xffffffffu, suspect);
    const unsigned w1 = __ballot_sync(0xffffffffu, refutable);
    const unsigned w2 = __ballot_sync(0xffffffffu, stale);
    const unsigned w3 = __ballot_sync(0xffffffffu, dead);
    const unsigned w4 = __ballot_sync(0xffffffffu, cd);
    if ((u & 31) == 0) {
      s_words[0][u >> 5] = w0;
      s_words[1][u >> 5] = w1;
      s_words[2][u >> 5] = w2;
      s_words[3][u >> 5] = w3;
      s_words[4][u >> 5] = w4;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    auto word = [&](int k) -> u64 {
      return static_cast<u64>(s_words[k][0]) | (static_cast<u64>(s_words[k][1]) << 32);
    };
    p.suspect = word(0);
    p.refutable = word(1);
    p.stale = word(2);
    p.dead_exists = word(3);
    p.committed = word(4);
  }
  __syncthreads();
}

// The slots of `cand` (known suspect slots) whose timer expired,
// unrefuted, at live row i with know mask m.
__device__ __forceinline__ uint64_t expired_bits(const ExpiryArgs& a, const Prelude& p,
                                                 int64_t i, uint64_t m, uint64_t cand) {
  uint64_t exp = 0;
  for (; cand; cand &= cand - 1) {
    const int u = __ffsll(cand) - 1;
    const int16_t age = static_cast<int16_t>(a.tick16 - a.learn_tick[i * a.U + u]);
    if (age < p.timeout[u]) continue;
    const bool refuted = (((p.refutable >> u) & 1ull) && ((m >> p.a_slot[u]) & 1ull)) ||
                         ((p.stale >> u) & 1ull);
    if (!refuted) exp |= 1ull << u;
  }
  return exp;
}

// kCombineLaunch: the block form's combine, an instantiation of its own (so a
// profile tells it from the blocks' launches)
template <bool kCombineLaunch>
__global__ void __launch_bounds__(kThreads)
expiry_kernel(const __grid_constant__ ExpiryArgs a) {
  __shared__ Prelude p;
  __shared__ u64 s_any, s_convert;
  const int U = a.U;
  const int64_t N = a.row_end;  // the launch's rows end (N for one device)
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_any = 0;
  prelude(a, p);
  if (kCombineLaunch) {
    if (threadIdx.x == 0) {
      u64 any = 0;
      for (int b = 0; b < a.B; ++b) any |= a.part[b];
      s_convert = any & ~p.dead_exists & ~p.committed;
      a.plan[0] = s_convert;
    }
    __syncthreads();
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const bool c = (s_convert >> u) & 1ull;
      a.convert_out[u] = c;
      if (c) {
        a.r_kind[u] = static_cast<int8_t>(kDead);
        a.r_start[u] = a.tick;
      }
    }
    return;
  }
  if (a.mode == kApply) {
    const uint64_t convert = __ldcg(a.plan);
    if (!convert) return;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = a.row0 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < N; i += stride) {
      const uint64_t m = row_mask(a.know + i * U, U);
      const bool live = (a.up[i] != 0) & (a.member[i] != 0);
      const uint64_t e = live ? expired_bits(a, p, i, m, m & convert) : 0;
      row_write<uint8_t>(a.know + i * U, U, m & convert, e, 1);
      row_write<int8_t>(a.sends_left + i * U, U, convert, e, static_cast<int8_t>(a.limit));
      row_write<int16_t>(a.learn_tick + i * U, U, e, e, static_cast<int16_t>(a.tick16));
    }
    return;
  }

  // 2. scan
  uint64_t any = 0;
  if (p.suspect) {  // block-uniform
    const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
    const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    for (int64_t i0 = a.row0 + gwarp * 32; i0 < N; i0 += warps * 32 * kBatches) {
      bool live[kBatches];
#pragma unroll
      for (int r = 0; r < kBatches; ++r) {
        const int64_t i = i0 + r * warps * 32 + lane;
        live[r] = i < N && ((a.up[i] != 0) & (a.member[i] != 0));
      }
      uint64_t m[kBatches];
#pragma unroll
      for (int r = 0; r < kBatches; ++r) {
        m[r] = live[r] ? row_mask(a.know + (i0 + r * warps * 32 + lane) * U, U) : 0;
      }
#pragma unroll
      for (int r = 0; r < kBatches; ++r) {
        const uint64_t cand = m[r] & p.suspect;
        if (cand) any |= expired_bits(a, p, i0 + r * warps * 32 + lane, m[r], cand);
      }
    }
  }
  any = warp_or(any);
  if (lane == 0 && any) atomicOr(&s_any, static_cast<u64>(any));
  __syncthreads();
  if (threadIdx.x == 0 && s_any) atomicOr(&a.scratch[kAny], s_any);
  __threadfence();
  if (a.mode == kScan) {
    // the launch's word into its slot, by its last block
    if (threadIdx.x == 0 &&
        atomicAdd(&a.scratch[kRead], 1ull) == static_cast<u64>(gridDim.x) - 1) {
      __threadfence();
      *a.part = __ldcg(&a.scratch[kAny]);
      a.scratch[kAny] = 0;
      a.scratch[kRead] = 0;
    }
    return;
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // 3. decision, from the scratch word and this block's prelude
  if (threadIdx.x == 0) {
    s_convert = __ldcg(&a.scratch[kAny]) & ~p.dead_exists & ~p.committed;
    __threadfence();  // the read before the count that lets it be reset
    if (atomicAdd(&a.scratch[kRead], 1ull) == static_cast<u64>(gridDim.x) - 1) {
      a.scratch[kAny] = 0;
      a.scratch[kRead] = 0;  // ready for the next launch
    }
  }
  __syncthreads();
  const uint64_t convert = s_convert;  // grid-uniform
  if (blockIdx.x == 0) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const bool c = (convert >> u) & 1ull;
      a.convert_out[u] = c;
      if (c) {
        a.r_kind[u] = static_cast<int8_t>(kDead);
        a.r_start[u] = a.tick;
      }
    }
  }
  if (!convert) return;

  // apply: thread i rewrites the converted columns of row i
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = a.row0 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < N; i += stride) {
    const uint64_t m = row_mask(a.know + i * U, U);
    const bool live = (a.up[i] != 0) & (a.member[i] != 0);
    const uint64_t e = live ? expired_bits(a, p, i, m, m & convert) : 0;
    // know = e, sends_left = e ? limit : 0 in the converted columns (only
    // a known cell's know can change), learn_tick = t16(tick) where e
    row_write<uint8_t>(a.know + i * U, U, m & convert, e, 1);
    row_write<int8_t>(a.sends_left + i * U, U, convert, e, static_cast<int8_t>(a.limit));
    row_write<int16_t>(a.learn_tick + i * U, U, e, e, static_cast<int16_t>(a.tick16));
  }
}

}  // namespace

// scratch: 2 u64, zeroed once (the launch's last reader resets them).
// mode: 0 the one-device cooperative launch (row0 = 0, rows = N, B = 1
// tables of committed_dead and committed_inc); the block form's scan
// (part: the block's word) and apply (plan: the convert word) over global
// rows [row0, row0 + rows), know ... member local to the block, and its
// combine (part: the B words; one block).  tables: committed_inc then
// committed_dead, B base pointers each, L rows a block.
extern "C" int suspicion_expiry(void* know, void* learn_tick, void* sends_left,
                                const void* up, const void* member,
                                const void* committed_dead, const void* committed_inc,
                                const void* r_active, void* r_kind, const void* r_subject,
                                const void* r_inc, void* r_start, const void* r_confirm,
                                const void* timeouts, int64_t N, int U, int tick,
                                int tick16, int limit, void* scratch, void* convert_out,
                                int mode, int64_t row0, int64_t rows, const void* tables,
                                int B, int64_t L, void* part, void* plan, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || mode < kOneDevice ||
      mode > kApply || row0 < 0 || rows < 1 || row0 + rows > N || B < 1 ||
      B > kMaxBlocks || !tables || (mode == kScan && !part) ||
      (mode == kCombine && (!part || !plan)) || (mode == kApply && !plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExpiryArgs a;
  a.know = shifted<uint8_t>(know, row0, U);
  a.learn_tick = shifted<int16_t>(learn_tick, row0, U);
  a.sends_left = shifted<int8_t>(sends_left, row0, U);
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_inc = static_cast<const int32_t*>(committed_inc);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_start = static_cast<int32_t*>(r_start);
  a.r_confirm = static_cast<const int8_t*>(r_confirm);
  a.timeouts = static_cast<const int16_t*>(timeouts);
  a.N = N;
  a.U = U;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.scratch = static_cast<u64*>(scratch);
  a.convert_out = static_cast<uint8_t*>(convert_out);
  a.mode = mode;
  a.B = B;
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.part = static_cast<u64*>(part);
  a.plan = static_cast<u64*>(plan);
  a.t_cinc = mut_rows<int32_t>(tables, 0, B, L);
  a.t_cdead = mut_rows<uint8_t>(tables, 1, B, L);
  static PerCard per_card;
  const int blocks =
      persistent_blocks(expiry_kernel<false>, kThreads, rows, 1 << 20, per_card);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCombine) {
    expiry_kernel<true><<<1, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != kOneDevice) {
    expiry_kernel<false><<<blocks, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(expiry_kernel<false>), dim3(blocks), dim3(kThreads),
      args, 0, s));
}
