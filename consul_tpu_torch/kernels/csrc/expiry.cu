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
// Two launches behind one entry point, each block first computing the [U]
// prelude from the table in shared memory: is_suspect, the same-subject
// alive max av = max(r_inc * U + slot) with a_slot, a_inc and refutable,
// the per-column staleness r_inc < committed_inc[r_subject], dead_exists,
// the int16 timeout of each slot (the int16 timeout table at r_confirm):
//   1. scan, a persistent grid over N: a live row that knows a suspect
//      slot reads the learn ticks of those slots only (2 bytes each) and
//      sets expired[u] = age >= timeout & ~refuted, refuted = refutable &
//      know[i, a_slot] | stale; the age is the int16 difference t16(tick)
//      - learn_tick, which wraps.  The warps or their rows' masks together
//      (shuffles), blocks or theirs into the scratch, and the last block
//      to finish writes convert = any_exp & ~dead_exists &
//      ~committed_dead[r_subject], the [U] kind and start, and the convert
//      word for launch 2;
//   2. apply, a persistent grid over N: each warp copies its 32 rows of
//      know / learn_tick / sends_left into the fresh outputs, then, where a
//      slot converted, each thread recomputes its row's expired bits of
//      the converted columns from the same inputs (no per-row state is
//      kept between the launches) and rewrites them: know = expired,
//      learn_tick = t16(tick) where expired, sends_left = expired ? limit :
//      0.
//
// Bound on an H100: memory.  The function must read know (U bytes a row),
// up and member, and the 32-byte learn_tick sector of each known suspect
// cell, and write in place the 32-byte sectors of the converted columns
// whose values change (~34 MB at N = 1M, U = 32 with no suspicion: ~0.010
// ms at 3.35 TB/s).  The fresh-output row copy (4U bytes
// read and written a row, 128 MB each way at U = 32, ~0.076 ms) is the
// price of never writing a tensor it was given.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAlive = 0, kSuspect = 1, kDead = 2;
// scratch layout, in u64 words
constexpr int kDone = 0, kAny = 1, kConvert = 2;

struct ExpiryArgs {
  const uint8_t* know;
  const int16_t* learn_tick;
  const int8_t* sends_left;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* committed_dead;
  const int32_t* committed_inc;
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  const int32_t* r_start;
  const int8_t* r_confirm;
  const int16_t* timeouts;  // [65]
  int64_t N;
  int U, tick, tick16, limit;
  u64* scratch;
  uint8_t* know_out;
  int16_t* learn_out;
  int8_t* sends_out;
  int8_t* r_kind_out;
  int32_t* r_start_out;
  uint8_t* convert_out;
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
        stale = inc < a.committed_inc[subj];
        cd = a.committed_dead[subj];
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

// The slots of `cand` whose timer expired, unrefuted, at live row i with
// know mask m.
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

__global__ void __launch_bounds__(kThreads)
expiry_scan_kernel(const __grid_constant__ ExpiryArgs a) {
  __shared__ Prelude p;
  __shared__ u64 s_any;
  __shared__ bool last;
  if (threadIdx.x == 0) s_any = 0;
  prelude(a, p);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  uint64_t any = 0;
  if (p.suspect) {
    for (int64_t i0 = gwarp * 32; i0 < a.N; i0 += warps * 32) {
      const int64_t i = i0 + lane;
      if (i < a.N && a.up[i] && a.member[i]) {
        const uint64_t m = row_mask(a.know + i * a.U, a.U);
        const uint64_t cand = m & p.suspect;
        if (cand) any |= expired_bits(a, p, i, m, cand);
      }
    }
  }
  any = warp_or(any);
  if (lane == 0 && any) atomicOr(&s_any, static_cast<u64>(any));
  __syncthreads();
  if (threadIdx.x == 0 && s_any) atomicOr(&a.scratch[kAny], s_any);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&a.scratch[kDone], 1ull) == static_cast<u64>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const uint64_t any_exp = __ldcg(&a.scratch[kAny]);
  const uint64_t convert = any_exp & ~p.dead_exists & ~p.committed;
  for (int u = threadIdx.x; u < a.U; u += blockDim.x) {
    const bool c = (convert >> u) & 1ull;
    a.r_kind_out[u] = c ? static_cast<int8_t>(kDead) : a.r_kind[u];
    a.r_start_out[u] = c ? a.tick : a.r_start[u];
    a.convert_out[u] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.scratch[kConvert] = convert;
    a.scratch[kAny] = 0;
    a.scratch[kDone] = 0;  // ready for the next launch
  }
}

__global__ void __launch_bounds__(kThreads)
expiry_apply_kernel(const __grid_constant__ ExpiryArgs a) {
  __shared__ Prelude p;
  prelude(a, p);
  const uint64_t convert = a.scratch[kConvert];  // block-uniform
  const int U = a.U;
  const int64_t N = a.N;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gwarp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t rb = U;
  for (int64_t i0 = gwarp * 32; i0 < N; i0 += warps * 32) {
    const int64_t rows = N - i0 < 32 ? N - i0 : 32;
    warp_copy(a.know_out + i0 * rb, a.know + i0 * rb, rows * rb, lane);
    warp_copy(a.learn_out + i0 * rb, a.learn_tick + i0 * rb, rows * 2 * rb, lane);
    warp_copy(a.sends_out + i0 * rb, a.sends_left + i0 * rb, rows * rb, lane);
    __syncwarp();
    const int64_t i = i0 + lane;
    if (convert && i < N) {
      uint64_t exp = 0;
      if (a.up[i] && a.member[i]) {
        const uint64_t m = row_mask(a.know + i * rb, U);
        exp = expired_bits(a, p, i, m, m & convert);
      }
      for (uint64_t c = convert; c; c &= c - 1) {
        const int u = __ffsll(c) - 1;
        const bool e = (exp >> u) & 1ull;
        a.know_out[i * rb + u] = e;
        a.sends_out[i * rb + u] = e ? static_cast<int8_t>(a.limit) : 0;
        if (e) a.learn_out[i * rb + u] = static_cast<int16_t>(a.tick16);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// scratch: 3 u64, zeroed once (the scan's last block resets what it used).
extern "C" int suspicion_expiry(const void* know, const void* learn_tick,
                                const void* sends_left, const void* up, const void* member,
                                const void* committed_dead, const void* committed_inc,
                                const void* r_active, const void* r_kind,
                                const void* r_subject, const void* r_inc,
                                const void* r_start, const void* r_confirm,
                                const void* timeouts, int64_t N, int U, int tick,
                                int tick16, int limit, void* scratch, void* know_out,
                                void* learn_out, void* sends_out, void* r_kind_out,
                                void* r_start_out, void* convert_out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExpiryArgs a;
  a.know = static_cast<const uint8_t*>(know);
  a.learn_tick = static_cast<const int16_t*>(learn_tick);
  a.sends_left = static_cast<const int8_t*>(sends_left);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_inc = static_cast<const int32_t*>(committed_inc);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<const int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_start = static_cast<const int32_t*>(r_start);
  a.r_confirm = static_cast<const int8_t*>(r_confirm);
  a.timeouts = static_cast<const int16_t*>(timeouts);
  a.N = N;
  a.U = U;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.scratch = static_cast<u64*>(scratch);
  a.know_out = static_cast<uint8_t*>(know_out);
  a.learn_out = static_cast<int16_t*>(learn_out);
  a.sends_out = static_cast<int8_t*>(sends_out);
  a.r_kind_out = static_cast<int8_t*>(r_kind_out);
  a.r_start_out = static_cast<int32_t*>(r_start_out);
  a.convert_out = static_cast<uint8_t*>(convert_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int per_card[2] = {0, 0};
  const int b1 = persistent_blocks(expiry_scan_kernel, kThreads, N, 1 << 20, per_card[0]);
  expiry_scan_kernel<<<b1, kThreads, 0, s>>>(a);
  const int b2 = persistent_blocks(expiry_apply_kernel, kThreads, N, 1 << 20, per_card[1]);
  expiry_apply_kernel<<<b2, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
