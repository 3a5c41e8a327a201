// K11 dense_expiry: the dense per-subject suspicion timers expire into dead
// rumors, with overflow into the bulk death channel, every probe tick.
//
// Replaces: consul_tpu/models/swim.py _dense_suspicion_expiry apart from
// its _originate (K8), which XLA runs as some sixty [N] passes: the
// timers' refute / expired masks, the [U] gathers at the suspect slots'
// subjects, the conversion of those slots with their learn-tick and budget
// writes, the map updates (_maps_convert, _map_add), the wants at the ring
// peer (a push and a pull by the probe offset), the overflow into the bulk
// channel with its sums and float steps, and the timer clears.
//
// In place: the pre launch updates the state's learn_tick / sends_left
// rows and r_kind / r_start, the post launch its bulk_member, bulk_heard,
// bulk_cov, sus_start and sus_confirm, each only where a value changes.
// exp [U], want and row_subject [N] and the sums [3] are fresh outputs,
// handed to K8 and to the post launch.
//
// Two launches around K8's origination:
//   1. pre, a persistent grid over N.  Each block first computes exp_u[u]
//      for the <= 64 slots (a lane a slot): an active suspect slot whose
//      subject's dense timer expired (int32 tick - sus_start against the
//      int32 timeout table at sus_confirm, staged in shared memory), whose
//      subject has no dead rumor in dead_of (the maps after K10's
//      conversion) and is not committed dead.  Thread i then works for its
//      target j = (i + shift) % N, the bijection K7 uses, every load of
//      the row issued before any test: want[j] = expired[j] & no dead,
//      left or suspect rumor in the maps converted by exp_u (maps_convert's
//      min/max applied per node, masked entries into index 0 too) &
//      ~committed_dead[j] & ~bulk_member[j] & (up & member)[i], and
//      row_subject[i] = want[j] ? j : -1.  Where a slot converts, thread i
//      stamps the known cells of the exp_u columns of row i (t16(tick), the
//      budget), a 16-byte vector at a time and only the vectors whose bytes
//      change (common.cuh:row_write).  The grid's exact sums of bulk_member,
//      live rows and wants go to `counts` (common.cuh:grid_sum), and the
//      last block to finish writes exp, and r_kind = DEAD and r_start =
//      tick at the exp_u slots.  `shift` is read on the device;
//   2. post, a grid over N, after the origination.  Each block holds the
//      converted slots' subjects and K8's ok (subject, slot) pairs in
//      shared memory, and node j's dead rumor after both map updates is
//      the max over those whose subject is j (dead_after): the maps are
//      not written, since nothing reads them after this pass.
//      overflow[j] = want[j] > 0 & no dead rumor at j (off under the
//      nemesis build), bulk_member |= overflow, bulk_heard[i] =
//      min(min(bulk_heard[i], v_prev) + overflow[(i + shift) % N], v_new),
//      bulk_cov = 1 / max(n_live, 1) (IEEE division) where overflow (read
//      nowhere), and the timers cleared where done.  v_new = v_prev + the
//      overflow count, and the overflow count is the wants less the
//      origination's ok pairs: a want names a subject with no dead rumor,
//      and the pairs give exactly the ok subjects one (K8's subjects are
//      distinct and each ok one has want > 0).  So the sum needs no grid
//      reduction of its own.
// Why the writes in place are race-free.  Pre: every block reads the [U]
// table (r_active, r_kind, r_subject) at its start, before it counts
// itself done in grid_sum; the table is written only by the last block to
// count itself done, so after every read of it, and by one thread.
// Thread i reads and writes only row i of learn_tick / sends_left (and
// reads know row i); the [N] leaves it reads are not written by the
// launch.  Post: thread i writes only index i of the five leaves, and
// reads them only at i; at (i + shift) % N it reads want and dead_of,
// which the launch does not write, and the converted slots and pairs come
// from shared memory.  So neither launch needs an atomic on the state.
//
// Bound on an H100: memory.  The function must read the timers, up /
// member, the committed and bulk leaves the result depends on and the
// three maps once (26 bytes a node, 26 MB at N = 1M, ~0.008 ms at 3.35
// TB/s), know where a slot converts, and write in place the 32-byte
// sectors whose values change (the cleared timers, the overflow's bulk
// leaves, bulk_heard where it moves, the stamped cells); want and
// row_subject pass between the launches and are not part of it, nor is
// reading an input twice (chip_smoke.py:_detector_bytes counts it from the
// run's data).  It copies no row.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kSuspect = 1, kDead = 2;
constexpr int kTimeouts = 65;  // confirmations 0..64
constexpr int32_t kBig = 1 << 30;

struct DenseArgs {
  // the state's leaves (learn_tick, sends_left, r_kind and r_start
  // updated in place)
  const int32_t* sus_start;
  const int8_t* sus_confirm;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* committed_dead;
  const uint8_t* bulk_member;
  const int32_t* suspect_of;
  const int32_t* dead_of;
  const int32_t* left_of;
  const uint8_t* know;
  int16_t* learn_tick;
  int8_t* sends_left;
  const uint8_t* r_active;
  int8_t* r_kind;
  const int32_t* r_subject;
  int32_t* r_start;
  const int32_t* timeouts;  // [65] int32
  const int32_t* shift;     // one int32, on the device
  int64_t N;
  int U, tick, tick16, limit, period;
  u64* scratch;
  // fresh outputs
  uint8_t* exp_out;
  int32_t* want_out;
  int32_t* row_subject_out;
  int64_t* counts_out;  // bulk members, live rows, wants
};

__device__ __forceinline__ int64_t ring_shift(const int32_t* shift, int64_t N) {
  const int64_t d = static_cast<int64_t>(*shift) % N;
  return d < 0 ? d + N : d;
}

__device__ __forceinline__ int64_t ring(int64_t i, int64_t d, int64_t N) {
  const int64_t x = i + d;
  return x >= N ? x - N : x;
}

// A dense timer that runs past the probe period at a live member is
// refuted; one that runs past its Lifeguard timeout expires.
__device__ __forceinline__ bool timer_refuted(int32_t start, bool live, int tick, int period) {
  return start >= 0 && live && wrap_sub(tick, start) >= period;
}

__device__ __forceinline__ bool timer_expired(int32_t start, int8_t confirm, bool up,
                                              bool member, const int32_t* timeouts,
                                              int tick, int period) {
  if (start < 0 || !member || timer_refuted(start, up && member, tick, period)) return false;
  return wrap_sub(tick, start) >= timeouts[timeout_index(confirm)];
}

// At least six blocks an SM (at most 40 registers): the stamps' vectors
// must not cost the common tick, which converts no slot, its occupancy.
__global__ void __launch_bounds__(kThreads, 6)
dense_pre_kernel(const __grid_constant__ DenseArgs a) {
  __shared__ int32_t s_subj[64];
  __shared__ int32_t s_timeout[kTimeouts];
  __shared__ unsigned s_words[2];
  const int U = a.U;
  const int64_t N = a.N;
  for (int u = threadIdx.x; u < U; u += blockDim.x) s_subj[u] = a.r_subject[u];
  for (int t = threadIdx.x; t < kTimeouts; t += blockDim.x) s_timeout[t] = a.timeouts[t];
  if (threadIdx.x < 64) {  // warps 0 and 1, whole: a lane a slot
    const int u = threadIdx.x;
    bool e = false;
    if (u < U && a.r_active[u] && a.r_kind[u] == kSuspect) {
      const int32_t subj = a.r_subject[u];
      e = subj >= 0 && subj < N &&
          timer_expired(a.sus_start[subj], a.sus_confirm[subj], a.up[subj], a.member[subj],
                        a.timeouts, a.tick, a.period) &&
          a.dead_of[subj] < 0 && !a.committed_dead[subj];
    }
    const unsigned w = __ballot_sync(0xffffffffu, e);
    if ((u & 31) == 0) s_words[u >> 5] = w;
  }
  __syncthreads();
  const u64 exp = static_cast<u64>(s_words[0]) | (static_cast<u64>(s_words[1]) << 32);
  const bool masked = exp != all_slots(U);
  const int64_t d = ring_shift(a.shift, N);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  u64 v[3] = {0, 0, 0};  // bulk members, live rows, wants
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const int64_t j = ring(i, d, N);
    const bool live = (a.up[i] != 0) & (a.member[i] != 0);
    const bool bulk_i = a.bulk_member[i];
    const bool cd_j = a.committed_dead[j], bulk_j = a.bulk_member[j];
    const bool up_j = a.up[j], member_j = a.member[j];
    const int32_t left = a.left_of[j], start = a.sus_start[j];
    const int8_t confirm = a.sus_confirm[j];
    int32_t sus = a.suspect_of[j], dead = a.dead_of[j];
    bool want = false;
    if (live && !cd_j && !bulk_j && left < 0 &&
        timer_expired(start, confirm, up_j, member_j, s_timeout, a.tick, a.period)) {
      for (u64 m = exp; m; m &= m - 1) {
        const int u = __ffsll(m) - 1;
        if (s_subj[u] != j) continue;
        sus = sus < -1 ? sus : -1;
        dead = dead > u ? dead : u;
      }
      if (j == 0 && masked) {
        sus = sus < kBig ? sus : kBig;
        dead = dead > -1 ? dead : -1;
      }
      want = sus < 0 && dead < 0;
    }
    a.want_out[j] = want ? 1 : 0;
    a.row_subject_out[i] = want ? static_cast<int32_t>(j) : -1;
    v[0] += bulk_i;
    v[1] += live;
    v[2] += want;
    if (exp) {  // block-uniform: the known cells of the converted columns
      const uint64_t m = row_mask(a.know + i * U, U) & exp;
      row_write<int16_t>(a.learn_tick + i * U, U, m, m, static_cast<int16_t>(a.tick16));
      row_write<int8_t>(a.sends_left + i * U, U, m, m, static_cast<int8_t>(a.limit));
    }
  }
  u64 tot[3];
  if (grid_sum<3>(v, a.scratch, tot)) {  // thread 0 of the last block
    for (int k = 0; k < 3; ++k) a.counts_out[k] = static_cast<int64_t>(tot[k]);
    for (int u = 0; u < U; ++u) {
      const bool e = (exp >> u) & 1ull;
      a.exp_out[u] = e;
      if (e) {
        a.r_kind[u] = static_cast<int8_t>(kDead);
        a.r_start[u] = a.tick;
      }
    }
  }
}

struct PostArgs {
  const int32_t* want;
  const int32_t* dead_of;    // the dead map the pre launch read
  const int32_t* left_of;
  const uint8_t* exp;        // [U] the pre launch's converted slots
  const int32_t* r_subject;  // [U] their subjects, before the origination
  const int32_t* subjects;   // [A] the origination's pairs
  const int32_t* slots;
  const uint8_t* ok;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* committed_dead;
  const uint8_t* committed_left;
  const int64_t* counts;
  const int32_t* shift;
  int64_t N;
  int U, A, tick, period, chaos;
  // the state's leaves, updated in place
  uint8_t* bulk_member;
  float* bulk_heard;
  float* bulk_cov;
  int32_t* sus_start;
  int8_t* sus_confirm;
};

// The slots the pre launch converted and the origination's ok pairs, with
// whether any entry of either was masked (its scatter's -1 into index 0).
struct DeadUpdates {
  int32_t conv_subj[64];
  int32_t pair_subj[64], pair_slot[64];
  u64 conv;
  int pairs;
  bool conv_masked, pair_masked;
};

// dead_of[j] after maps_convert by the converted slots and map_add of the
// ok pairs: both scatter-max, so node j takes the max over the entries
// whose subject is j, as dense_pre_kernel applies the conversion.
__device__ __forceinline__ int32_t dead_after(const PostArgs& a, const DeadUpdates& d,
                                              int64_t j) {
  int32_t dead = a.dead_of[j];
  for (u64 m = d.conv; m; m &= m - 1) {
    const int u = __ffsll(m) - 1;
    if (d.conv_subj[u] == j && u > dead) dead = u;
  }
  for (int k = 0; k < d.pairs; ++k) {
    if (d.pair_subj[k] == j && d.pair_slot[k] > dead) dead = d.pair_slot[k];
  }
  if (j == 0 && (d.conv_masked || d.pair_masked) && dead < -1) dead = -1;
  return dead;
}

__device__ __forceinline__ bool overflow_at(const PostArgs& a, const DeadUpdates& d,
                                            int64_t j) {
  return !a.chaos && a.want[j] > 0 && dead_after(a, d, j) < 0;
}

__global__ void __launch_bounds__(kThreads)
dense_post_kernel(const __grid_constant__ PostArgs a) {
  __shared__ DeadUpdates d;
  if (threadIdx.x < 32) {
    const u64 m = warp_slot_mask(a.exp, a.U);
    if (threadIdx.x == 0) {
      d.conv = m;
      d.conv_masked = m != all_slots(a.U);
    }
  }
  for (int u = threadIdx.x; u < a.U; u += blockDim.x) d.conv_subj[u] = a.r_subject[u];
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < a.A; ++k) {
      if (a.ok[k]) {
        d.pair_subj[n] = a.subjects[k];
        d.pair_slot[n++] = a.slots[k];
      }
    }
    d.pairs = n;
    d.pair_masked = n < a.A;
  }
  __syncthreads();
  const u64 v_prev = static_cast<u64>(a.counts[0]);
  const u64 n_live = static_cast<u64>(a.counts[1]);
  const u64 wants = static_cast<u64>(a.counts[2]);
  const u64 v_new = v_prev + (a.chaos ? 0 : wants - static_cast<u64>(d.pairs));
  const float v_prev_f = __ull2float_rn(v_prev), v_new_f = __ull2float_rn(v_new);
  const float share = __fdiv_rn(1.0f, __ull2float_rn(n_live < 1 ? 1 : n_live));
  const int64_t N = a.N;
  const int64_t shift = ring_shift(a.shift, N);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const bool was = a.bulk_member[i];
    const float heard = a.bulk_heard[i];
    const int32_t start = a.sus_start[i];
    const int8_t confirm = a.sus_confirm[i];
    const bool member = a.member[i];
    const bool live = (a.up[i] != 0) & member;
    const bool committed = (a.committed_dead[i] != 0) | (a.committed_left[i] != 0);
    const bool left = a.left_of[i] >= 0;
    const int32_t dead = dead_after(a, d, i);
    const bool over = !a.chaos && a.want[i] > 0 && dead < 0;
    const bool bulk = was || over;
    const bool seeded = overflow_at(a, d, ring(i, shift, N));
    if (bulk && !was) a.bulk_member[i] = 1;
    const float h =
        fminf(__fadd_rn(fminf(heard, v_prev_f), seeded ? 1.0f : 0.0f), v_new_f);
    if (__float_as_uint(h) != __float_as_uint(heard)) a.bulk_heard[i] = h;
    if (over) a.bulk_cov[i] = share;
    const bool done = timer_refuted(start, live, a.tick, a.period) || committed ||
                      dead >= 0 || left || !member || bulk;
    if (done && start != -1) a.sus_start[i] = -1;
    if (done && confirm != 0) a.sus_confirm[i] = 0;
  }
}

}  // namespace

// scratch: 1 + 3 * scratch_blocks u64, zeroed once (grid_sum resets it).
extern "C" int dense_expiry(const void* sus_start, const void* sus_confirm, const void* up,
                            const void* member, const void* committed_dead,
                            const void* bulk_member, const void* suspect_of,
                            const void* dead_of, const void* left_of, const void* know,
                            void* learn_tick, void* sends_left, const void* r_active,
                            void* r_kind, const void* r_subject, void* r_start,
                            const void* timeouts, const void* shift, int64_t N, int U,
                            int tick, int tick16, int limit, int period, void* scratch,
                            int scratch_blocks, void* exp_out, void* want_out,
                            void* row_subject_out, void* counts_out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || scratch_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DenseArgs a;
  a.sus_start = static_cast<const int32_t*>(sus_start);
  a.sus_confirm = static_cast<const int8_t*>(sus_confirm);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.bulk_member = static_cast<const uint8_t*>(bulk_member);
  a.suspect_of = static_cast<const int32_t*>(suspect_of);
  a.dead_of = static_cast<const int32_t*>(dead_of);
  a.left_of = static_cast<const int32_t*>(left_of);
  a.know = static_cast<const uint8_t*>(know);
  a.learn_tick = static_cast<int16_t*>(learn_tick);
  a.sends_left = static_cast<int8_t*>(sends_left);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_start = static_cast<int32_t*>(r_start);
  a.timeouts = static_cast<const int32_t*>(timeouts);
  a.shift = static_cast<const int32_t*>(shift);
  a.N = N;
  a.U = U;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.period = period;
  a.scratch = static_cast<u64*>(scratch);
  a.exp_out = static_cast<uint8_t*>(exp_out);
  a.want_out = static_cast<int32_t*>(want_out);
  a.row_subject_out = static_cast<int32_t*>(row_subject_out);
  a.counts_out = static_cast<int64_t*>(counts_out);
  static PerCard per_card;
  const int blocks = persistent_blocks(dense_pre_kernel, kThreads, N, scratch_blocks, per_card);
  dense_pre_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_expiry_post(const void* want, const void* dead_of, const void* left_of,
                                 const void* exp, const void* r_subject,
                                 const void* subjects, const void* slots, const void* ok,
                                 const void* up, const void* member,
                                 const void* committed_dead, const void* committed_left,
                                 const void* counts, const void* shift, int64_t N, int U,
                                 int A, int tick, int period, int chaos, void* bulk_member,
                                 void* bulk_heard, void* bulk_cov, void* sus_start,
                                 void* sus_confirm, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || A < 1 || A > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PostArgs a;
  a.want = static_cast<const int32_t*>(want);
  a.dead_of = static_cast<const int32_t*>(dead_of);
  a.left_of = static_cast<const int32_t*>(left_of);
  a.exp = static_cast<const uint8_t*>(exp);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.subjects = static_cast<const int32_t*>(subjects);
  a.slots = static_cast<const int32_t*>(slots);
  a.ok = static_cast<const uint8_t*>(ok);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_left = static_cast<const uint8_t*>(committed_left);
  a.counts = static_cast<const int64_t*>(counts);
  a.shift = static_cast<const int32_t*>(shift);
  a.N = N;
  a.U = U;
  a.A = A;
  a.tick = tick;
  a.period = period;
  a.chaos = chaos;
  a.bulk_member = static_cast<uint8_t*>(bulk_member);
  a.bulk_heard = static_cast<float*>(bulk_heard);
  a.bulk_cov = static_cast<float*>(bulk_cov);
  a.sus_start = static_cast<int32_t*>(sus_start);
  a.sus_confirm = static_cast<int8_t*>(sus_confirm);
  const int64_t need = (N + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 2048 ? need : 2048);
  dense_post_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
