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
// Block form (a node-sharded pool, parallel/mesh.py): pre runs a launch
// a block over its rows [row0, row_end), reading every leaf at a target
// j and at a slot's subject through block tables and writing want[j]
// through a writable one; its last CUDA block writes the launch's three
// sums into the block's slot of a [B, 3] partial buffer, and
// dense_combine (one block, the mesh's first device) adds them in block
// order into `counts`, then writes exp and the converted slots' kind and
// start.  post runs a launch a block, want and dead_of at the ring peer
// read through tables.  The one-device launches are the kOne
// instantiations, the same code as before the block form.
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
constexpr int kSums = 3;  // bulk members, live rows, wants
// pre's modes: the one-device launch, a block of the block form, its
// combine
enum Mode { kOneDevice = 0, kBlock = 1, kCombine = 2 };
// pre's block tables, in the host's order
enum Table { kUp, kMember, kCDead, kBulk, kLeftOf, kSusStart, kSusConfirm, kSuspectOf,
             kDeadOf, kWant, kTables };

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
  // the block form: mode, B, rows, the partial sums (the launch's slot,
  // or all B for the combine), the tables
  int mode, B;
  int64_t row0, row_end;
  u64* part;
  MutRows<uint8_t> t_up, t_member, t_cdead, t_bulk;
  MutRows<int32_t> t_left_of, t_sus_start, t_suspect_of, t_dead_of, t_want;
  MutRows<int8_t> t_sus_confirm;
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

// The slots whose dense timer expired at their subject (exp_u), a lane a
// slot of warps 0 and 1, the subjects' cells read through the tables.
__device__ u64 expiring_slots(const DenseArgs& a, unsigned (&s_words)[2]) {
  if (threadIdx.x < 64) {  // warps 0 and 1, whole: a lane a slot
    const int u = threadIdx.x;
    bool e = false;
    if (u < a.U && a.r_active[u] && a.r_kind[u] == kSuspect) {
      const int32_t subj = a.r_subject[u];
      e = subj >= 0 && subj < a.N &&
          timer_expired(a.t_sus_start.at(subj), a.t_sus_confirm.at(subj), a.t_up.at(subj),
                        a.t_member.at(subj), a.timeouts, a.tick, a.period) &&
          a.t_dead_of.at(subj) < 0 && !a.t_cdead.at(subj);
    }
    const unsigned w = __ballot_sync(0xffffffffu, e);
    if ((u & 31) == 0) s_words[u >> 5] = w;
  }
  __syncthreads();
  return static_cast<u64>(s_words[0]) | (static_cast<u64>(s_words[1]) << 32);
}

// The last step of pre: the sums, exp and the converted slots (one thread).
__device__ void pre_finish(const DenseArgs& a, u64 exp, const u64 (&tot)[kSums]) {
  for (int k = 0; k < kSums; ++k) a.counts_out[k] = static_cast<int64_t>(tot[k]);
  for (int u = 0; u < a.U; ++u) {
    const bool e = (exp >> u) & 1ull;
    a.exp_out[u] = e;
    if (e) {
      a.r_kind[u] = static_cast<int8_t>(kDead);
      a.r_start[u] = a.tick;
    }
  }
}

// The block form's combine, one block: the B launches' sums added in
// block order, then pre_finish.
__global__ void __launch_bounds__(kThreads)
dense_combine_kernel(const __grid_constant__ DenseArgs a) {
  __shared__ unsigned s_words[2];
  const u64 exp = expiring_slots(a, s_words);
  if (threadIdx.x != 0) return;
  u64 tot[kSums] = {0, 0, 0};
  for (int b = 0; b < a.B; ++b) {
    for (int k = 0; k < kSums; ++k) tot[k] += a.part[b * kSums + k];
  }
  pre_finish(a, exp, tot);
}

// At least six blocks an SM (at most 40 registers): the stamps' vectors
// must not cost the common tick, which converts no slot, its occupancy.
template <bool kOne>
__global__ void __launch_bounds__(kThreads, 6)
dense_pre_kernel(const __grid_constant__ DenseArgs a) {
  __shared__ int32_t s_subj[64];
  __shared__ int32_t s_timeout[kTimeouts];
  __shared__ unsigned s_words[2];
  const int U = a.U;
  const int64_t N = a.N;
  for (int u = threadIdx.x; u < U; u += blockDim.x) s_subj[u] = a.r_subject[u];
  for (int t = threadIdx.x; t < kTimeouts; t += blockDim.x) s_timeout[t] = a.timeouts[t];
  const u64 exp = expiring_slots(a, s_words);
  const bool masked = exp != all_slots(U);
  const int64_t d = ring_shift(a.shift, N);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  u64 v[3] = {0, 0, 0};  // bulk members, live rows, wants
  for (int64_t i = a.row0 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.row_end; i += stride) {
    const int64_t j = ring(i, d, N);
    const bool live = (a.up[i] != 0) & (a.member[i] != 0);
    const bool bulk_i = a.bulk_member[i];
    const bool cd_j = a.t_cdead.at<kOne>(j), bulk_j = a.t_bulk.at<kOne>(j);
    const bool up_j = a.t_up.at<kOne>(j), member_j = a.t_member.at<kOne>(j);
    const int32_t left = a.t_left_of.at<kOne>(j), start = a.t_sus_start.at<kOne>(j);
    const int8_t confirm = a.t_sus_confirm.at<kOne>(j);
    int32_t sus = a.t_suspect_of.at<kOne>(j), dead = a.t_dead_of.at<kOne>(j);
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
    *a.t_want.row<kOne>(j) = want ? 1 : 0;
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
  u64 tot[kSums];
  if (grid_sum<3>(v, a.scratch, tot)) {  // thread 0 of the last block
    if (a.mode == kBlock) {
      for (int k = 0; k < kSums; ++k) a.part[k] = tot[k];
    } else {
      pre_finish(a, exp, tot);
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
  int64_t row0, row_end;
  MutRows<int32_t> t_want, t_dead_of;  // read at the ring peer
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
// whose subject is j, as dense_pre_kernel applies the conversion.  `dead`
// is the map's value at j.
__device__ __forceinline__ int32_t dead_after(const DeadUpdates& d, int64_t j, int32_t dead) {
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

template <bool kOne>
__device__ __forceinline__ bool overflow_at(const PostArgs& a, const DeadUpdates& d,
                                            int64_t j) {
  return !a.chaos && a.t_want.at<kOne>(j) > 0 && dead_after(d, j, a.t_dead_of.at<kOne>(j)) < 0;
}

template <bool kOne>
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
  for (int64_t i = a.row0 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.row_end; i += stride) {
    const bool was = a.bulk_member[i];
    const float heard = a.bulk_heard[i];
    const int32_t start = a.sus_start[i];
    const int8_t confirm = a.sus_confirm[i];
    const bool member = a.member[i];
    const bool live = (a.up[i] != 0) & member;
    const bool committed = (a.committed_dead[i] != 0) | (a.committed_left[i] != 0);
    const bool left = a.left_of[i] >= 0;
    const int32_t dead = dead_after(d, i, a.dead_of[i]);
    const bool over = !a.chaos && a.want[i] > 0 && dead < 0;
    const bool bulk = was || over;
    const bool seeded = overflow_at<kOne>(a, d, ring(i, shift, N));
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
                            void* row_subject_out, void* counts_out, int mode,
                            int64_t row0, int64_t rows, const void* tables, int B,
                            int64_t L, void* part, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || scratch_blocks < 1 ||
      mode < kOneDevice || mode > kCombine || row0 < 0 || rows < 1 || row0 + rows > N ||
      B < 1 || B > kMaxBlocks || !tables || (mode != kOneDevice && !part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DenseArgs a;
  a.sus_start = shifted<const int32_t>(const_cast<void*>(sus_start), row0);
  a.sus_confirm = shifted<const int8_t>(const_cast<void*>(sus_confirm), row0);
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.committed_dead = shifted<const uint8_t>(const_cast<void*>(committed_dead), row0);
  a.bulk_member = shifted<const uint8_t>(const_cast<void*>(bulk_member), row0);
  a.suspect_of = shifted<const int32_t>(const_cast<void*>(suspect_of), row0);
  a.dead_of = shifted<const int32_t>(const_cast<void*>(dead_of), row0);
  a.left_of = shifted<const int32_t>(const_cast<void*>(left_of), row0);
  a.know = shifted<const uint8_t>(const_cast<void*>(know), row0, U);
  a.learn_tick = shifted<int16_t>(learn_tick, row0, U);
  a.sends_left = shifted<int8_t>(sends_left, row0, U);
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
  a.want_out = shifted<int32_t>(want_out, row0);
  a.row_subject_out = shifted<int32_t>(row_subject_out, row0);
  a.counts_out = static_cast<int64_t*>(counts_out);
  a.mode = mode;
  a.B = B;
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.part = static_cast<u64*>(part);
  a.t_up = mut_rows<uint8_t>(tables, kUp, B, L);
  a.t_member = mut_rows<uint8_t>(tables, kMember, B, L);
  a.t_cdead = mut_rows<uint8_t>(tables, kCDead, B, L);
  a.t_bulk = mut_rows<uint8_t>(tables, kBulk, B, L);
  a.t_left_of = mut_rows<int32_t>(tables, kLeftOf, B, L);
  a.t_sus_start = mut_rows<int32_t>(tables, kSusStart, B, L);
  a.t_sus_confirm = mut_rows<int8_t>(tables, kSusConfirm, B, L);
  a.t_suspect_of = mut_rows<int32_t>(tables, kSuspectOf, B, L);
  a.t_dead_of = mut_rows<int32_t>(tables, kDeadOf, B, L);
  a.t_want = mut_rows<int32_t>(tables, kWant, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCombine) {
    dense_combine_kernel<<<1, kThreads, 0, s>>>(a);
  } else if (mode == kOneDevice) {
    static PerCard per_card;
    const int blocks = persistent_blocks(dense_pre_kernel<true>, kThreads, rows,
                                         scratch_blocks, per_card);
    dense_pre_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    static PerCard per_card;
    const int blocks = persistent_blocks(dense_pre_kernel<false>, kThreads, rows,
                                         scratch_blocks, per_card);
    dense_pre_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  }
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
                                 void* sus_confirm, int64_t row0, int64_t rows,
                                 const void* tables, int B, int64_t L, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || A < 1 || A > 64 ||
      row0 < 0 || rows < 1 || row0 + rows > N || B < 1 || B > kMaxBlocks || !tables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PostArgs a;
  a.want = shifted<const int32_t>(const_cast<void*>(want), row0);
  a.dead_of = shifted<const int32_t>(const_cast<void*>(dead_of), row0);
  a.left_of = shifted<const int32_t>(const_cast<void*>(left_of), row0);
  a.exp = static_cast<const uint8_t*>(exp);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.subjects = static_cast<const int32_t*>(subjects);
  a.slots = static_cast<const int32_t*>(slots);
  a.ok = static_cast<const uint8_t*>(ok);
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.committed_dead = shifted<const uint8_t>(const_cast<void*>(committed_dead), row0);
  a.committed_left = shifted<const uint8_t>(const_cast<void*>(committed_left), row0);
  a.counts = static_cast<const int64_t*>(counts);
  a.shift = static_cast<const int32_t*>(shift);
  a.N = N;
  a.U = U;
  a.A = A;
  a.tick = tick;
  a.period = period;
  a.chaos = chaos;
  a.bulk_member = shifted<uint8_t>(bulk_member, row0);
  a.bulk_heard = shifted<float>(bulk_heard, row0);
  a.bulk_cov = shifted<float>(bulk_cov, row0);
  a.sus_start = shifted<int32_t>(sus_start, row0);
  a.sus_confirm = shifted<int8_t>(sus_confirm, row0);
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.t_want = mut_rows<int32_t>(tables, 0, B, L);
  a.t_dead_of = mut_rows<int32_t>(tables, 1, B, L);
  const int64_t need = (rows + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 2048 ? need : 2048);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1) {
    dense_post_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    dense_post_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
