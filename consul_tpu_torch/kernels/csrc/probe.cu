// K7 probe_round: one SWIM probe round of the whole pool, every probe
// tick of the main path, the oracle, the nemesis, the mass-event path and
// each federation pool.
//
// Replaces: consul_tpu/models/swim.py _probe_round (with
// _believes_down_shift), which XLA runs as some hundred [N] and [N, U]
// passes: the ring views at the probe offset d and the k relay offsets,
// the "does the prober already believe its target down" mask (dead/left
// knowledge, an expired unrefuted suspicion against the Lifeguard
// timeout), the Lifeguard local-health gate, the direct and indirect
// legs, the awareness update, the joiner cells, the dense per-subject
// suspicion timers, the [U] confirmation update, the counters and the
// wants handed to _originate.
//
// In place: the kernel updates the state's know / learn_tick /
// sends_left rows, awareness, the dense timers (sus_start, sus_confirm,
// sus_count), r_confirm and the counter vector where their values change;
// want, row_subject, the RTT and the direct-ack mask are fresh outputs.
//
// One launch, a persistent grid of threads, each taking probers i in a
// grid-stride loop:
//   * thread i probes j = (i + d) % N; i -> j is a bijection, so thread i
//     writes every per-subject output at j (the timers, `want`) with no
//     atomics, and its reads at j are shifted but coalesced;
//   * the rumor table's suspect slots, subjects, incarnations and
//     confirmations, the int16 timeout table and the ring offsets (taken
//     mod N once) are staged in shared memory by every block at its start;
//   * a failed prober that knows nothing of an existing suspicion about
//     its target joins it: thread i writes that one cell of its own row;
//   * a failed prober whose target is the subject of an active suspect
//     slot marks the slot in the scratch (one thread owns each subject);
//     each block writes its four counters (probed, acked, failed, newly
//     suspected) into its own partial slot, and the last block to finish
//     adds them to the counter vector as exact integers cast to float32
//     once, applies the [U] confirmation update and clears the marks.
// Why writing in place is race-free: thread i reads and writes only row i
// of know / learn_tick / sends_left and only awareness[i]; it reads and
// writes the [N] timers only at j, and i -> j is a bijection; r_confirm
// and the counters are written by the last block, after every block has
// counted itself done, and every block staged r_confirm into shared
// memory before that (the counters are read by the last block alone).
// Float steps are explicitly rounded (__fmul_rn, __fadd_rn, __fsqrt_rn)
// so no FMA contraction changes a bit; constants arrive as float32 from
// the host, rounded as torch rounds a Python scalar.  The suspicion age
// here is the int32 difference t16(tick) - learn (JAX's _row_gather sums
// the int16 cell with jnp.sum, which promotes): no int16 wrap.
//
// Block form (a node-sharded pool, parallel/mesh.py): a launch a block
// over its rows [row0, row_end), its own leaves at shifted pointers, every
// read at the target j or a relay r through a block table (up, member,
// the committed, bulk, map, coordinate and chaos leaves) and the target's
// timers and want written through writable tables (MutRows): i -> j
// stays a bijection over the pool, so no two launches write one cell.
// The last block of a launch writes the launch's four counters and its
// slot marks (an or of 64 bits) into its own slot of a [B, 5] partial
// buffer instead of applying them; probe_combine, one launch on the
// mesh's first device, adds the blocks' counters in block order, ors
// their marks and applies the confirmation update and the counters.  The
// one-device launch is the kOne instantiation (a table's row is its base
// plus i), the same code as before the block form.
//
// Bound on an H100: memory.  The function must read, per prober, its
// know row (U bytes), its draws (rtt, direct, lha and 3k relay legs: 4(3
// + 3k) bytes), coords at i (8 bytes; at j they are the same array
// shifted), awareness and the [N] leaves at j (up, member, committed
// dead/left/inc, bulk, the four subject maps, the three timers: ~35
// bytes) and write the fresh per-node outputs (row_subject, rtt, acked,
// want: 13 bytes) and the timers, awareness and joiner cells that change:
// ~0.14 KB a node, ~0.136 GB at N = 1M, U = 32, k = 3 (~0.041 ms at 3.35
// TB/s; chip_smoke.py:_probe_bytes counts it from the run's data).

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = 4;  // probed, probed & acked, failed, started
constexpr int kSuspect = 1;
constexpr int kTimeouts = 65;  // confirmations 0..64
constexpr int kMaxRelays = 16;
constexpr int kCtrMax = 16;
constexpr int kPart = kCounters + 1;  // a block's partial: counters, marks

// the block tables of a probe round, in the host's order
enum Table { kUp, kMember, kCDead, kCLeft, kCInc, kBulk, kSuspectOf, kDeadOf, kLeftOf,
             kAliveVal, kCoords, kGrp, kOk, kSusStart, kSusConfirm, kSusCount, kWant,
             kTables };

struct ProbeArgs {
  // the state's leaves (know ... ctr updated in place)
  const uint8_t* up;
  const uint8_t* member;
  int8_t* awareness;
  const float2* coords;      // [N, 2]
  const uint8_t* committed_dead;
  const uint8_t* committed_left;
  const int32_t* committed_inc;
  const uint8_t* bulk_member;
  uint8_t* know;             // [N, U]
  int16_t* learn_tick;       // [N, U]
  int8_t* sends_left;        // [N, U]
  int32_t* sus_start;
  int8_t* sus_confirm;
  int32_t* sus_count;
  const int16_t* chaos_grp;  // null unless chaos
  const float* chaos_ok;     // null unless chaos
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  const int32_t* r_inc;
  int8_t* r_confirm;
  const int16_t* timeouts;   // [65]
  // the subject maps
  const int32_t* suspect_of;
  const int32_t* dead_of;
  const int32_t* left_of;
  const int32_t* alive_val;
  float* ctr;                // [C]
  // the probe round's draws
  const int32_t* offs;       // [1 + k]
  const float* rtt_draw;     // [N]
  const float* direct;       // [N]
  const float* lha;          // [N], null when awareness_max == 0
  const float* leg_a;        // [N, k], null when k == 0
  const float* leg_b;
  const float* leg_c;
  int64_t N;
  int U, k, amax, chaos, degraded, C;
  uint32_t seed32;
  float ok_good, ok_bad, degraded_frac, probe_timeout_ms, rtt_base_ms;
  int tick, tick16, limit;
  u64* scratch;  // done count, U slot marks, then kCounters per block
  // fresh outputs
  int32_t* want_out;
  int32_t* row_subject_out;
  float* rtt_out;
  uint8_t* acked_out;
  // the rows of this launch, and the block form's tables and partial slot
  // (null for the one-device launch)
  int64_t row0, row_end;
  u64* part;
  MutRows<uint8_t> t_up, t_member, t_cdead, t_cleft, t_bulk;
  MutRows<int32_t> t_cinc, t_suspect_of, t_dead_of, t_left_of, t_alive_val;
  MutRows<float2> t_coords;
  MutRows<int16_t> t_grp;
  MutRows<float> t_ok;
  MutRows<int32_t> t_sus_start, t_sus_count, t_want;
  MutRows<int8_t> t_sus_confirm;
};

__device__ __forceinline__ int64_t ring(int64_t i, int64_t d, int64_t N) {
  const int64_t x = i + d;
  return x >= N ? x - N : x;
}

__device__ __forceinline__ bool bit(uint64_t m, int u) {
  return u >= 0 && u < 64 && ((m >> u) & 1ull);
}

// at most 64 registers, so four blocks of 256 share an SM (latency hiding
// for a thread's ~30 independent row and target loads)
template <bool kOne>
__global__ void __launch_bounds__(kThreads, 4)
probe_round_kernel(const __grid_constant__ ProbeArgs a) {
  __shared__ int32_t s_subject[64], s_inc[64];
  __shared__ int8_t s_confirm[64];
  __shared__ int16_t s_timeout[kTimeouts];
  __shared__ int32_t s_offs[1 + kMaxRelays];  // ring offsets mod N
  __shared__ uint64_t s_suspect;  // active suspect slots
  __shared__ u64 red[kCounters][32];
  __shared__ bool last;
  const int U = a.U;
  const int64_t N = a.N;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_subject[u] = a.r_subject[u];
    s_inc[u] = a.r_inc[u];
    s_confirm[u] = a.r_confirm[u];
  }
  for (int c = threadIdx.x; c < kTimeouts; c += blockDim.x) s_timeout[c] = a.timeouts[c];
  if (threadIdx.x <= a.k) {
    const int64_t o = static_cast<int64_t>(a.offs[threadIdx.x]) % N;
    s_offs[threadIdx.x] = static_cast<int32_t>(o < 0 ? o + N : o);
  }
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint64_t m = 0;
    for (int pass = 0; pass < 2; ++pass) {
      const int u = lane + 32 * pass;
      const bool sus = u < U && a.r_active[u] && a.r_kind[u] == kSuspect;
      m |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, sus)) << (32 * pass);
    }
    if (lane == 0) s_suspect = m;
  }
  __syncthreads();
  const uint64_t suspect_slots = s_suspect;
  u64* marks = a.scratch + 1;
  u64* partials = a.scratch + 1 + 64;
  const int64_t d = s_offs[0];

  // the per-node delivery rate: 1 - p_loss, or 1 - degraded_loss for the
  // deterministic degraded set, times the chaos rate
  auto ok_of = [&](int64_t x) -> float {
    float o = a.ok_good;
    if (a.degraded) {
      const uint32_t h = static_cast<uint32_t>(x) * 2654435761u + a.seed32;
      if (__fdiv_rn(__uint2float_rn(h), 4294967296.0f) < a.degraded_frac) o = a.ok_bad;
    }
    if (a.chaos) o = __fmul_rn(o, a.t_ok.at<kOne>(x));
    return o;
  };

  u64 v[kCounters] = {0, 0, 0, 0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = a.row0 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.row_end; i += stride) {
    const int64_t j = ring(i, d, N);
    const int64_t row = i * U;
    const bool live_i = a.up[i] && a.member[i];
    float mult = 1.0f;
    bool lha_go = true;
    int aw = 0;
    if (a.amax > 0) {
      aw = a.awareness[i];
      const int score = aw < 0 ? 0 : (aw > a.amax - 1 ? a.amax - 1 : aw);
      mult = static_cast<float>(score + 1);
      lha_go = __fmul_rn(a.lha[i], mult) < 1.0f;
    }
    const bool prober = live_i && lha_go;

    // does prober i already believe its target j is down?
    const uint64_t km = row_mask(a.know + row, U);
    const bool cd_j = a.t_cdead.at<kOne>(j), cl_j = a.t_cleft.at<kOne>(j);
    const int32_t dj = a.t_dead_of.at<kOne>(j), lj = a.t_left_of.at<kOne>(j);
    const int32_t ss = a.t_suspect_of.at<kOne>(j);
    bool down = cd_j || cl_j || bit(km, dj) || bit(km, lj);
    const bool in_s = ss >= 0 && ss < U;
    const bool know_s = in_s && bit(km, ss);
    const int32_t learn = know_s ? a.learn_tick[row + ss] : 0;
    int conf = in_s ? s_confirm[ss] : 0;
    conf = conf < 0 ? 0 : (conf >= kTimeouts ? kTimeouts - 1 : conf);
    const bool expired = know_s && (a.tick16 - learn) >= s_timeout[conf];
    const int32_t av = a.t_alive_val.at<kOne>(j);
    const int32_t inc_s = in_s ? s_inc[ss] : 0;
    bool refuted = av >= 0 && av / U > inc_s && bit(km, av % U);
    refuted = refuted || inc_s < a.t_cinc.at<kOne>(j);
    down = down || (expired && !refuted) || a.t_bulk.at<kOne>(j);
    const bool skip = down;

    // the direct leg
    const bool t_member = a.t_member.at<kOne>(j);
    const bool t_up = a.t_up.at<kOne>(j) && t_member;
    const float ok_i = ok_of(i), ok_t = ok_of(j);
    int g_i = 0, g_j = 0;
    if (a.chaos) {
      g_i = a.chaos_grp[i];
      g_j = a.t_grp.at<kOne>(j);
    }
    const float2 ci = a.coords[i], cj = a.t_coords.at<kOne>(j);
    const float dx = __fsub_rn(ci.x, cj.x), dy = __fsub_rn(ci.y, cj.y);
    const float sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    float rtt = __fadd_rn(__fsqrt_rn(sq), a.rtt_base_ms);
    rtt = __fmul_rn(rtt, __fadd_rn(1.0f, __fmul_rn(a.rtt_draw[i], 0.1f)));
    const float m_t = fminf(ok_i, ok_t);
    const bool legs_ok = a.direct[i] < __fmul_rn(m_t, m_t) && (!a.chaos || g_i == g_j);
    const bool direct_ack = t_up && legs_ok &&
                            __fmul_rn(2.0f, rtt) < __fmul_rn(a.probe_timeout_ms, mult);

    // the k indirect probes through relays (i + offs[1 + m]) % N
    bool ind_ack = false;
    int nacks = 0;
    for (int m = 0; m < a.k; ++m) {
      const int64_t r = ring(i, s_offs[1 + m], N);
      const float ok_r = ok_of(r);
      const int64_t at = i * a.k + m;
      bool l1 = a.leg_a[at] < fminf(ok_i, ok_r);
      const float m_rt = fminf(ok_r, ok_t);
      bool l23 = a.leg_b[at] < __fmul_rn(m_rt, m_rt);
      bool l4 = a.leg_c[at] < fminf(ok_r, ok_i);
      if (a.chaos) {
        const int g_r = a.t_grp.at<kOne>(r);
        l1 = l1 && g_r == g_i;
        l4 = l4 && g_r == g_i;
        l23 = l23 && g_r == g_j;
      }
      const bool relay_ok = a.t_up.at<kOne>(r) && a.t_member.at<kOne>(r);
      const bool reach = t_up && l23;
      ind_ack = ind_ack || (relay_ok && l1 && reach && l4);
      nacks += relay_ok && l1 && !reach && l4;
    }
    const bool ack = direct_ack || ind_ack;
    const bool failed = prober && !skip && !ack && t_member;
    const bool probed = prober && !skip && t_member;
    if (a.amax > 0) {
      const int delta = probed && ack ? -1 : (failed ? a.k - nacks : 0);
      int next = aw + delta;
      next = next < 0 ? 0 : (next > a.amax - 1 ? a.amax - 1 : next);
      if (next != aw) a.awareness[i] = static_cast<int8_t>(next);
    }

    // a failed prober that knows nothing of an existing suspicion about
    // its target joins it (one that knows it changes nothing)
    if (failed && in_s && !know_s) {
      a.know[row + ss] = 1;
      a.learn_tick[row + ss] = static_cast<int16_t>(a.tick16);
      a.sends_left[row + ss] = static_cast<int8_t>(a.limit);
    }
    // the subject's timers, written where they change, and its want
    if (failed) {
      int32_t* start_j = a.t_sus_start.row<kOne>(j);
      const int32_t start = *start_j;
      const bool start_new = start < 0 && !cd_j && !cl_j;
      if (start_new) {
        *start_j = a.tick;
        int32_t* count_j = a.t_sus_count.row<kOne>(j);
        *count_j = *count_j + 1;
      }
      int8_t* confirm_j = a.t_sus_confirm.row<kOne>(j);
      const int sc = *confirm_j;
      const int next = start_new ? 1 : (start >= 0 ? (sc + 1 > 64 ? 64 : sc + 1) : sc);
      if (next != sc) *confirm_j = static_cast<int8_t>(next);
      v[3] += start_new;
      for (uint64_t m = suspect_slots; m; m &= m - 1) {
        const int u = __ffsll(m) - 1;
        if (s_subject[u] == j) marks[u] = 1;
      }
    }
    const bool want = failed && ss < 0 && dj < 0 && lj < 0 && !cd_j && !cl_j;
    *a.t_want.row<kOne>(j) = want ? 1 : 0;
    a.row_subject_out[i] = failed ? static_cast<int32_t>(j) : -1;
    a.rtt_out[i] = __fmul_rn(2.0f, rtt);
    a.acked_out[i] = prober && !skip && direct_ack;
    v[0] += probed;
    v[1] += probed && ack;
    v[2] += failed;
  }

  block_sum<kCounters>(v, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kCounters; ++c) partials[blockIdx.x * kCounters + c] = red[c][0];
  }
  __threadfence();  // the slot marks and the partials, before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(a.scratch, 1ull) == static_cast<u64>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  u64 mine[kCounters] = {0, 0, 0, 0};
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int c = 0; c < kCounters; ++c) mine[c] += __ldcg(&partials[b * kCounters + c]);
  }
  block_sum<kCounters>(mine, red);
  if (a.part != nullptr) {
    // the block form: this launch's totals and marks into its slot
    if (threadIdx.x == 0) {
      u64 m = 0;
      for (int u = 0; u < U; ++u) {
        if (__ldcg(&marks[u])) m |= 1ull << u;
        marks[u] = 0;
      }
#pragma unroll
      for (int c = 0; c < kCounters; ++c) a.part[c] = red[c][0];
      a.part[kCounters] = m;
      *a.scratch = 0;
    }
    return;
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    if ((suspect_slots >> u) & 1ull) {
      const u64 cnt = __ldcg(&marks[u]);
      int c = s_confirm[u] + static_cast<int>(cnt > 8 ? 8 : cnt);
      c = c > 64 ? 64 : c;
      if (c != s_confirm[u]) a.r_confirm[u] = static_cast<int8_t>(c);
      marks[u] = 0;
    }
  }
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    const float old = a.ctr[c];
    const float add = c < kCounters ? __ull2float_rn(red[c][0]) : 0.0f;
    const float now = __fadd_rn(old, add);
    if (__float_as_uint(now) != __float_as_uint(old)) a.ctr[c] = now;
  }
  if (threadIdx.x == 0) *a.scratch = 0;  // ready for the next launch
}

// The blocks' partials: counters added in block order, marks or-ed; the
// confirmation update and the counters applied as the one-device
// launch's last block applies them.  One block.
__global__ void __launch_bounds__(64)
probe_combine_kernel(const u64* __restrict__ part, int B, int U, int C,
                     int8_t* __restrict__ r_confirm, float* __restrict__ ctr) {
  __shared__ u64 tot[kCounters], marks;
  if (threadIdx.x < kCounters) {
    u64 t = 0;
    for (int b = 0; b < B; ++b) t += part[b * kPart + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  if (threadIdx.x == kCounters) {
    u64 m = 0;
    for (int b = 0; b < B; ++b) m |= part[b * kPart + kCounters];
    marks = m;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    if ((marks >> u) & 1ull) {
      const int old = r_confirm[u];
      const int c = old + 1 > 64 ? 64 : old + 1;
      if (c != old) r_confirm[u] = static_cast<int8_t>(c);
    }
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float old = ctr[c];
    const float add = c < kCounters ? __ull2float_rn(tot[c]) : 0.0f;
    const float now = __fadd_rn(old, add);
    if (__float_as_uint(now) != __float_as_uint(old)) ctr[c] = now;
  }
}

}  // namespace

// scratch: 1 + 64 + kCounters * scratch_blocks u64, zeroed once (the last
// block clears the count and the marks it used).  The block form: rows
// [row0, row0 + rows) of N, the leaves at row i (up ... acked_out: every
// [N] pointer of the signature) local to the block (row0 the first), the
// host's `tables` array (kTables tables of B base pointers: the leaves
// read at a target or a relay and the timers and want written there) and
// `part` the block's [5] u64 partial slot; the one-device launch passes
// row0 = 0, rows = N, B = 1 tables of its own pointers and part = null.
extern "C" int probe_round(
    const void* up, const void* member, void* awareness, const void* coords,
    const void* committed_dead, const void* committed_left,
    const void* committed_inc, const void* bulk_member, void* know,
    void* learn_tick, void* sends_left, void* sus_start, void* sus_confirm,
    void* sus_count, const void* chaos_grp, const void* chaos_ok,
    const void* r_active, const void* r_kind, const void* r_subject,
    const void* r_inc, void* r_confirm, const void* timeouts,
    const void* suspect_of, const void* dead_of, const void* left_of,
    const void* alive_val, void* ctr, const void* offs, const void* rtt_draw,
    const void* direct, const void* lha, const void* leg_a,
    const void* leg_b, const void* leg_c, int64_t N, int U, int k, int amax,
    int chaos, int degraded, int C, uint32_t seed32, float ok_good,
    float ok_bad, float degraded_frac, float probe_timeout_ms,
    float rtt_base_ms, int tick, int tick16, int limit, void* scratch,
    int scratch_blocks, void* want_out, void* row_subject_out, void* rtt_out,
    void* acked_out, int64_t row0, int64_t rows, const void* tables, int B,
    int64_t L, void* part, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || k < 0 ||
      row0 < 0 || rows < 1 || row0 + rows > N || B < 1 || B > kMaxBlocks || !tables ||
      (B > 1 && !part) ||
      k > kMaxRelays || amax < 0 || amax > 127 || C < kCounters ||
      C > kCtrMax || scratch_blocks < 1 || (amax > 0 && !lha) ||
      (k > 0 && (!leg_a || !leg_b || !leg_c)) || (chaos && (!chaos_grp || !chaos_ok)) ||
      (reinterpret_cast<uintptr_t>(coords) & 7u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProbeArgs a;
  a.up = shifted<const uint8_t>(const_cast<void*>(up), row0);
  a.member = shifted<const uint8_t>(const_cast<void*>(member), row0);
  a.awareness = shifted<int8_t>(awareness, row0);
  a.coords = shifted<const float2>(const_cast<void*>(coords), row0);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_left = static_cast<const uint8_t*>(committed_left);
  a.committed_inc = static_cast<const int32_t*>(committed_inc);
  a.bulk_member = static_cast<const uint8_t*>(bulk_member);
  a.know = shifted<uint8_t>(know, row0, U);
  a.learn_tick = shifted<int16_t>(learn_tick, row0, U);
  a.sends_left = shifted<int8_t>(sends_left, row0, U);
  a.sus_start = shifted<int32_t>(sus_start, row0);
  a.sus_confirm = shifted<int8_t>(sus_confirm, row0);
  a.sus_count = shifted<int32_t>(sus_count, row0);
  a.chaos_grp = shifted<const int16_t>(const_cast<void*>(chaos_grp), row0);
  a.chaos_ok = shifted<const float>(const_cast<void*>(chaos_ok), row0);
  a.r_active = static_cast<const uint8_t*>(r_active);
  a.r_kind = static_cast<const int8_t*>(r_kind);
  a.r_subject = static_cast<const int32_t*>(r_subject);
  a.r_inc = static_cast<const int32_t*>(r_inc);
  a.r_confirm = static_cast<int8_t*>(r_confirm);
  a.timeouts = static_cast<const int16_t*>(timeouts);
  a.suspect_of = static_cast<const int32_t*>(suspect_of);
  a.dead_of = static_cast<const int32_t*>(dead_of);
  a.left_of = static_cast<const int32_t*>(left_of);
  a.alive_val = static_cast<const int32_t*>(alive_val);
  a.ctr = static_cast<float*>(ctr);
  a.offs = static_cast<const int32_t*>(offs);
  a.rtt_draw = shifted<const float>(const_cast<void*>(rtt_draw), row0);
  a.direct = shifted<const float>(const_cast<void*>(direct), row0);
  a.lha = shifted<const float>(const_cast<void*>(lha), row0);
  a.leg_a = shifted<const float>(const_cast<void*>(leg_a), row0, k);
  a.leg_b = shifted<const float>(const_cast<void*>(leg_b), row0, k);
  a.leg_c = shifted<const float>(const_cast<void*>(leg_c), row0, k);
  a.N = N;
  a.U = U;
  a.k = k;
  a.amax = amax;
  a.chaos = chaos;
  a.degraded = degraded;
  a.C = C;
  a.seed32 = seed32;
  a.ok_good = ok_good;
  a.ok_bad = ok_bad;
  a.degraded_frac = degraded_frac;
  a.probe_timeout_ms = probe_timeout_ms;
  a.rtt_base_ms = rtt_base_ms;
  a.tick = tick;
  a.tick16 = tick16;
  a.limit = limit;
  a.scratch = static_cast<u64*>(scratch);
  a.want_out = shifted<int32_t>(want_out, row0);
  a.row_subject_out = shifted<int32_t>(row_subject_out, row0);
  a.rtt_out = shifted<float>(rtt_out, row0);
  a.acked_out = shifted<uint8_t>(acked_out, row0);
  a.row0 = row0;
  a.row_end = row0 + rows;
  a.part = static_cast<u64*>(part);
  a.t_up = mut_rows<uint8_t>(tables, kUp, B, L);
  a.t_member = mut_rows<uint8_t>(tables, kMember, B, L);
  a.t_cdead = mut_rows<uint8_t>(tables, kCDead, B, L);
  a.t_cleft = mut_rows<uint8_t>(tables, kCLeft, B, L);
  a.t_cinc = mut_rows<int32_t>(tables, kCInc, B, L);
  a.t_bulk = mut_rows<uint8_t>(tables, kBulk, B, L);
  a.t_suspect_of = mut_rows<int32_t>(tables, kSuspectOf, B, L);
  a.t_dead_of = mut_rows<int32_t>(tables, kDeadOf, B, L);
  a.t_left_of = mut_rows<int32_t>(tables, kLeftOf, B, L);
  a.t_alive_val = mut_rows<int32_t>(tables, kAliveVal, B, L);
  a.t_coords = mut_rows<float2>(tables, kCoords, B, L);
  a.t_grp = mut_rows<int16_t>(tables, kGrp, B, L);
  a.t_ok = mut_rows<float>(tables, kOk, B, L);
  a.t_sus_start = mut_rows<int32_t>(tables, kSusStart, B, L);
  a.t_sus_confirm = mut_rows<int8_t>(tables, kSusConfirm, B, L);
  a.t_sus_count = mut_rows<int32_t>(tables, kSusCount, B, L);
  a.t_want = mut_rows<int32_t>(tables, kWant, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1 && part == nullptr) {
    static PerCard per_card;
    const int blocks = persistent_blocks(probe_round_kernel<true>, kThreads, rows,
                                         scratch_blocks, per_card);
    probe_round_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    static PerCard per_card;
    const int blocks = persistent_blocks(probe_round_kernel<false>, kThreads, rows,
                                         scratch_blocks, per_card);
    probe_round_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: B blocks' [5] u64 partials (a probe_round block form each);
// r_confirm [U] and ctr [C] updated in place.
extern "C" int probe_combine(const void* part, int B, int U, int C, void* r_confirm,
                             void* ctr, void* stream) {
  if (B < 1 || B > kMaxBlocks || U < 1 || U > 64 || C < kCounters || C > kCtrMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  probe_combine_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(part), B, U, C, static_cast<int8_t*>(r_confirm),
      static_cast<float*>(ctr));
  return static_cast<int>(cudaGetLastError());
}
