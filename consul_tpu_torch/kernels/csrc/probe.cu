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
    if (a.chaos) o = __fmul_rn(o, a.chaos_ok[x]);
    return o;
  };

  u64 v[kCounters] = {0, 0, 0, 0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
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
    const bool cd_j = a.committed_dead[j], cl_j = a.committed_left[j];
    const int32_t dj = a.dead_of[j], lj = a.left_of[j], ss = a.suspect_of[j];
    bool down = cd_j || cl_j || bit(km, dj) || bit(km, lj);
    const bool in_s = ss >= 0 && ss < U;
    const bool know_s = in_s && bit(km, ss);
    const int32_t learn = know_s ? a.learn_tick[row + ss] : 0;
    int conf = in_s ? s_confirm[ss] : 0;
    conf = conf < 0 ? 0 : (conf >= kTimeouts ? kTimeouts - 1 : conf);
    const bool expired = know_s && (a.tick16 - learn) >= s_timeout[conf];
    const int32_t av = a.alive_val[j];
    const int32_t inc_s = in_s ? s_inc[ss] : 0;
    bool refuted = av >= 0 && av / U > inc_s && bit(km, av % U);
    refuted = refuted || inc_s < a.committed_inc[j];
    down = down || (expired && !refuted) || a.bulk_member[j];
    const bool skip = down;

    // the direct leg
    const bool t_member = a.member[j];
    const bool t_up = a.up[j] && t_member;
    const float ok_i = ok_of(i), ok_t = ok_of(j);
    int g_i = 0, g_j = 0;
    if (a.chaos) {
      g_i = a.chaos_grp[i];
      g_j = a.chaos_grp[j];
    }
    const float2 ci = a.coords[i], cj = a.coords[j];
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
        const int g_r = a.chaos_grp[r];
        l1 = l1 && g_r == g_i;
        l4 = l4 && g_r == g_i;
        l23 = l23 && g_r == g_j;
      }
      const bool relay_ok = a.up[r] && a.member[r];
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
      const int32_t start = a.sus_start[j];
      const bool start_new = start < 0 && !cd_j && !cl_j;
      if (start_new) {
        a.sus_start[j] = a.tick;
        a.sus_count[j] = a.sus_count[j] + 1;
      }
      const int sc = a.sus_confirm[j];
      const int next = start_new ? 1 : (start >= 0 ? (sc + 1 > 64 ? 64 : sc + 1) : sc);
      if (next != sc) a.sus_confirm[j] = static_cast<int8_t>(next);
      v[3] += start_new;
      for (uint64_t m = suspect_slots; m; m &= m - 1) {
        const int u = __ffsll(m) - 1;
        if (s_subject[u] == j) marks[u] = 1;
      }
    }
    const bool want = failed && ss < 0 && dj < 0 && lj < 0 && !cd_j && !cl_j;
    a.want_out[j] = want ? 1 : 0;
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

}  // namespace

// scratch: 1 + 64 + kCounters * scratch_blocks u64, zeroed once (the last
// block clears the count and the marks it used).
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
    void* acked_out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || k < 0 ||
      k > kMaxRelays || amax < 0 || amax > 127 || C < kCounters ||
      C > kCtrMax || scratch_blocks < 1 || (amax > 0 && !lha) ||
      (k > 0 && (!leg_a || !leg_b || !leg_c)) || (chaos && (!chaos_grp || !chaos_ok)) ||
      (reinterpret_cast<uintptr_t>(coords) & 7u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProbeArgs a;
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.awareness = static_cast<int8_t*>(awareness);
  a.coords = static_cast<const float2*>(coords);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.committed_left = static_cast<const uint8_t*>(committed_left);
  a.committed_inc = static_cast<const int32_t*>(committed_inc);
  a.bulk_member = static_cast<const uint8_t*>(bulk_member);
  a.know = static_cast<uint8_t*>(know);
  a.learn_tick = static_cast<int16_t*>(learn_tick);
  a.sends_left = static_cast<int8_t*>(sends_left);
  a.sus_start = static_cast<int32_t*>(sus_start);
  a.sus_confirm = static_cast<int8_t*>(sus_confirm);
  a.sus_count = static_cast<int32_t*>(sus_count);
  a.chaos_grp = static_cast<const int16_t*>(chaos_grp);
  a.chaos_ok = static_cast<const float*>(chaos_ok);
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
  a.rtt_draw = static_cast<const float*>(rtt_draw);
  a.direct = static_cast<const float*>(direct);
  a.lha = static_cast<const float*>(lha);
  a.leg_a = static_cast<const float*>(leg_a);
  a.leg_b = static_cast<const float*>(leg_b);
  a.leg_c = static_cast<const float*>(leg_c);
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
  a.want_out = static_cast<int32_t*>(want_out);
  a.row_subject_out = static_cast<int32_t*>(row_subject_out);
  a.rtt_out = static_cast<float*>(rtt_out);
  a.acked_out = static_cast<uint8_t*>(acked_out);
  static PerCard per_card;
  const int blocks = persistent_blocks(probe_round_kernel, kThreads, N,
                                       scratch_blocks, per_card);
  probe_round_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
