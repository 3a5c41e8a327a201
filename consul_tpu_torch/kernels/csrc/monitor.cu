// K3 believed_down: the per-tick convergence monitor, the fraction of live
// members (excluding the subject) that believe one subject is down.
//
// Replaces: consul_tpu/models/swim.py believed_down_fraction, which XLA
// runs inside the bench's timed scan as [U] rumor-table masks, [N, U]
// mask algebra (dead/left knowledge, expired unrefuted suspicion against
// the Lifeguard timeout, the highest known alive incarnation) and two [N]
// reductions.
//
// The kernel reads the rumor table's raw [U] leaves (r_active, r_kind,
// r_subject, r_inc, r_confirm) and the int16 Lifeguard timeout table
// (65 entries, built once per params): every block's first warp ballots
// the subject's dead/left, suspect and alive slot masks (lane = slot, two
// passes for U <= 64) and stages each slot's incarnation and timeout in
// shared memory, so no per-tick slot prep runs before the launch.  A
// persistent grid walks the rows, U / 16 lanes to a row for U = 16, 32,
// 64 (one 16-byte know chunk each, ORed into the row's 64-bit slot mask
// with shuffles; four 32-item groups per warp trip), one thread a row
// otherwise; only a row's set slots are visited.  When the subject's death or leave is
// committed, or no rumor names it as dead, left or suspect, no row's know
// bytes can change the answer and none are read.  Believers and
// observers are summed with warp shuffles, one partial pair per block and
// one atomic per block; the last block writes count / max(observers, 1),
// maxed with the subject's bulk-channel coverage, into one float32 of the
// caller's per-scan output vector: the host reads the whole scan's
// fractions back in one copy, never once per tick.
//
// Blocks (a node-sharded pool, parallel/mesh.py): the kernel runs per
// block over rows [row0, row0 + rows), the subject global, its committed
// and bulk cells read through pointers into the block that holds it (on
// this card or a peer), the rumor table and timeout table from the
// launching card's copy.  Each block's launch writes its two integer
// counts to its own slot of `partial`; believed_down_combine adds the B
// slots in block order and divides once, so the fraction is the
// one-device launch's bits whatever B is.  The one-device launch is
// row0 = 0, rows = N and no partial.
//
// Bound on an H100: memory.  The kernel must read up/member (2 bytes a
// row) and, unless the subject is committed, know (U bytes a row);
// learn_tick (2U bytes a row) only in the cells a suspect rumor about the
// subject occupies: ~(U + 2) * N bytes plus those learn ticks.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kAlive = 0, kSuspect = 1, kDead = 2, kLeft = 3;
constexpr int kTimeouts = 65;  // confirmations 0..64

// believers / max(observers, 1) in IEEE division, maxed with the
// subject's bulk-channel coverage.
__device__ __forceinline__ float fraction(const u64 (&tot)[2], const uint8_t* subj_bulk,
                                          const float* subj_cov) {
  const u64 observers = tot[1] < 1 ? 1 : tot[1];
  const float frac = __fdiv_rn(__ull2float_rn(tot[0]), __ull2float_rn(observers));
  const float bulk = *subj_bulk ? *subj_cov : 0.0f;
  return frac > bulk ? frac : bulk;
}

__global__ void __launch_bounds__(kThreads) believed_down_kernel(
    const uint8_t* __restrict__ know, const int16_t* __restrict__ learn_tick,
    const uint8_t* __restrict__ up, const uint8_t* __restrict__ member,
    const uint8_t* __restrict__ r_active, const int8_t* __restrict__ r_kind,
    const int32_t* __restrict__ r_subject, const int32_t* __restrict__ r_inc,
    const int8_t* __restrict__ r_confirm,
    const int16_t* __restrict__ timeouts,
    const uint8_t* __restrict__ subj_dead,
    const uint8_t* __restrict__ subj_left,
    const int32_t* __restrict__ subj_inc,
    const uint8_t* __restrict__ subj_bulk, const float* __restrict__ subj_cov,
    int64_t subject, int tick16, int64_t row0, int64_t N, int U, int vec,
    u64* __restrict__ scratch, float* __restrict__ out,
    u64* __restrict__ partial) {
  __shared__ uint64_t s_dl, s_s, s_a;
  __shared__ int32_t s_inc[64];
  __shared__ int16_t s_to[64];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint64_t dl = 0, su = 0, al = 0;
    for (int pass = 0; pass < 2; ++pass) {
      const int u = lane + 32 * pass;
      const bool mine = u < U && r_active[u] && r_subject[u] == subject;
      const int kind = u < U ? r_kind[u] : -1;
      const int sh = 32 * pass;
      dl |= static_cast<uint64_t>(__ballot_sync(
          0xffffffffu, mine && (kind == kDead || kind == kLeft))) << sh;
      su |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, mine && kind == kSuspect)) << sh;
      al |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, mine && kind == kAlive)) << sh;
      if (u < U) {
        int c = r_confirm[u];
        c = c < 0 ? 0 : (c >= kTimeouts ? kTimeouts - 1 : c);
        s_inc[u] = r_inc[u];
        s_to[u] = timeouts[c];
      }
    }
    if (lane == 0) {
      s_dl = dl;
      s_s = su;
      s_a = al;
    }
  }
  __syncthreads();
  const uint64_t m_dl = s_dl, m_s = s_s, m_a = s_a;
  const bool committed = *subj_dead || *subj_left;
  const bool read_rows = !committed && (m_dl | m_s) != 0;
  const int32_t cinc = *subj_inc;
  const int64_t local_subject = subject - row0;  // outside [0, N): not here

  u64 v[2] = {0, 0};  // believers among observers, observers
  // does an observer whose know row has slot mask km believe it?
  auto believes = [&](int64_t i, uint64_t km) -> bool {
    if (km & m_dl) return true;
    if (!(km & m_s)) return false;
    int32_t a_known = -1;
    for (uint64_t m = km & m_a; m; m &= m - 1) {
      const int32_t inc = s_inc[__ffsll(m) - 1];
      if (inc > a_known) a_known = inc;
    }
    for (uint64_t m = km & m_s; m; m &= m - 1) {
      const int u = __ffsll(m) - 1;
      const int16_t age = static_cast<int16_t>(tick16 - learn_tick[i * U + u]);
      const bool refuted = a_known > s_inc[u] || s_inc[u] < cinc;
      if (age >= s_to[u] && !refuted) return true;
    }
    return false;
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (read_rows && vec) {
    // U / 16 lanes to a row, one 16-slot chunk each: a warp's know loads
    // cover contiguous bytes.  Each warp takes four 32-item groups a trip,
    // their loads issued together, to keep more bytes in flight.
    const int lanes = U / 16, shift = lanes == 1 ? 0 : lanes == 2 ? 1 : 2;
    const int64_t items = N << shift;
    const int lane = threadIdx.x & 31;
    const int chunk = lane & (lanes - 1);
    constexpr int kGroups = 4;
    for (int64_t base = (tid - lane) * kGroups; base < items;
         base += stride * kGroups) {
      u64 km[kGroups];
      bool observer[kGroups];
#pragma unroll
      for (int r = 0; r < kGroups; ++r) {
        const int64_t item = base + 32 * r + lane;
        const int64_t row = item >> shift;
        km[r] = 0;
        observer[r] = false;
        if (item < items) {
          const uint4 w = __ldcs(reinterpret_cast<const uint4*>(know + row * U + 16 * chunk));
          // both flags loaded unconditionally: no load waits on another
          observer[r] = (up[row] & member[row]) && row != local_subject;
          km[r] = static_cast<u64>(flags16(make_uint4(
                      nonzero_bytes(w.x), nonzero_bytes(w.y), nonzero_bytes(w.z),
                      nonzero_bytes(w.w)))) << (16 * chunk);
        }
      }
#pragma unroll
      for (int r = 0; r < kGroups; ++r) {
        for (int o = 1; o < lanes; o <<= 1) km[r] |= __shfl_xor_sync(0xffffffffu, km[r], o);
        if (observer[r] && chunk == 0) {
          v[0] += believes((base + 32 * r + lane) >> shift, km[r]) ? 1 : 0;
          v[1] += 1;
        }
      }
    }
  } else {
    for (int64_t i = tid; i < N; i += stride) {
      if (!(up[i] && member[i]) || i == local_subject) continue;
      const bool down = read_rows ? believes(i, row_mask(know + i * U, U)) : committed;
      v[0] += down ? 1 : 0;
      v[1] += 1;
    }
  }
  u64 tot[2];
  if (grid_sum<2>(v, scratch, tot)) {
    if (partial != nullptr) {  // one block of a sharded pool: its own slot
      partial[0] = tot[0];
      partial[1] = tot[1];
    } else {
      *out = fraction(tot, subj_bulk, subj_cov);
    }
  }
}

// The B blocks' [2] partials added in block order, then divided once.
__global__ void believed_down_combine_kernel(const u64* __restrict__ partials, int B,
                                             const uint8_t* __restrict__ subj_bulk,
                                             const float* __restrict__ subj_cov,
                                             float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  u64 tot[2] = {0, 0};
  for (int b = 0; b < B; ++b) {
    tot[0] += partials[2 * b];
    tot[1] += partials[2 * b + 1];
  }
  *out = fraction(tot, subj_bulk, subj_cov);
}

}  // namespace

// subj_dead, subj_left, subj_inc, subj_bulk and subj_cov point at the
// subject's cells of committed_dead, committed_left, committed_inc,
// bulk_member and bulk_cov (in whichever block holds it).  The launch
// covers the N rows from global row row0 (know, learn_tick, up and member
// start there); with `partial` (2 u64) it writes its counts there and
// leaves `out` to believed_down_combine.
extern "C" int believed_down(const void* know, const void* learn_tick,
                             const void* up, const void* member,
                             const void* r_active, const void* r_kind,
                             const void* r_subject, const void* r_inc,
                             const void* r_confirm, const void* timeouts,
                             const void* subj_dead, const void* subj_left,
                             const void* subj_inc, const void* subj_bulk,
                             const void* subj_cov, int64_t subject, int tick16,
                             int64_t row0, int64_t N, int U, int vec,
                             void* scratch, int scratch_blocks, void* out,
                             void* partial, void* stream) {
  if (N < 1 || U < 1 || U > 64 || subject < 0 || row0 < 0 ||
      scratch_blocks < 1 || (out == nullptr && partial == nullptr) ||
      (vec && U != 16 && U != 32 && U != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static PerCard per_card;
  const int blocks = persistent_blocks(believed_down_kernel, kThreads,
                                       vec ? N * (U / 16) : N, scratch_blocks,
                                       per_card);
  believed_down_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(know),
      static_cast<const int16_t*>(learn_tick),
      static_cast<const uint8_t*>(up), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject),
      static_cast<const int32_t*>(r_inc),
      static_cast<const int8_t*>(r_confirm),
      static_cast<const int16_t*>(timeouts),
      static_cast<const uint8_t*>(subj_dead),
      static_cast<const uint8_t*>(subj_left),
      static_cast<const int32_t*>(subj_inc),
      static_cast<const uint8_t*>(subj_bulk),
      static_cast<const float*>(subj_cov), subject, tick16, row0, N, U, vec,
      static_cast<u64*>(scratch), static_cast<float*>(out),
      static_cast<u64*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// A sharded monitor's fraction: partials [B * 2] u64 in block order.
extern "C" int believed_down_combine(const void* partials, int B,
                                     const void* subj_bulk,
                                     const void* subj_cov, void* out,
                                     void* stream) {
  if (B < 1 || partials == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  believed_down_combine_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(partials), B, static_cast<const uint8_t*>(subj_bulk),
      static_cast<const float*>(subj_cov), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
