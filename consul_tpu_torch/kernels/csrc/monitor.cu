// K3 believed_down: the per-tick convergence monitor, the fraction of live
// members (excluding the subject) that believe one subject is down.
//
// Replaces: consul_tpu/models/swim.py believed_down_fraction, which XLA
// runs inside the bench's timed scan as [N, U] mask algebra (dead/left
// knowledge, expired unrefuted suspicion against the Lifeguard timeout,
// the highest known alive incarnation) and two [N] reductions.
//
// The per-slot vectors (is_dl/is_s/is_a, r_inc and the int16 timeout) are
// tiny and come precomputed from torch; each block stages them in shared
// memory as slot masks.  One thread evaluates one node row: the row's know
// bytes become a 64-bit slot mask (16-byte loads), and only its few set
// slots are visited.  Believers and observers are summed per block, folded
// into integer atomics, and the last block writes count / max(observers,
// 1), maxed with the subject's bulk-channel coverage, into one float32 of
// the caller's per-scan output vector: the host reads the whole scan's
// fractions back in one copy, never once per tick.
//
// Bound on an H100: memory.  The kernel must read know (U bytes a row)
// and up/member; learn_tick (2U bytes a row) is read only in the cells a
// suspect rumor about the subject occupies, so the bytes that bound it
// are ~(U + 2) * N plus the learn_tick of those cells.  Once the subject's
// death is committed no row needs its know bytes at all.

#include "common.cuh"

using namespace consul_kernels;

namespace {

__global__ void believed_down_kernel(
    const uint8_t* __restrict__ know, const int16_t* __restrict__ learn_tick,
    const uint8_t* __restrict__ up, const uint8_t* __restrict__ member,
    const uint8_t* __restrict__ is_dl, const uint8_t* __restrict__ is_s,
    const uint8_t* __restrict__ is_a, const int32_t* __restrict__ r_inc,
    const int16_t* __restrict__ timeout16,
    const uint8_t* __restrict__ committed_dead,
    const uint8_t* __restrict__ committed_left,
    const int32_t* __restrict__ committed_inc,
    const uint8_t* __restrict__ bulk_member, const float* __restrict__ bulk_cov,
    int64_t subject, int tick16, int64_t N, int U,
    u64* __restrict__ acc,  // [3]
    float* __restrict__ out) {
  __shared__ uint64_t s_dl, s_s, s_a;
  __shared__ int32_t s_inc[64];
  __shared__ int16_t s_to[64];
  if (threadIdx.x == 0) {
    uint64_t dl = 0, su = 0, al = 0;
    for (int u = 0; u < U; ++u) {
      if (is_dl[u]) dl |= 1ull << u;
      if (is_s[u]) su |= 1ull << u;
      if (is_a[u]) al |= 1ull << u;
    }
    s_dl = dl;
    s_s = su;
    s_a = al;
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_inc[u] = r_inc[u];
    s_to[u] = timeout16[u];
  }
  __syncthreads();

  u64 v[2] = {0, 0};  // believers among observers, observers
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < N && up[i] && member[i] && i != subject) {
    bool down = committed_dead[subject] || committed_left[subject];
    if (!down) {
      const uint64_t km = row_mask(know + i * U, U);
      if (km & s_dl) {
        down = true;
      } else if (km & s_s) {
        int32_t a_known = -1;
        for (uint64_t m = km & s_a; m; m &= m - 1) {
          const int32_t inc = s_inc[__ffsll(m) - 1];
          if (inc > a_known) a_known = inc;
        }
        const int32_t cinc = committed_inc[subject];
        for (uint64_t m = km & s_s; m && !down; m &= m - 1) {
          const int u = __ffsll(m) - 1;
          const int16_t age = static_cast<int16_t>(tick16 - learn_tick[i * U + u]);
          const bool refuted = (a_known > s_inc[u]) || (s_inc[u] < cinc);
          if (age >= s_to[u] && !refuted) down = true;
        }
      }
    }
    v[0] = down ? 1 : 0;
    v[1] = 1;
  }
  if (block_accumulate<2>(v, acc)) {
    const u64 believers = take(&acc[0]);
    u64 observers = take(&acc[1]);
    take(&acc[2]);
    if (observers < 1) observers = 1;
    const float frac = static_cast<float>(believers) / static_cast<float>(observers);
    const float bulk = bulk_member[subject] ? bulk_cov[subject] : 0.0f;
    *out = frac > bulk ? frac : bulk;
  }
}

}  // namespace

extern "C" int believed_down(const void* know, const void* learn_tick,
                             const void* up, const void* member,
                             const void* is_dl, const void* is_s,
                             const void* is_a, const void* r_inc,
                             const void* timeout16, const void* committed_dead,
                             const void* committed_left,
                             const void* committed_inc,
                             const void* bulk_member, const void* bulk_cov,
                             int64_t subject, int tick16, int64_t N, int U,
                             void* acc, void* out, void* stream) {
  const int threads = 256;
  const int64_t blocks = (N + threads - 1) / threads;
  believed_down_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(know),
      static_cast<const int16_t*>(learn_tick),
      static_cast<const uint8_t*>(up), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(is_dl), static_cast<const uint8_t*>(is_s),
      static_cast<const uint8_t*>(is_a), static_cast<const int32_t*>(r_inc),
      static_cast<const int16_t*>(timeout16),
      static_cast<const uint8_t*>(committed_dead),
      static_cast<const uint8_t*>(committed_left),
      static_cast<const int32_t*>(committed_inc),
      static_cast<const uint8_t*>(bulk_member),
      static_cast<const float*>(bulk_cov), subject, tick16, N, U,
      static_cast<u64*>(acc), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
