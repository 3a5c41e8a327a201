// K5 mass_detect: recall and false positives of a correlated-failure
// experiment, every tick of the mass-event bench.
//
// Replaces: consul_tpu/models/swim.py mass_detection_stats, which XLA runs
// as an [N, U] live-column reduction (each slot's coverage among live
// members), a [U] dead/left-rumor mask at the 0.99 bar, a [U] -> [N]
// scatter-max of the detected rumors' subjects and four [N] count
// reductions (live, victims, detected victims, detected live members).
//
// Bound on an H100: memory.  The function must read the know rows of the
// live members (U bytes each), six [N] bool leaves (up, member,
// committed_dead, committed_left, bulk_member, victim) and bulk_cov only
// where a bulk subject is not committed yet (the 32-byte sectors holding
// one): ~38 MB at N = 1M, U = 32 with 1% of the nodes in the bulk
// channel, ~0.011 ms at 3.35 TB/s.  The [U] table and the outputs are
// bytes.
//
// One launch, a persistent grid walking the rows a thread each:
//   * each row adds to four counters: live = up & member, victim & member,
//     and the rows the base mask (committed dead or left, or a bulk-channel
//     subject whose own coverage is >= 0.99) already counts as believed
//     down among victims and among live rows;
//   * a live row's know bytes become its slot mask (16-byte loads where
//     the row is aligned), and common.cuh:warp_column_counts turns 32
//     rows' masks into per-slot counts (a warp bit transpose and a
//     popcount a slot);
//   * each block sums its counters (shuffles) and its slot counts (shared
//     atomics) and adds them to a per-call scratch, one global atomic a
//     counter; then the last block to finish (a fence and a done count)
//     applies the coverage bar, float32 count / float32 max(n_live, 1) in
//     IEEE division as jnp computes it, de-duplicates the detected slots'
//     subjects (two slots may name one subject; a masked slot names none),
//     adds each subject the base mask did not already count, and writes
//     recall = float32(detected victims) / float32(max(victims, 1)) and
//     the int32 false-positive count.
// Integer counts make the result independent of the order blocks finish.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = 4;  // live, victims, base & victims, base & live
constexpr int kDead = 2, kLeft = 3;

__global__ void __launch_bounds__(kThreads) mass_detect_kernel(
    const uint8_t* __restrict__ know, const uint8_t* __restrict__ up,
    const uint8_t* __restrict__ member,
    const uint8_t* __restrict__ committed_dead,
    const uint8_t* __restrict__ committed_left,
    const uint8_t* __restrict__ bulk_member, const float* __restrict__ bulk_cov,
    const uint8_t* __restrict__ victim, const uint8_t* __restrict__ r_active,
    const int8_t* __restrict__ r_kind, const int32_t* __restrict__ r_subject,
    int64_t N, int U, u64* __restrict__ scratch, float* __restrict__ recall,
    int32_t* __restrict__ fp) {
  __shared__ uint32_t s_col[64];
  __shared__ u64 red[kCounters][32];
  __shared__ bool last;
  if (threadIdx.x < 64) s_col[threadIdx.x] = 0;
  __syncthreads();

  // the base mask: committed, or a bulk subject at its own 0.99 bar
  auto base_down = [&](int64_t i) -> bool {
    return committed_dead[i] || committed_left[i] ||
           (bulk_member[i] && bulk_cov[i] >= 0.99f);
  };

  u64 v[kCounters] = {0, 0, 0, 0};
  uint32_t cnt[2] = {0, 0};
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // warp-uniform trip count: every lane reaches the column counts
  for (int64_t i0 = tid - lane; i0 < N; i0 += stride) {
    const int64_t i = i0 + lane;
    uint64_t m = 0;
    if (i < N) {
      const bool mem = member[i] != 0;
      const bool live = mem && up[i];
      const bool vic = mem && victim[i];
      const bool down = base_down(i);
      v[0] += live;
      v[1] += vic;
      v[2] += down && vic;
      v[3] += down && live;
      if (live) m = row_mask(know + i * U, U);
    }
    warp_column_counts(m, U, cnt);
  }
  atomicAdd(&s_col[lane], cnt[0]);
  if (U > 32) atomicAdd(&s_col[lane + 32], cnt[1]);
  block_sum<kCounters>(v, red);  // its syncs also publish s_col
  if (threadIdx.x < kCounters) atomicAdd(&scratch[1 + threadIdx.x], red[threadIdx.x][0]);
  if (threadIdx.x < U && s_col[threadIdx.x] != 0) {
    atomicAdd(&scratch[1 + kCounters + threadIdx.x], static_cast<u64>(s_col[threadIdx.x]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&scratch[0], 1ull) == static_cast<u64>(gridDim.x) - 1;
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();

  const u64 n_live = __ldcg(&scratch[1]);
  const u64 victims = __ldcg(&scratch[2]);
  u64 found = __ldcg(&scratch[3]);
  u64 false_pos = __ldcg(&scratch[4]);
  const float live_f = __ull2float_rn(n_live < 1 ? 1 : n_live);
  uint64_t detected = 0;  // slots whose dead/left rumor reached the bar
  for (int u = 0; u < U; ++u) {
    const int kind = r_kind[u];
    if (!r_active[u] || (kind != kDead && kind != kLeft)) continue;
    const float cov = __fdiv_rn(__ull2float_rn(__ldcg(&scratch[1 + kCounters + u])), live_f);
    if (cov >= 0.99f) detected |= 1ull << u;
  }
  for (uint64_t d = detected; d; d &= d - 1) {
    const int u = __ffsll(d) - 1;
    const int64_t s = r_subject[u];
    if (s < 0 || s >= N) continue;
    bool seen = false;  // an earlier detected slot names the same subject
    for (uint64_t e = detected & ((1ull << u) - 1); e && !seen; e &= e - 1) {
      seen = r_subject[__ffsll(e) - 1] == r_subject[u];
    }
    if (seen || base_down(s)) continue;
    const bool mem = member[s] != 0;
    found += mem && victim[s];
    false_pos += mem && up[s];
  }
  *recall = __fdiv_rn(__ull2float_rn(found), __ull2float_rn(victims < 1 ? 1 : victims));
  *fp = static_cast<int32_t>(false_pos);
}

}  // namespace

// scratch: 1 + kCounters + U zeroed u64 (done count, counters, slot counts).
extern "C" int mass_detect(const void* know, const void* up, const void* member,
                           const void* committed_dead,
                           const void* committed_left,
                           const void* bulk_member, const void* bulk_cov,
                           const void* victim, const void* r_active,
                           const void* r_kind, const void* r_subject,
                           int64_t N, int U, void* scratch, void* recall,
                           void* fp, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int per_card = 0;
  const int blocks = persistent_blocks(mass_detect_kernel, kThreads, N,
                                       1 << 20, per_card);
  mass_detect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(know), static_cast<const uint8_t*>(up),
      static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(committed_dead),
      static_cast<const uint8_t*>(committed_left),
      static_cast<const uint8_t*>(bulk_member),
      static_cast<const float*>(bulk_cov), static_cast<const uint8_t*>(victim),
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject), N, U,
      static_cast<u64*>(scratch), static_cast<float*>(recall),
      static_cast<int32_t*>(fp));
  return static_cast<int>(cudaGetLastError());
}
