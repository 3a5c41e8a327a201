// K4 members: the oracle's membership reads — the status vector, the
// counts by status, the changed members against a checkpoint, and a page
// of member rows.
//
// Replaces: consul_tpu/models/swim.py status_vector, membership_counts,
// membership_page and membership_delta, which XLA runs as some ten [N]
// elementwise and scatter kernels for the status (the dead rumors'
// scatter-max into an [N] mask, the left/failed selects) and, for the
// delta, a top-k of the [N] changed mask (a stable sort of [N] in the
// plain twin) to find the first k changed members.
//
// One device function, status_of(i), gives node i's int8 status from
// member, committed_dead and committed_left and the subjects of the [U]
// table's active dead rumors, which every block's first warp compacts
// into shared memory once (ballot over the slots, U <= 64).  Left wins
// over failed; a node that is not a member is left.
//
// Three launches share it:
//   members_scan   a block per tile of kTile nodes: the status (written
//                  only when asked), and over provisioned nodes the
//                  counts by status, the total and the number whose status
//                  differs from `prev`; each block's changed count goes to
//                  block_changed[b], the five totals to one int32 vector
//                  by one atomic add per block (integers: exact, in any
//                  order).
//   members_emit   the same tiles: each block sums the changed counts of
//                  the tiles before it, and, if that is below k, scans its
//                  own tile's changed flags (a thread takes kPer
//                  consecutive nodes; warp shuffles, then the warps'
//                  totals) and writes idx[rank] = i, state[rank] =
//                  status[i] for ranks below k: the ascending first k, as
//                  the JAX top-k over the 0/1 mask returns them.  Ranks
//                  from n_changed to k get idx -1 and state status[0]
//                  (swim.py:1558-1559 reads st[max(idx, 0)]).  A tile
//                  with no changed member is not read.
//   members_page   a thread per requested id: status_of(id),
//                  incarnation[id] and up[id], ids wrapped once when
//                  negative and clamped into [0, N) as a JAX gather does.
//
// Bound on an H100: memory, and at N = 1M launch cost.  The scan must read
// member, committed_dead, committed_left and provisioned (4 bytes a node),
// plus prev and the status write for a delta (6); the emit reads status,
// prev and provisioned only in tiles that hold a changed member.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // nodes a thread
constexpr int kTile = kThreads * kPer;   // nodes a block, scan and emit alike
constexpr int kDead = 2;                 // swim.DEAD
constexpr int8_t kAlive = 0, kFailed = 1, kLeft = 2;  // swim.STATUS_*
constexpr int kCounts = 5;               // alive, failed, left, total, changed

struct DeadSubjects {
  int32_t subj[64];
  int n;
};

// The subjects of the active dead rumors, compacted by the first warp;
// every thread of the block must call it.
__device__ void load_dead(const uint8_t* __restrict__ r_active,
                          const int8_t* __restrict__ r_kind,
                          const int32_t* __restrict__ r_subject, int U,
                          DeadSubjects& d) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int pass = 0; pass < 2; ++pass) {
      const int u = lane + 32 * pass;
      const bool dead = u < U && r_active[u] && r_kind[u] == kDead;
      const unsigned m = __ballot_sync(0xffffffffu, dead);
      if (dead) d.subj[base + __popc(m & ((1u << lane) - 1u))] = r_subject[u];
      base += __popc(m);
    }
    if (lane == 0) d.n = base;
  }
  __syncthreads();
}

__device__ __forceinline__ int8_t status_of(int64_t i,
                                            const uint8_t* __restrict__ member,
                                            const uint8_t* __restrict__ cdead,
                                            const uint8_t* __restrict__ cleft,
                                            const DeadSubjects& d) {
  if (cleft[i] || !member[i]) return kLeft;
  if (cdead[i]) return kFailed;
  for (int j = 0; j < d.n; ++j) {
    if (d.subj[j] == i) return kFailed;
  }
  return kAlive;
}

__global__ void __launch_bounds__(kThreads) members_scan_kernel(
    const uint8_t* __restrict__ member, const uint8_t* __restrict__ cdead,
    const uint8_t* __restrict__ cleft, const uint8_t* __restrict__ r_active,
    const int8_t* __restrict__ r_kind, const int32_t* __restrict__ r_subject,
    int U, const uint8_t* __restrict__ prov, const int8_t* __restrict__ prev,
    int64_t N, int8_t* __restrict__ status, int32_t* __restrict__ counts,
    int32_t* __restrict__ block_changed) {
  __shared__ DeadSubjects d;
  __shared__ u64 red[kCounts][32];
  load_dead(r_active, r_kind, r_subject, U, d);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  u64 v[kCounts] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;  // warp-contiguous
    if (i < N) {
      const int8_t st = status_of(i, member, cdead, cleft, d);
      if (status != nullptr) status[i] = st;
      if (prov == nullptr || prov[i]) {
        v[0] += st == kAlive;
        v[1] += st == kFailed;
        v[2] += st == kLeft;
        v[3] += 1;
        if (prev != nullptr) v[4] += st != prev[i];
      }
    }
  }
  block_sum<kCounts>(v, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kCounts; ++k) {
      if (red[k][0] != 0) atomicAdd(&counts[k], static_cast<int>(red[k][0]));
    }
    if (block_changed != nullptr) {
      block_changed[blockIdx.x] = static_cast<int32_t>(red[4][0]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) members_emit_kernel(
    const int8_t* __restrict__ status, const int8_t* __restrict__ prev,
    const uint8_t* __restrict__ prov, const int32_t* __restrict__ block_changed,
    int64_t N, int64_t k, int32_t* __restrict__ idx,
    int8_t* __restrict__ state) {
  __shared__ u64 red[2][32];
  __shared__ int32_t warp_total[kThreads / 32];
  const int64_t b = blockIdx.x, B = gridDim.x;
  // changed members of the tiles before this one, and of all tiles
  u64 v[2] = {0, 0};
  for (int64_t j = threadIdx.x; j < B; j += kThreads) {
    const u64 c = static_cast<u64>(block_changed[j]);
    v[1] += c;
    if (j < b) v[0] += c;
  }
  block_sum<2>(v, red);
  const int64_t prefix = static_cast<int64_t>(red[0][0]);
  const int64_t total = static_cast<int64_t>(red[1][0]);
  // the pad rows, spread over the grid
  const int8_t pad_state = status[0];
  for (int64_t r = total + b * kThreads + threadIdx.x; r < k;
       r += B * kThreads) {
    idx[r] = -1;
    state[r] = pad_state;
  }
  if (block_changed[b] == 0 || prefix >= k) return;  // block-uniform
  const int64_t i0 = b * kTile + static_cast<int64_t>(threadIdx.x) * kPer;
  bool changed[kPer];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = i0 + j;
    changed[j] = i < N && prov[i] && status[i] != prev[i];
    mine += changed[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_total[w];
  int64_t rank = prefix + before + incl - mine;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (changed[j]) {
      if (rank < k) {
        idx[rank] = static_cast<int32_t>(i0 + j);
        state[rank] = status[i0 + j];
      }
      ++rank;
    }
  }
}

__global__ void __launch_bounds__(kThreads) members_page_kernel(
    const int32_t* __restrict__ ids, int64_t K,
    const uint8_t* __restrict__ member, const uint8_t* __restrict__ cdead,
    const uint8_t* __restrict__ cleft, const uint8_t* __restrict__ r_active,
    const int8_t* __restrict__ r_kind, const int32_t* __restrict__ r_subject,
    int U, const int32_t* __restrict__ incarnation,
    const uint8_t* __restrict__ up, int64_t N, int8_t* __restrict__ st_out,
    int32_t* __restrict__ inc_out, uint8_t* __restrict__ up_out) {
  __shared__ DeadSubjects d;
  load_dead(r_active, r_kind, r_subject, U, d);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < K; j += stride) {
    int64_t i = ids[j];
    if (i < 0) i += N;
    i = i < 0 ? 0 : (i >= N ? N - 1 : i);
    st_out[j] = status_of(i, member, cdead, cleft, d);
    inc_out[j] = incarnation[i];
    up_out[j] = up[i];
  }
}

inline int64_t tiles(int64_t N) { return (N + kTile - 1) / kTile; }

}  // namespace

extern "C" int members_scan(const void* member, const void* committed_dead,
                            const void* committed_left, const void* r_active,
                            const void* r_kind, const void* r_subject, int U,
                            const void* provisioned, const void* prev,
                            int64_t N, void* status, void* counts,
                            void* block_changed, void* stream) {
  if (N < 1 || N >= (1ll << 31) || U < 1 || U > 64 || counts == nullptr ||
      (prev != nullptr && (status == nullptr || block_changed == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  members_scan_kernel<<<static_cast<unsigned>(tiles(N)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(committed_dead),
      static_cast<const uint8_t*>(committed_left),
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject), U,
      static_cast<const uint8_t*>(provisioned),
      static_cast<const int8_t*>(prev), N, static_cast<int8_t*>(status),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(block_changed));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int members_emit(const void* status, const void* prev,
                            const void* provisioned, const void* block_changed,
                            int64_t N, int64_t k, void* idx, void* state,
                            void* stream) {
  if (N < 1 || N >= (1ll << 31) || k < 1 || k >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  members_emit_kernel<<<static_cast<unsigned>(tiles(N)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(status), static_cast<const int8_t*>(prev),
      static_cast<const uint8_t*>(provisioned),
      static_cast<const int32_t*>(block_changed), N, k,
      static_cast<int32_t*>(idx), static_cast<int8_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int members_page(const void* ids, int64_t K, const void* member,
                            const void* committed_dead,
                            const void* committed_left, const void* r_active,
                            const void* r_kind, const void* r_subject, int U,
                            const void* incarnation, const void* up, int64_t N,
                            void* st_out, void* inc_out, void* up_out,
                            void* stream) {
  if (N < 1 || N >= (1ll << 31) || K < 1 || U < 1 || U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks = (K + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  members_page_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), K, static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(committed_dead),
      static_cast<const uint8_t*>(committed_left),
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject), U,
      static_cast<const int32_t*>(incarnation), static_cast<const uint8_t*>(up),
      N, static_cast<int8_t*>(st_out), static_cast<int32_t*>(inc_out),
      static_cast<uint8_t*>(up_out));
  return static_cast<int>(cudaGetLastError());
}
