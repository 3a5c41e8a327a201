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
// A node's int8 status comes from member, committed_dead and
// committed_left and the subjects of the [U] table's active dead rumors:
// left wins over failed, and a node that is not a member is left; a dead
// rumor's subject in [-N, 0) marks node subject + N and one outside
// [-N, N) marks nothing (JAX's scatter wraps a negative index once and
// drops the rest).
//
// Three launches:
//   members_scan   a block per tile of kTile nodes.  The first warp reads
//                  the [U] table in one round (lane = slot) and sets, for
//                  each dead subject inside the tile, one bit of a shared
//                  bitmap of the tile.  Each thread takes kPer
//                  consecutive nodes with one 16-byte load each of
//                  member, committed_dead, committed_left, provisioned
//                  and prev, issued together with the table's, and
//                  computes their statuses from the bytes with byte masks
//                  (stored as one 16-byte store when asked), and over
//                  provisioned nodes the counts by status, the total and
//                  the number whose status differs from `prev`, by
//                  popcounts.  Each block writes its changed count to
//                  block_changed[b] and adds each count, with one share
//                  of the grid above kShareShift, to its word of a
//                  per-device scratch (one atomic a count, its old value
//                  returned): the block whose add completes a total's
//                  shares writes the total into counts and zeroes the
//                  word, and the block that completes the changed total
//                  turns block_changed into the tiles' inclusive prefix
//                  of changed counts, once.  No fill, no done count.
//   members_emit   the same tiles: block b reads its prefix before and
//                  after its tile and the total (three words), writes its
//                  share of the pad rows, and, only if its tile holds a
//                  changed node and the prefix before it is below k,
//                  ranks its tile's changed flags (16-byte loads, a thread
//                  kPer nodes; warp shuffles, then the warps' totals) and
//                  writes idx[rank] = i, state[rank] = status[i] for ranks
//                  below k: the ascending first k, as the JAX top-k over
//                  the 0/1 mask returns them.  Ranks from n_changed to k
//                  get idx -1 and state status[0] (swim.py:1558-1559
//                  reads st[max(idx, 0)]).
//   members_page   a thread per requested id: the first warp compacts the
//                  table's dead subjects into shared memory while each
//                  thread loads its id; then the five leaves at the id
//                  (member, committed_dead, committed_left, incarnation,
//                  up) load together and the dead test runs against the
//                  shared list: two rounds of memory trips.  Ids are
//                  wrapped once when negative and clamped into [0, N) as
//                  a JAX gather does.
//
// Blocks (a node-sharded pool, parallel/mesh.py): the scan and the emit
// run per block over its L rows (L a multiple of kTile at full width),
// the dead subjects and the emitted ids global (row0 the block's first
// row).  Each block's scan writes its own [5] counts, which
// members_combine adds in block order; each block's emit reads every
// block's changed count to rank its rows after the earlier blocks', so
// the blocks' emits together write the ascending first k, the order
// swim._top_k_sharded keeps.  The page reads the five node leaves
// through block tables (common.cuh:BlockRows).  The one-device launches
// are B = 1.
//
// Bound on an H100: memory, and at N = 1M launch cost.  The scan must read
// member, committed_dead, committed_left and provisioned (4 bytes a node),
// plus prev and the status write for a delta (6); the emit reads status,
// prev and provisioned only in tiles that hold a changed member.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                 // nodes a thread: a 16-byte load a leaf
constexpr int kTile = kThreads * kPer;   // nodes a block, scan and emit alike
constexpr int kDead = 2;                 // swim.DEAD
constexpr int kCounts = 5;               // alive, failed, left, total, changed
constexpr int kShareShift = 40;          // a total's word: shares << 40 | count
constexpr uint32_t kOnes = 0x01010101u;  // one 1 a byte

// 16 bytes at p + i .. i + 15 as four words: one vector load when the
// bytes lie inside N and p is 16-byte aligned, else byte by byte (0
// beyond N).
__device__ __forceinline__ uint4 load16(const uint8_t* p, int64_t i, int64_t N, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + i));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (i + b < N) w[b >> 2] |= static_cast<uint32_t>(p[i + b]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The bytes of the nodes inside N among i .. i + 15: 1 each.
__device__ __forceinline__ uint4 in_range(int64_t i, int64_t N) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (i + b < N) w[b >> 2] |= 1u << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void words(const uint4 v, uint32_t (&w)[4]) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// Four bits as four 0/1 bytes (bit b to byte b).
__device__ __forceinline__ uint32_t bytes_of(uint32_t bits4) {
  return (bits4 * 0x00204081u) & kOnes;
}

// The statuses of four nodes from their member, committed_dead and
// committed_left bytes and their dead-rumor bits: 2 left, 1 failed, 0.
__device__ __forceinline__ uint32_t status4(uint32_t mem, uint32_t cd, uint32_t cl,
                                            uint32_t dead) {
  const uint32_t left = (cl | (mem ^ kOnes)) & kOnes;
  const uint32_t failed = (cd | dead) & ~left & kOnes;
  return (left << 1) | failed;
}

struct ScanArgs {
  const uint8_t* member;
  const uint8_t* cdead;
  const uint8_t* cleft;
  const uint8_t* r_active;
  const int8_t* r_kind;
  const int32_t* r_subject;
  int U;
  const uint8_t* prov;   // null: every node
  const uint8_t* prev;   // null: no changed count
  int64_t N;             // the launch's nodes, from global row row0
  int64_t row0;
  int64_t Ng;            // the pool's nodes (the dead subjects' range)
  int aligned;           // every [N] vector 16-byte aligned
  uint8_t* status;       // null: not written
  int32_t* counts;
  int32_t* block_changed;
  u64* scratch;          // the five totals, each with its blocks' shares
};

__global__ void __launch_bounds__(kThreads) members_scan_kernel(ScanArgs a) {
  __shared__ uint32_t s_dead[kTile / 32];
  __shared__ u64 red[kCounts][32];
  __shared__ int32_t warp_tot[kThreads / 32];
  __shared__ bool prefix;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t i0 = base + static_cast<int64_t>(t) * kPer;
  const bool vec = a.aligned && i0 + kPer <= a.N;

  // one round of loads: the table (first warp) and the thread's 16 nodes
  int32_t subj[2] = {-1, -1};
  if (t < 32) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int u = lane + 32 * p;
      if (u < a.U) {  // the three loads together, no short circuit between
        const bool active = a.r_active[u];
        const int8_t kind = a.r_kind[u];
        const int64_t s = wrapped(a.r_subject[u], a.Ng);
        subj[p] = active && kind == kDead && s >= 0 && s < a.Ng ? static_cast<int32_t>(s) : -1;
      }
    }
  }
  uint32_t mem[4], cd[4], cl[4], pv[4], pr[4];
  words(load16(a.member, i0, a.N, vec), mem);
  words(load16(a.cdead, i0, a.N, vec), cd);
  words(load16(a.cleft, i0, a.N, vec), cl);
  words(a.prov != nullptr ? load16(a.prov, i0, a.N, vec)
                          : (vec ? make_uint4(kOnes, kOnes, kOnes, kOnes) : in_range(i0, a.N)),
        pv);
  if (a.prov != nullptr && !vec) {  // the bytes beyond N count nowhere
    uint32_t r[4];
    words(in_range(i0, a.N), r);
#pragma unroll
    for (int w = 0; w < 4; ++w) pv[w] &= r[w];
  }
  if (a.prev != nullptr) words(load16(a.prev, i0, a.N, vec), pr);

  // the tile's dead subjects as a bitmap
  if (t < kTile / 32) s_dead[t] = 0;
  __syncthreads();
  if (t < 32) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int64_t off = static_cast<int64_t>(subj[p]) - (a.row0 + base);
      if (subj[p] >= 0 && off >= 0 && off < kTile) {
        atomicOr(&s_dead[off >> 5], 1u << (off & 31));
      }
    }
  }
  __syncthreads();
  const uint32_t dead16 = (s_dead[t >> 1] >> (16 * (t & 1))) & 0xffffu;

  u64 v[kCounts] = {0, 0, 0, 0, 0};
  uint32_t st[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    st[w] = status4(mem[w], cd[w], cl[w], bytes_of((dead16 >> (4 * w)) & 0xfu));
    const uint32_t failed = st[w] & kOnes, left = (st[w] >> 1) & kOnes;
    v[0] += __popc(~(failed | left) & pv[w] & kOnes);
    v[1] += __popc(failed & pv[w]);
    v[2] += __popc(left & pv[w]);
    v[3] += __popc(pv[w] & kOnes);
    if (a.prev != nullptr) v[4] += __popc(__vcmpne4(st[w], pr[w]) & pv[w] & kOnes);
  }
  if (a.status != nullptr) {
    if (vec) {
      *reinterpret_cast<uint4*>(a.status + i0) = make_uint4(st[0], st[1], st[2], st[3]);
    } else {
      for (int b = 0; b < kPer && i0 + b < a.N; ++b) {
        a.status[i0 + b] = static_cast<uint8_t>(st[b >> 2] >> (8 * (b & 3)));
      }
    }
  }
  block_sum<kCounts>(v, red);
  // each total's scratch word counts the blocks' shares above kShareShift:
  // the block whose add completes a total writes it and zeroes the word
  if (t == 4 && a.block_changed != nullptr) {
    a.block_changed[blockIdx.x] = static_cast<int32_t>(red[4][0]);
    __threadfence();
  }
  if (t < kCounts) {
    const u64 add = (1ull << kShareShift) | red[t][0];
    const u64 old = atomicAdd(&a.scratch[t], add);
    const bool completes = (old >> kShareShift) == static_cast<u64>(gridDim.x) - 1;
    if (completes) {
      a.counts[t] = static_cast<int32_t>((old + add) & ((1ull << kShareShift) - 1));
      a.scratch[t] = 0;  // ready for the next launch
    }
    if (t == 4) prefix = completes && a.block_changed != nullptr;
  }
  __syncthreads();
  if (!prefix) return;  // block-uniform

  // the block that completed the changed total: the tiles' inclusive prefix
  __threadfence();
  const int64_t B = gridDim.x;
  int32_t carry = 0;
  for (int64_t c0 = 0; c0 < B; c0 += kThreads) {
    const int64_t j = c0 + t;
    const int32_t x = j < B ? __ldcg(&a.block_changed[j]) : 0;
    int32_t incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int32_t before = carry, all = carry;
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? warp_tot[w] : 0;
      all += warp_tot[w];
    }
    if (j < B) a.block_changed[j] = before + incl;
    carry = all;
    __syncthreads();  // warp_tot is written again
  }
}

__global__ void __launch_bounds__(kThreads) members_emit_kernel(
    const uint8_t* __restrict__ status, const uint8_t* __restrict__ prev,
    const uint8_t* __restrict__ prov, const int32_t* __restrict__ prefix,
    const int32_t* __restrict__ blk_counts, int n_blk, int blk, int64_t row0,
    const uint8_t* __restrict__ pad_status, int pads,
    int64_t N, int64_t k, int aligned, int32_t* __restrict__ idx,
    int8_t* __restrict__ state) {
  __shared__ int32_t warp_total[kThreads / 32];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x, B = gridDim.x;
  // the changed rows of the earlier blocks of the pool, and of all of them
  int64_t earlier = 0, total = 0;
  for (int c = 0; c < n_blk; ++c) {
    const int64_t x = blk_counts[c * kCounts + 4];
    earlier += c < blk ? x : 0;
    total += x;
  }
  const int64_t before = earlier + (b > 0 ? prefix[b - 1] : 0);
  const int64_t upto = earlier + prefix[b];
  const int8_t pad_state = static_cast<int8_t>(*pad_status);  // with the prefix's loads
  // the pad rows, spread over the grid of the launch that writes them
  if (pads && total + b * kThreads < k) {
    for (int64_t r = total + b * kThreads + t; r < k; r += B * kThreads) {
      idx[r] = -1;
      state[r] = pad_state;
    }
  }
  if (upto == before || before >= k) return;  // block-uniform
  const int64_t i0 = b * kTile + static_cast<int64_t>(t) * kPer;
  const bool vec = aligned && i0 + kPer <= N;
  uint32_t st[4], pr[4], pv[4], ch[4];
  words(load16(status, i0, N, vec), st);
  words(load16(prev, i0, N, vec), pr);
  words(load16(prov, i0, N, vec), pv);
  int mine = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    ch[w] = __vcmpne4(st[w], pr[w]) & pv[w] & kOnes;
    mine += __popc(ch[w]);
  }
  const int lane = t & 31, warp = t >> 5;
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int below = 0;
  for (int w = 0; w < warp; ++w) below += warp_total[w];
  int64_t rank = before + below + incl - mine;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    for (uint32_t m = ch[w]; m != 0 && rank < k; m &= m - 1, ++rank) {
      const int byte = (__ffs(m) - 1) >> 3;
      idx[rank] = static_cast<int32_t>(row0 + i0 + 4 * w + byte);
      state[rank] = static_cast<int8_t>(st[w] >> (8 * byte));
    }
  }
}

// The B blocks' [5] counts added in block order.
__global__ void members_combine_kernel(const int32_t* __restrict__ blk_counts, int B,
                                       int32_t* __restrict__ counts) {
  const int t = threadIdx.x;
  if (t >= kCounts) return;
  int32_t sum = 0;
  for (int b = 0; b < B; ++b) sum += blk_counts[b * kCounts + t];
  counts[t] = sum;
}

__global__ void __launch_bounds__(kThreads) members_page_kernel(
    const int32_t* __restrict__ ids, int64_t K,
    const __grid_constant__ BlockRows<uint8_t> member,
    const __grid_constant__ BlockRows<uint8_t> cdead,
    const __grid_constant__ BlockRows<uint8_t> cleft,
    const uint8_t* __restrict__ r_active,
    const int8_t* __restrict__ r_kind, const int32_t* __restrict__ r_subject,
    int U, const __grid_constant__ BlockRows<int32_t> incarnation,
    const __grid_constant__ BlockRows<uint8_t> up, int64_t N,
    int8_t* __restrict__ st_out,
    int32_t* __restrict__ inc_out, uint8_t* __restrict__ up_out) {
  __shared__ int32_t s_subj[64];
  __shared__ int s_n;
  const int t = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  int64_t id = j < K ? ids[j] : 0;  // issued with the table's round
  if (t < 32) {
    int n = 0;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int u = t + 32 * p;
      bool dead = false;
      int32_t s = 0;
      if (u < U) {  // the three loads together, no short circuit between
        const bool active = r_active[u];
        const int8_t kind = r_kind[u];
        const int64_t w = wrapped(r_subject[u], N);
        dead = active && kind == kDead && w >= 0 && w < N;
        s = static_cast<int32_t>(w);
      }
      const unsigned m = __ballot_sync(0xffffffffu, dead);
      if (dead) s_subj[n + __popc(m & ((1u << t) - 1u))] = s;
      n += __popc(m);
    }
    if (t == 0) s_n = n;
  }
  __syncthreads();
  const int n_dead = s_n;
  for (; j < K; j += stride) {
    int64_t i = id;
    if (i < 0) i += N;
    i = i < 0 ? 0 : (i >= N ? N - 1 : i);
    const bool mem = member.at(i) != 0, cd = cdead.at(i) != 0, cl = cleft.at(i) != 0;
    const int32_t inc = incarnation.at(i);
    const uint8_t u = up.at(i);
    bool dead = false;
    for (int d = 0; d < n_dead; ++d) dead |= s_subj[d] == i;
    st_out[j] = cl || !mem ? 2 : (cd || dead ? 1 : 0);
    inc_out[j] = inc;
    up_out[j] = u;
    if (j + stride < K) id = ids[j + stride];
  }
}

inline int64_t tiles(int64_t N) { return (N + kTile - 1) / kTile; }

inline bool aligned_or_null(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// scratch: kCounts zeroed u64, a word a total (the block that completes a
// total zeroes its word again).  With prev, status and block_changed are
// required; block_changed [tiles(N)] comes back as the tiles' inclusive
// prefix of changed counts, members_emit's input.  The launch covers the N
// nodes from global row row0 of a pool of Ng (a block of a sharded pool,
// or row0 = 0 and Ng = N); counts are that span's.
extern "C" int members_scan(const void* member, const void* committed_dead,
                            const void* committed_left, const void* r_active,
                            const void* r_kind, const void* r_subject, int U,
                            const void* provisioned, const void* prev,
                            int64_t N, int64_t row0, int64_t Ng, void* status,
                            void* counts, void* block_changed, void* scratch,
                            void* stream) {
  if (N < 1 || Ng >= (1ll << 31) || row0 < 0 || row0 + N > Ng || U < 1 || U > 64 ||
      counts == nullptr || scratch == nullptr ||
      (prev != nullptr && (status == nullptr || block_changed == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int aligned = aligned_or_null(member) && aligned_or_null(committed_dead) &&
                      aligned_or_null(committed_left) && aligned_or_null(provisioned) &&
                      aligned_or_null(prev) && aligned_or_null(status);
  const ScanArgs a{static_cast<const uint8_t*>(member),
                   static_cast<const uint8_t*>(committed_dead),
                   static_cast<const uint8_t*>(committed_left),
                   static_cast<const uint8_t*>(r_active),
                   static_cast<const int8_t*>(r_kind),
                   static_cast<const int32_t*>(r_subject), U,
                   static_cast<const uint8_t*>(provisioned),
                   static_cast<const uint8_t*>(prev), N, row0, Ng, aligned,
                   static_cast<uint8_t*>(status), static_cast<int32_t*>(counts),
                   static_cast<int32_t*>(block_changed), static_cast<u64*>(scratch)};
  members_scan_kernel<<<static_cast<unsigned>(tiles(N)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The emit of the N nodes from global row row0: block_changed is their
// scan's prefix, blk_counts the [n_blk * 5] counts of every block of the
// pool (this span's at blk; one device: the scan's counts, n_blk = 1),
// pad_status the status of node 0 (the pad rows' state), and the launch
// with pads != 0 writes the pad rows.
extern "C" int members_emit(const void* status, const void* prev,
                            const void* provisioned, const void* block_changed,
                            const void* blk_counts, int n_blk, int blk,
                            int64_t row0, const void* pad_status, int pads,
                            int64_t N, int64_t k, void* idx, void* state,
                            void* stream) {
  if (N < 1 || N >= (1ll << 31) || k < 1 || k >= (1ll << 31) || n_blk < 1 ||
      blk < 0 || blk >= n_blk || row0 < 0 || blk_counts == nullptr ||
      pad_status == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int aligned = aligned_or_null(status) && aligned_or_null(prev) && aligned_or_null(provisioned);
  members_emit_kernel<<<static_cast<unsigned>(tiles(N)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(status), static_cast<const uint8_t*>(prev),
      static_cast<const uint8_t*>(provisioned),
      static_cast<const int32_t*>(block_changed),
      static_cast<const int32_t*>(blk_counts), n_blk, blk, row0,
      static_cast<const uint8_t*>(pad_status), pads, N, k, aligned,
      static_cast<int32_t*>(idx), static_cast<int8_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

// counts [5] = the [B * 5] block counts added in block order.
extern "C" int members_combine(const void* blk_counts, int B, void* counts,
                               void* stream) {
  if (B < 1 || blk_counts == nullptr || counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  members_combine_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blk_counts), B, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// member, committed_dead, committed_left, incarnation and up are host
// arrays of B block base pointers, L nodes a block (one device: B = 1).
extern "C" int members_page(const void* ids, int64_t K, const void* member,
                            const void* committed_dead,
                            const void* committed_left, const void* r_active,
                            const void* r_kind, const void* r_subject, int U,
                            const void* incarnation, const void* up, int B,
                            int64_t L, void* st_out, void* inc_out,
                            void* up_out, void* stream) {
  const int64_t N = static_cast<int64_t>(B) * L;
  if (B < 1 || B > kMaxBlocks || L < 1 || N >= (1ll << 31) || K < 1 || U < 1 ||
      U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks = (K + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  members_page_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), K, block_rows<uint8_t>(member, B, L),
      block_rows<uint8_t>(committed_dead, B, L),
      block_rows<uint8_t>(committed_left, B, L),
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject), U,
      block_rows<int32_t>(incarnation, B, L), block_rows<uint8_t>(up, B, L),
      N, static_cast<int8_t*>(st_out), static_cast<int32_t*>(inc_out),
      static_cast<uint8_t*>(up_out));
  return static_cast<int>(cudaGetLastError());
}
