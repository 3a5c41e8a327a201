// K6 reconcile: the anti-entropy set reconciliation — the diff of the
// agents' desired table against the catalog, and the merge of the pushed
// rows into the catalog after the dropped rows are compacted out.
//
// Replaces: consul_tpu/ops/reconcile.py diff_sorted (two searchsorted
// joins) and apply_push, consul_tpu/models/antientropy.py step's masks of
// the diff by the due agents (:133-134), its drop compaction (a stable
// argsort) and _merge_push (a lexsort of the M + K rows, which XLA runs
// as two stable sorts, and a second stable argsort that moves the
// de-duplicated rows to the tail).  Both tables are already id-sorted, so
// both kernels walk their merge instead of sorting or searching per row.
//
// Preconditions (the wrappers in ops/reconcile.py state them, the plain
// twin checks them): in each table the valid ids (not kInvalid) are
// unique and ascending and the kInvalid rows form the tail.  So a valid
// id's match in the other table, if any, is its neighbour in the merge of
// the two tables' ids, ties ordered desired (src) first: the row right
// after a desired row, the row right before a catalog row.
//
// Merge paths (Odeh et al., "Merge Path", IPDPSW 2012): diagonal d of the
// merge splits it after the first d rows, split(d) of them from the
// desired table.  A tile of merged rows finds its two splits with a warp
// each (32 probes a round: 4 rounds of loads at 2^20 rows, not a 21-step
// search a row) and copies its two runs into shared memory with 16-byte
// cp.async copies.  A halo row on each side (the desired row before the
// run, the catalog row after it) covers a pair that a split separates.
//
// reconcile_diff   one launch, a block per 3,840 merged rows: each thread
//                  splits its 15 merged rows inside the runs by a binary
//                  search in shared memory and walks them, the current
//                  row of each run in a register: a valid src row matches
//                  the dst row after it in the merge, which is then a hit
//                  (the run's first dst row also by the src halo row).
//                  A src row is pushed when it is valid and unmatched or
//                  its match holds another version (versions read for
//                  matches alone); a dst row is dropped when it is valid
//                  and no hit.  push and drop are written four rows to a
//                  32-bit store where the four share an aligned word of
//                  the block's run.  The step's form (due, d_node, a_node
//                  given) writes push & due[d_node] and drop &
//                  due[a_node], reading a node only where the plain mask
//                  is set.
// reconcile_merge  one cooperative launch on a persistent grid of
//                  512-thread blocks, each owning a contiguous diagonal
//                  range (one 8,192-row tile when the grid covers the
//                  merge, as at 2^21 rows; else a loop of tiles).
//   phase 1  each tile's rows take a class and a rank among the tile's
//            rows of that class (rank_tile): a desired row is a union row
//            when it is pushed and valid, else unpushed; a catalog row is
//            not kept (INVALID or under drop), a duplicate (the pushed
//            desired row of its id, found by that row's search of the
//            catalog run, or the halo row), else a union row.  Ranks
//            come from ballots a warp and 32 rows over contiguous
//            segments; a pushed row's union rank adds the union catalog
//            rows below its id, a union catalog row's the pushed rows
//            below its id.  The block writes its four class counts.
//   grid barrier
//   phase 2  every block reads every block's counts (a 16-byte load a
//            block: the blocks are few and large), giving the totals W
//            (union), D, M - P and each class's base after the blocks
//            before it, and writes each row of its tile to its slot, a
//            thread a row in index order (ranks kept in shared memory
//            across the barrier; a block of more tiles ranks each again):
//              [0, W)            the union, ascending (in merge order),
//                                a pushed row's payload winning over the
//                                catalog's;
//              [W, W + D)        the catalog copies of pushed ids, as
//                                kInvalid rows, ascending by their id;
//              [W + D, W + D + M - P)  the desired rows not pushed, as
//                                kInvalid rows, in index order;
//              then the catalog rows not kept (dropped, then the kInvalid
//              tail), in index order; cut at K.
//            This is what the lexsort by (id, source) and the stable
//            partitions of the JAX code leave, tail payloads included:
//            each class is a subsequence of the merge order.  Its scratch
//            (four counts a block) is written before the barrier and read
//            after it; no word needs a reset.
//
// Bound on an H100: memory.  The diff must read both tables' ids, the
// versions of the ids present in both, and write the two masks (about 9
// bytes a row); the merge in step's form must read three int32 columns
// and a mask on each side and write three columns of K rows (38 bytes a
// row at M = K).  What holds them above it: the split searches (4 rounds
// of device-memory latency before a tile's copies start), the walk's and
// the ranks' chains in shared memory, and the merge's barrier between
// its phases.
//
// Built with -DMERGE_PHASE_TIMES (build.variant; chip_smoke.py's K6
// phases), the merge stamps %globaltimer into its scratch after the
// counts (u64 words 2 * scratch_blocks ..; the caller zeroes them): 0
// block 0's start, then the latest block at 1 the end of phase 1, 2 its
// bases after the barrier, 3 its end.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace consul_kernels;
namespace cg = cooperative_groups;

namespace {

constexpr int32_t kInvalid = 0x7fffffff;

constexpr int kDiffThreads = 256;
// merged rows a thread: odd, so that the threads of a warp, whose walks
// start about items / 2 rows apart in each run, fall on different banks
constexpr int kDiffItems = 15;
constexpr int kDiffTile = kDiffThreads * kDiffItems;     // merged rows a block
constexpr int kMergeThreads = 512;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeTile = 8192;                         // merged rows a tile
constexpr int kClasses = 4;
// the classes of a merge row, in the order of their output ranges
constexpr int kUnion = 0, kDup = 1, kUnpushed = 2, kNotKept = 3;

// --- merge paths -----------------------------------------------------------

// split(d) of the merge of the sorted a [M] and b [K], ties a first: the i
// in [max(0, d - K), min(d, M)] with a[q] <= b[d - q - 1] exactly for the
// q < i.  One warp, every lane calling it, the result in every lane: each
// round the 32 lanes probe the range at 32 points, and the range shrinks
// to the part between the last probe that holds and the first that fails
// (2^20 rows: 4 rounds of loads, not 21; more probes a round cost more
// than the round they save, each a sector read from device memory).
__device__ int64_t warp_split(const int32_t* __restrict__ a, int64_t M,
                              const int32_t* __restrict__ b, int64_t K, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > K ? d - K : 0;
  int64_t hi = d < M ? d : M;
  while (hi - lo > 32) {  // warp-uniform
    const int64_t q = lo + (hi - lo) * (lane + 1) / 33;
    const bool before = __ldg(a + q) <= __ldg(b + (d - q - 1));
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    const int64_t q_true = __shfl_sync(0xffffffffu, q, c > 0 ? c - 1 : 0);
    const int64_t q_false = __shfl_sync(0xffffffffu, q, c < 32 ? c : 31);
    if (c > 0) lo = q_true + 1;
    if (c < 32) hi = q_false;
  }
  const int64_t q = lo + lane;
  const bool before = q < hi && __ldg(a + q) <= __ldg(b + (d - q - 1));
  return lo + __popc(__ballot_sync(0xffffffffu, before));
}

// Warps 0 and 1 find split(d0) and split(d1) at once into out[0], out[1]
// (every thread of the block calls it; the block is synchronized after).
__device__ __forceinline__ void tile_splits(const int32_t* a, int64_t M, const int32_t* b,
                                            int64_t K, int64_t d0, int64_t d1, int64_t* out) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t i = warp_split(a, M, b, K, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) out[warp] = i;
  }
  __syncthreads();
}

// A tile's ids in shared memory: its desired (src) run sa(x) = buf[oa +
// x] and its catalog (dst) run sb(y) = buf[ob + y].
struct Ids {
  const int32_t* buf;
  int oa, ob;
  __device__ __forceinline__ int32_t a(int x) const { return buf[oa + x]; }
  __device__ __forceinline__ int32_t b(int y) const { return buf[ob + y]; }
};

// split(p) of the tile's runs, sa [na] and sb [nb], by one thread.
__device__ __forceinline__ int tile_split(const Ids& t, int na, int nb, int p) {
  int lo = p > nb ? p - nb : 0, hi = p < na ? p : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.a(mid) <= t.b(p - mid - 1)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The catalog rows of the tile's run sb [nb] whose ids are below v.
__device__ __forceinline__ int lower_bound_b(const Ids& t, int nb, int32_t v) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.b(mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Queues the copy of rows [lo, hi) of the table g [n] into shared s so
// that s[r - base] = g[r], returning base: the first row of the 16-byte
// vector that holds row lo.  A whole vector inside the table is one
// 16-byte cp.async; the rows of lo's and hi's vectors outside [lo, hi)
// are copied too where they exist.  s is 16-byte aligned with room for
// run_extent(base, hi) elements; g is aligned to its element.  The caller
// waits with copies_done.
template <typename E>
__device__ int64_t copy_run(E* s, const E* __restrict__ g, int64_t lo, int64_t hi,
                            int64_t n) {
  constexpr int V = 16 / sizeof(E);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) / sizeof(E)) % V);
  const int64_t base = lo - (lo + mis) % V;
  const int64_t vecs = hi > lo ? (hi - base + V - 1) / V : 0;
  for (int64_t v = threadIdx.x; v < vecs; v += blockDim.x) {
    const int64_t r = base + v * V;
    if (r >= 0 && r + V <= n) {
      cp_async16(s + v * V, g + r);
    } else {
      for (int e = 0; e < V; ++e) {
        if (r + e >= 0 && r + e < n) s[v * V + e] = g[r + e];
      }
    }
  }
  return base;
}

// Elements a copy_run of rows [lo, hi) fills from base.
template <typename E>
__device__ __forceinline__ int run_extent(int64_t base, int64_t hi) {
  constexpr int V = 16 / sizeof(E);
  return hi > base ? static_cast<int>((hi - base + V - 1) / V * V) : 0;
}

// The block's copies are in shared memory and visible to every thread.
__device__ __forceinline__ void copies_done() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// due[node] for an owning agent in [0, n); false outside it.
__device__ __forceinline__ bool due_at(const uint8_t* due, int64_t n, int32_t node) {
  return node >= 0 && node < n && due[node] != 0;
}

// Bytes out[r] for the rows r in [lo, hi), four rows a 32-bit store where
// the four fill one aligned word inside [lo, hi), a byte store at the
// run's ragged ends (bytes there may belong to another block's run).
// rows4(r, v) fills v[0..3] for rows r .. r + 3 (rows outside [lo, hi)
// included: it must not read past the tables for them).
template <typename F>
__device__ void store_bytes(uint8_t* out, int64_t lo, int64_t hi, F rows4) {
  if (hi <= lo) return;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(out) & 3);
  const int64_t base = lo - ((lo + mis) & 3);
  const int64_t words = (hi - base + 3) >> 2;
  for (int64_t w = threadIdx.x; w < words; w += blockDim.x) {
    const int64_t r = base + 4 * w;
    uint32_t v[4];
    rows4(r, v);
    if (r >= lo && r + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(out + r) = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
    } else {
      for (int e = 0; e < 4; ++e) {
        if (r + e >= lo && r + e < hi) out[r + e] = static_cast<uint8_t>(v[e]);
      }
    }
  }
}

// --- reconcile_diff ----------------------------------------------------------

struct DiffArgs {
  const int32_t* src_ids;
  const int32_t* src_ver;
  const int32_t* dst_ids;
  const int32_t* dst_ver;
  const uint8_t* due;       // [n_due], or null (the plain form)
  const int32_t* d_node;    // [M] with due
  const int32_t* a_node;    // [K] with due
  int64_t n_due, M, K;
  uint8_t* push;            // [M]
  uint8_t* drop;            // [K]
};

__global__ void __launch_bounds__(kDiffThreads) diff_kernel(DiffArgs a) {
  // the two runs, each from a 16-byte boundary with one halo row
  __shared__ __align__(16) int32_t ids[kDiffTile + 16];
  // a src row's match in the dst run (its index there, -1 for none) at x;
  // a dst row's hit flag at kDiffTile - 1 - y (the two ends never meet)
  __shared__ int32_t part[kDiffTile];
  __shared__ int64_t split[2];
  const int64_t N = a.M + a.K;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kDiffTile;
  const int64_t d1 = d0 + kDiffTile < N ? d0 + kDiffTile : N;
  tile_splits(a.src_ids, a.M, a.dst_ids, a.K, d0, d1, split);
  const int64_t i0 = split[0], i1 = split[1];
  const int64_t j0 = d0 - i0, j1 = d1 - i1;
  const int na = static_cast<int>(i1 - i0), nb = static_cast<int>(j1 - j0);

  // src rows [i0 - 1, i1) (the halo row before the run), then dst rows
  // [j0, j1 + 1) (the halo row after it)
  const int64_t lo_a = i0 > 0 ? i0 - 1 : 0;
  const int64_t base_a = copy_run(ids, a.src_ids, lo_a, i1, a.M);
  const int eb = run_extent<int32_t>(base_a, i1);
  const int64_t hi_b = j1 < a.K ? j1 + 1 : a.K;
  const int64_t base_b = copy_run(ids + eb, a.dst_ids, j0, hi_b, a.K);
  int32_t* hit_b = part + (kDiffTile - 1);     // hit_b[-y]
  for (int y = threadIdx.x; y < nb; y += blockDim.x) hit_b[-y] = 0;
  copies_done();
  const Ids t{ids, static_cast<int>(i0 - base_a), eb + static_cast<int>(j0 - base_b)};
  const int32_t after_b = j1 < a.K ? t.b(nb) : kInvalid;
  // a dst row at the run's start matched by the src halo row
  if (threadIdx.x == 0 && i0 > 0 && nb > 0 && t.b(0) != kInvalid && t.a(-1) == t.b(0)) {
    hit_b[0] = 1;
  }

  // the thread's merged rows, the current row of each run in a register:
  // a src row matches the dst row after it, which then matches too
  const int nt = na + nb;
  const int p0 = threadIdx.x * kDiffItems;
  if (p0 < nt) {
    int x = tile_split(t, na, nb, p0);
    int y = p0 - x;
    int32_t a_cur = x < na ? t.a(x) : 0;
    int32_t b_cur = y < nb ? t.b(y) : 0;
    const int p1 = p0 + kDiffItems < nt ? p0 + kDiffItems : nt;
    for (int p = p0; p < p1; ++p) {
      if (y >= nb || (x < na && a_cur <= b_cur)) {
        const int32_t next = y < nb ? b_cur : after_b;
        const bool hit = a_cur != kInvalid && a_cur == next;
        part[x] = hit ? y : -1;
        if (hit && y < nb) hit_b[-y] = 1;
        ++x;
        a_cur = x < na ? t.a(x) : 0;
      } else {
        ++y;
        b_cur = y < nb ? t.b(y) : 0;
      }
    }
  }
  __syncthreads();

  // the masks, four rows a thread: their loads issued together, versions
  // read for the src rows that match alone
  const bool step = a.due != nullptr;
  store_bytes(a.push, i0, i1, [&](int64_t r, uint32_t (&v)[4]) {
    int y[4];
    int32_t sv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = static_cast<int>(r + e - i0);
      const bool in = x >= 0 && x < na;
      y[e] = in && t.a(x) != kInvalid ? part[x] : -2;   // -2: no row, or kInvalid
      sv[e] = y[e] >= 0 ? __ldg(a.src_ver + r + e) : 0;
      dv[e] = y[e] >= 0 ? __ldg(a.dst_ver + (j0 + y[e])) : 0;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool p = y[e] == -1 || (y[e] >= 0 && sv[e] != dv[e]);
      if (p && step) p = due_at(a.due, a.n_due, __ldg(a.d_node + r + e));
      v[e] = p;
    }
  });
  store_bytes(a.drop, j0, j1, [&](int64_t r, uint32_t (&v)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int y = static_cast<int>(r + e - j0);
      bool q = y >= 0 && y < nb && t.b(y) != kInvalid && !hit_b[-y];
      if (q && step) q = due_at(a.due, a.n_due, __ldg(a.a_node + r + e));
      v[e] = q;
    }
  });
}

// --- reconcile_merge ---------------------------------------------------------

struct MergeArgs {
  const int32_t* d_ids;
  const int32_t* d_ver;
  const int32_t* d_node;    // null with a_node and out_node (apply_push)
  const uint8_t* push;
  const int32_t* a_ids;
  const int32_t* a_ver;
  const int32_t* a_node;
  const uint8_t* drop;      // or null (apply_push)
  int64_t M, K;
  uint4* counts;            // kClasses 32-bit counts a block
  u64* stamps;              // the instrumented build's phase stamps
  int32_t* out_ids;
  int32_t* out_ver;
  int32_t* out_node;
};

// The merge's dynamic shared memory: a tile's ids, a word per merged row
// (its class and its place among the tile's rows of that class), the
// push and drop flags of its runs, the catalog rows below each pushed
// desired row's id (in push order), and for each catalog row (and one
// past) a duplicate bit, then the tile's union catalog rows before it.
constexpr int kMergeIds = kMergeTile + 16;
constexpr int kMergeSlots = kMergeTile;
constexpr int kMergeFlags = kMergeTile + 64;
constexpr int kMergeLbs = kMergeTile;
constexpr int kMergeCats = kMergeTile + 8;
constexpr size_t kMergeSmem =
    4 * (kMergeIds + kMergeSlots) + kMergeFlags + 2 * (kMergeLbs + kMergeCats);
constexpr uint16_t kDupBit = 0x8000u;

// A tile in shared memory: desired rows [i0, i1) with the halo row i0 - 1
// (t.a(-1), fa[-1], present when i0 > 0), catalog rows [j0, j1).
struct Tile {
  int64_t i0, j0;
  int na, nb;
  Ids t;
  const uint8_t* fa;        // push
  const uint8_t* fb;        // drop, or null
};

__device__ __forceinline__ Tile load_tile(const MergeArgs& a, int32_t* ids, uint8_t* flags,
                                          int64_t d0, int64_t d1, int64_t i0, int64_t i1) {
  Tile r;
  const int64_t j0 = d0 - i0, j1 = d1 - i1;
  r.i0 = i0;
  r.j0 = j0;
  r.na = static_cast<int>(i1 - i0);
  r.nb = static_cast<int>(j1 - j0);
  const int64_t lo_a = i0 > 0 ? i0 - 1 : 0;
  const int64_t base_a = copy_run(ids, a.d_ids, lo_a, i1, a.M);
  const int eb = run_extent<int32_t>(base_a, i1);
  const int64_t base_b = copy_run(ids + eb, a.a_ids, j0, j1, a.K);
  r.t = Ids{ids, static_cast<int>(i0 - base_a), eb + static_cast<int>(j0 - base_b)};
  const int64_t fbase_a = copy_run(flags, a.push, lo_a, i1, a.M);
  uint8_t* fbuf_b = flags + run_extent<uint8_t>(fbase_a, i1);
  r.fa = flags + (i0 - fbase_a);
  r.fb = nullptr;
  if (a.drop != nullptr) {
    const int64_t fbase_b = copy_run(fbuf_b, a.drop, j0, j1, a.K);
    r.fb = fbuf_b + (j0 - fbase_b);
  }
  copies_done();
  return r;
}

__device__ __forceinline__ bool pushed_a(const Tile& r, int x) {
  return r.fa[x] != 0 && r.t.a(x) != kInvalid;
}

__device__ __forceinline__ bool kept_b(const Tile& r, int y) {
  return r.t.b(y) != kInvalid && !(r.fb != nullptr && r.fb[y] != 0);
}

// A pushed desired row's catalog row of the same id, inside the tile's
// catalog run and kept: that row is a duplicate.  (Its match past the
// run is the next tile's first catalog row, which that tile finds from
// its halo row.)
__device__ __forceinline__ bool dup_at(const Tile& r, int x, int lb) {
  return lb < r.nb && r.t.b(lb) == r.t.a(x) && kept_b(r, lb);
}

// The tile's first catalog row, a duplicate of the halo row before it.
__device__ __forceinline__ bool halo_dup(const Tile& r) {
  return r.i0 > 0 && r.nb > 0 && r.fa[-1] != 0 && r.t.a(-1) == r.t.b(0) && kept_b(r, 0);
}

// A warp's contiguous segment [lo, hi) of rows [0, n): whole 32-row
// chunks, the warps in order.
__device__ __forceinline__ void segment(int n, int& lo, int& hi) {
  const int seg = ((n + 31) / 32 + kMergeWarps - 1) / kMergeWarps * 32;
  lo = static_cast<int>(threadIdx.x >> 5) * seg;
  hi = lo + seg < n ? lo + seg : n;
}

// Each warp's sums of K counts (in every lane) become its exclusive
// offsets over the warps in off, and tot the block's totals.  Every
// thread calls it; it synchronizes.
template <int K>
__device__ __forceinline__ void warp_offsets(const uint32_t (&sum)[2],
                                             uint32_t (&warp_tot)[kMergeWarps][2],
                                             uint32_t (&tot)[2], uint32_t (&off)[2]) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) warp_tot[warp][k] = sum[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    uint32_t acc = 0;
    for (int w = 0; w < kMergeWarps; ++w) {
      const uint32_t v = warp_tot[w][threadIdx.x];
      warp_tot[w][threadIdx.x] = acc;
      acc += v;
    }
    tot[threadIdx.x] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) off[k] = warp_tot[warp][k];
}

// The entries of the sorted lbs [n] at most y: a pass over a few, else a
// binary search.
__device__ __forceinline__ uint32_t upper_bound_lbs(const uint16_t* lbs, int n, int y) {
  if (n <= 8) {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) c += i < n && lbs[i] <= y;
    return c;
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lbs[mid] <= y) lo = mid + 1; else hi = mid;
  }
  return lo;
}


struct TileCounts {
  int pushed, kept, dups;
};

// Each row of the tile gets its class and its place among the tile's rows
// of that class, in slots (desired row x at x, catalog row y at na + y):
// a desired row not pushed has its place in index order; a pushed one
// finds the catalog rows below its id (lbs, in push order) and marks the
// catalog row of its id a duplicate; a kept catalog row's union rank adds
// the pushed rows below it, and a pushed row's the union catalog rows
// below it.  Every thread calls it.
__device__ __forceinline__ TileCounts rank_tile(const Tile& r, uint32_t* slots,
                                                uint16_t* lbs, uint16_t* cat,
                                                uint32_t* masks,
                                                uint32_t (&warp_tot)[kMergeWarps][2],
                                                uint32_t (&tot)[2]) {
  const int na = r.na, nb = r.nb;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  TileCounts n;
  int lo, hi;
  // desired rows, a ballot of pushed rows per 32 (kept in masks)
  segment(na, lo, hi);
  uint32_t sums[2] = {0, 0};
  for (int base = lo; base < hi; base += 32) {
    const int x = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, x < hi && pushed_a(r, x));
    if (lane == 0) masks[base >> 5] = m;
    sums[0] += __popc(m);
  }
  for (int y = threadIdx.x; y <= nb; y += blockDim.x) cat[y] = 0;
  uint32_t off[2];
  warp_offsets<1>(sums, warp_tot, tot, off);
  n.pushed = static_cast<int>(tot[0]);
  uint32_t run = off[0];
  for (int base = lo; base < hi; base += 32) {
    const unsigned m = masks[base >> 5];
    const uint32_t before = run + __popc(m & below);
    run += __popc(m);
    const int x = base + lane;
    if (x >= hi) continue;
    if ((m >> lane) & 1u) {
      const int lb = lower_bound_b(r.t, nb, r.t.a(x));
      lbs[before] = static_cast<uint16_t>(lb);
      if (dup_at(r, x, lb)) cat[lb] = kDupBit;
      slots[x] = before;
    } else {
      slots[x] = kUnpushed << 16 | (x - before);
    }
  }
  if (threadIdx.x == 0 && halo_dup(r)) cat[0] = kDupBit;
  __syncthreads();
  // catalog rows, ballots of kept rows and of duplicates per 32
  segment(nb, lo, hi);
  sums[0] = 0;
  for (int base = lo; base < hi; base += 32) {
    const int y = base + lane;
    const bool in = y < hi;
    const unsigned mk = __ballot_sync(0xffffffffu, in && kept_b(r, y));
    const unsigned md = __ballot_sync(0xffffffffu, in && (cat[y] & kDupBit) != 0);
    if (lane == 0) {
      masks[2 * (base >> 5)] = mk;
      masks[2 * (base >> 5) + 1] = md;
    }
    sums[0] += __popc(mk);
    sums[1] += __popc(md);
  }
  warp_offsets<2>(sums, warp_tot, tot, off);
  n.kept = static_cast<int>(tot[0]);
  n.dups = static_cast<int>(tot[1]);
  uint32_t run_k = off[0], run_d = off[1];
  for (int base = lo; base < hi; base += 32) {
    const unsigned mk = masks[2 * (base >> 5)], md = masks[2 * (base >> 5) + 1];
    const uint32_t kept_before = run_k + __popc(mk & below);
    const uint32_t dups_before = run_d + __popc(md & below);
    run_k += __popc(mk);
    run_d += __popc(md);
    const int y = base + lane;
    if (y >= hi) continue;
    // a kept catalog row's union rank adds the pushed rows below it
    const uint32_t unions = kept_before - dups_before;
    if (!((mk >> lane) & 1u)) {
      slots[na + y] = kNotKept << 16 | (y - kept_before);
    } else if ((md >> lane) & 1u) {
      slots[na + y] = kDup << 16 | dups_before;
    } else {
      slots[na + y] = kUnion << 16 | (unions + upper_bound_lbs(lbs, n.pushed, y));
    }
    cat[y] = static_cast<uint16_t>(unions);
  }
  if (threadIdx.x == 0) cat[nb] = static_cast<uint16_t>(n.kept - n.dups);
  __syncthreads();
  // a pushed desired row's union rank adds the union catalog rows below
  for (int x = threadIdx.x; x < na; x += blockDim.x) {
    if (pushed_a(r, x)) {
      const uint32_t rank = slots[x];
      slots[x] = kUnion << 16 | (rank + cat[lbs[rank]]);
    }
  }
  __syncthreads();
  return n;
}

#ifdef MERGE_PHASE_TIMES
__device__ __forceinline__ void stamp(u64* stamps, int k) {
  __syncthreads();
  if (threadIdx.x == 0 && (k > 0 || blockIdx.x == 0)) {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(stamps + k, t);
  }
}
#else
__device__ __forceinline__ void stamp(u64*, int) {}
#endif

__global__ void __launch_bounds__(kMergeThreads, 2) merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* ids = reinterpret_cast<int32_t*>(smem);  // 16-byte aligned, as the flags
  uint32_t* slots = reinterpret_cast<uint32_t*>(ids + kMergeIds);
  uint8_t* flags = reinterpret_cast<uint8_t*>(slots + kMergeSlots);
  uint16_t* lbs = reinterpret_cast<uint16_t*>(flags + kMergeFlags);
  uint16_t* cat = lbs + kMergeLbs;
  __shared__ int64_t split[2];
  __shared__ u64 red8[2 * kClasses][32];
  __shared__ uint32_t warp_tot[kMergeWarps][2];
  __shared__ uint32_t tile_tot[2];
  __shared__ uint32_t masks[2 * kMergeTile / 32 + 2 * kMergeWarps];
  cg::grid_group grid = cg::this_grid();
  stamp(a.stamps, 0);
  const int64_t N = a.M + a.K;
  const int64_t per = (N + gridDim.x - 1) / gridDim.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per < N
                            ? static_cast<int64_t>(blockIdx.x) * per : N;
  const int64_t end = begin + per < N ? begin + per : N;
  const int64_t tiles = (end - begin + kMergeTile - 1) / kMergeTile;

  // 1. each tile's rows ranked within it, and the block's class counts:
  // union = pushed + kept - duplicates, duplicates, unpushed = desired
  // rows - pushed, not kept = catalog rows - kept
  u64 c4[kClasses] = {0, 0, 0, 0};
  Tile r{};
  for (int64_t s = 0; s < tiles; ++s) {
    const int64_t d0 = begin + s * kMergeTile;
    const int64_t d1 = d0 + kMergeTile < end ? d0 + kMergeTile : end;
    tile_splits(a.d_ids, a.M, a.a_ids, a.K, d0, d1, split);
    r = load_tile(a, ids, flags, d0, d1, split[0], split[1]);
    const TileCounts n = rank_tile(r, slots, lbs, cat, masks, warp_tot, tile_tot);
    c4[kUnion] += n.pushed + n.kept - n.dups;
    c4[kDup] += n.dups;
    c4[kUnpushed] += r.na - n.pushed;
    c4[kNotKept] += r.nb - n.kept;
  }
  if (threadIdx.x == 0) {  // the counts are the same in every thread
    a.counts[blockIdx.x] = make_uint4(
        static_cast<uint32_t>(c4[0]), static_cast<uint32_t>(c4[1]),
        static_cast<uint32_t>(c4[2]), static_cast<uint32_t>(c4[3]));
  }
  stamp(a.stamps, 1);
  grid.sync();

  // 2. the classes' bases from every block's counts (a 16-byte load a
  // block): the union, the duplicates, the desired rows not pushed, the
  // catalog rows not kept, each after the blocks before this one
  u64 v8[2 * kClasses] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    const uint4 c = __ldcg(&a.counts[b]);
    const uint32_t cs[kClasses] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < kClasses; ++k) {
      v8[kClasses + k] += cs[k];
      if (b < blockIdx.x) v8[k] += cs[k];
    }
  }
  block_sum<2 * kClasses>(v8, red8);
  const int64_t W = static_cast<int64_t>(red8[kClasses + kUnion][0]);
  const int64_t D = static_cast<int64_t>(red8[kClasses + kDup][0]);
  const int64_t Q = static_cast<int64_t>(red8[kClasses + kUnpushed][0]);
  int64_t run0 = static_cast<int64_t>(red8[kUnion][0]);
  int64_t run1 = W + static_cast<int64_t>(red8[kDup][0]);
  int64_t run2 = W + D + static_cast<int64_t>(red8[kUnpushed][0]);
  int64_t run3 = W + D + Q + static_cast<int64_t>(red8[kNotKept][0]);
  stamp(a.stamps, 2);

  const bool nodes = a.out_node != nullptr;
  for (int64_t s = 0; s < tiles; ++s) {
    if (tiles > 1) {  // one tile stays in shared memory across the barrier
      const int64_t d0 = begin + s * kMergeTile;
      const int64_t d1 = d0 + kMergeTile < end ? d0 + kMergeTile : end;
      tile_splits(a.d_ids, a.M, a.a_ids, a.K, d0, d1, split);
      r = load_tile(a, ids, flags, d0, d1, split[0], split[1]);
    }
    // a block with more tiles ranks each again (one tile keeps its ranks
    // in shared memory across the barrier)
    const TileCounts n = tiles > 1 ? rank_tile(r, slots, lbs, cat, masks, warp_tot, tile_tot)
                                   : TileCounts{0, 0, 0};
    // then every row to its slot, a thread a row in index order (its
    // payload reads coalesced; writing in slot order instead, through an
    // inverse of the ranks, measured slower)
    auto write = [&](int k, const int32_t* ver, const int32_t* node, int64_t row,
                     int32_t id) {
      const uint32_t word = slots[k];
      const uint32_t c = word >> 16;
      const int64_t slot = (c == kUnion ? run0 : c == kDup ? run1 : c == kUnpushed ? run2
                                                                                   : run3)
                           + (word & 0xffff);
      if (slot >= a.K) return;
      a.out_ids[slot] = c == kUnion ? id : kInvalid;
      a.out_ver[slot] = __ldg(ver + row);
      if (nodes) a.out_node[slot] = __ldg(node + row);
    };
    for (int x = threadIdx.x; x < r.na; x += blockDim.x) {
      write(x, a.d_ver, a.d_node, r.i0 + x, r.t.a(x));
    }
    for (int y = threadIdx.x; y < r.nb; y += blockDim.x) {
      write(r.na + y, a.a_ver, a.a_node, r.j0 + y, r.t.b(y));
    }
    if (tiles > 1) {
      run0 += n.pushed + n.kept - n.dups;
      run1 += n.dups;
      run2 += r.na - n.pushed;
      run3 += r.nb - n.kept;
      __syncthreads();
    }
  }
  stamp(a.stamps, 3);
}

bool sizes_ok(int64_t M, int64_t K) {
  return M >= 1 && K >= 1 && M < (int64_t{1} << 31) && K < (int64_t{1} << 31);
}

}  // namespace

// The diff; due, d_node and a_node come together (the step's form, due
// [n_due] bool, n_due >= 1) or are all null (the plain form).
extern "C" int reconcile_diff(const void* src_ids, const void* src_ver,
                              const void* dst_ids, const void* dst_ver,
                              int64_t M, int64_t K, const void* due,
                              const void* d_node, const void* a_node,
                              int64_t n_due, void* push, void* drop,
                              void* stream) {
  if (!sizes_ok(M, K)) return static_cast<int>(cudaErrorInvalidValue);
  const bool step = due != nullptr;
  if ((d_node != nullptr) != step || (a_node != nullptr) != step ||
      (step && n_due < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiffArgs a;
  a.src_ids = static_cast<const int32_t*>(src_ids);
  a.src_ver = static_cast<const int32_t*>(src_ver);
  a.dst_ids = static_cast<const int32_t*>(dst_ids);
  a.dst_ver = static_cast<const int32_t*>(dst_ver);
  a.due = static_cast<const uint8_t*>(due);
  a.d_node = static_cast<const int32_t*>(d_node);
  a.a_node = static_cast<const int32_t*>(a_node);
  a.n_due = n_due;
  a.M = M;
  a.K = K;
  a.push = static_cast<uint8_t*>(push);
  a.drop = static_cast<uint8_t*>(drop);
  const int64_t blocks = (M + K + kDiffTile - 1) / kDiffTile;
  diff_kernel<<<static_cast<unsigned>(blocks), kDiffThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The merge, one cooperative launch.  scratch (16-byte aligned;
// kernels.MERGE_SCRATCH): kClasses 32-bit counts for each of
// scratch_blocks blocks (written before the barrier, read after it: no
// reset needed), then 4 u64 phase stamps (the instrumented build's).  d_node, a_node and out_node come together or not at all; drop
// may be null (apply_push).
extern "C" int reconcile_merge(const void* d_ids, const void* d_ver,
                               const void* d_node, const void* push,
                               const void* a_ids, const void* a_ver,
                               const void* a_node, const void* drop,
                               int64_t M, int64_t K, void* scratch,
                               int64_t scratch_blocks, void* out_ids,
                               void* out_ver, void* out_node, void* stream) {
  if (!sizes_ok(M, K) || scratch_blocks < 1 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool nodes = d_node != nullptr;
  if ((a_node != nullptr) != nodes || (out_node != nullptr) != nodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MergeArgs a;
  a.d_ids = static_cast<const int32_t*>(d_ids);
  a.d_ver = static_cast<const int32_t*>(d_ver);
  a.d_node = static_cast<const int32_t*>(d_node);
  a.push = static_cast<const uint8_t*>(push);
  a.a_ids = static_cast<const int32_t*>(a_ids);
  a.a_ver = static_cast<const int32_t*>(a_ver);
  a.a_node = static_cast<const int32_t*>(a_node);
  a.drop = static_cast<const uint8_t*>(drop);
  a.M = M;
  a.K = K;
  a.counts = static_cast<uint4*>(scratch);
  a.stamps = static_cast<u64*>(scratch) + 2 * scratch_blocks;
  a.out_ids = static_cast<int32_t*>(out_ids);
  a.out_ver = static_cast<int32_t*>(out_ver);
  a.out_node = static_cast<int32_t*>(out_node);
  static PerCard per_card;
  if (per_card.here() == 0) {  // the attribute is the current card's
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMergeSmem)));
    if (rc != 0) return rc;
  }
  const int cap = scratch_blocks < (int64_t{1} << 30) ? static_cast<int>(scratch_blocks)
                                                      : (1 << 30);
  // no more blocks than tiles
  const int blocks = persistent_blocks(merge_kernel, kMergeThreads,
                                       (M + K + kMergeTile - 1) / kMergeTile * kMergeThreads,
                                       cap, per_card, kMergeSmem);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(merge_kernel), dim3(blocks), dim3(kMergeThreads),
      args, kMergeSmem, static_cast<cudaStream_t>(stream)));
}
