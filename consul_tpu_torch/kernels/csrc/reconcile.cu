// K6 reconcile: the anti-entropy set reconciliation — the diff of the
// agents' desired table against the catalog, and the merge of the pushed
// rows into the catalog after the dropped rows are compacted out.
//
// Replaces: consul_tpu/ops/reconcile.py diff_sorted (two searchsorted
// joins) and apply_push, and consul_tpu/models/antientropy.py step's
// drop compaction (a stable argsort) followed by _merge_push (a lexsort of
// the M + K rows, which XLA runs as two stable sorts, and a second stable
// argsort that moves the de-duplicated rows to the tail).  Both tables are
// already id-sorted, so each row's place in the output follows from its
// own rank and one binary search into the other table: no sort is needed.
//
// Preconditions (the wrappers in ops/reconcile.py state them, the plain
// twin checks them): in each table the valid ids (not kInvalid) are
// unique and ascending and the kInvalid rows form the tail.
//
// reconcile_diff   one launch, a thread per row of either table: a src row
//                  finds the lower bound of its id in dst (clipped to
//                  K - 1, as the clip in reconcile.py:40) and is pushed
//                  when its id is valid and missing or at another
//                  version; a dst row is dropped when its valid id is
//                  missing from src.
// reconcile_merge  three launches behind one entry point.
//   count    a block per tile of kTile rows of either table: a candidate
//            row (of the M desired rows) is pushed when push is set and
//            its id valid, and a duplicate when its id is also in the
//            kept catalog (binary search); a catalog row is kept when its
//            id is valid and drop (if given) is not set.  Each block
//            writes its rows' exclusive in-tile ranks (pushed and
//            duplicate counts packed in 16 bits each) and its totals.
//   scan     one block: exclusive prefix sums of the tiles' totals, and
//            the grand totals P (pushed), D (duplicates), V (kept).
//   scatter  the count kernel's grid: every row computes its output slot
//            from its rank and one binary search into the other table,
//            and rows whose slot is below K write their id and payload.
//            With W = P + V - D merged ids, the output is:
//              [0, W)            the union of pushed and kept ids,
//                                ascending, a pushed row's payload
//                                winning over the catalog's;
//              [W, W + D)        the catalog copies of pushed ids, as
//                                kInvalid rows, ascending by their id;
//              [W + D, W + D + M - P)  the desired rows not pushed, as
//                                kInvalid rows, in index order;
//              then the catalog rows not kept (dropped, then the kInvalid
//              tail), in index order; cut at K.
//            This is what the lexsort by (id, source) and the stable
//            partitions of the JAX code leave, tail payloads included.
//
// Bound on an H100: memory.  The diff must read both tables' ids and
// versions and write the two masks (9 bytes a row); the merge in step's
// form must read three int32 columns and a mask on each side and write
// three columns of K rows (38 bytes a row at M = K).  The binary searches
// (21 steps at 2^21 rows) hit L2 on their upper levels; the count
// kernel's ranks and the scatter's reads of them are extra traffic of 8
// bytes a row, which a decoupled look-back scan (one pass) would remove.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kTile = 256;          // rows a block, one a thread
constexpr int kScanThreads = 1024;
constexpr int32_t kInvalid = 0x7fffffff;

// The first index in sorted a[0, n) whose value is >= x.
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a,
                                               int64_t n, int32_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kTile) diff_kernel(
    const int32_t* __restrict__ src_ids, const int32_t* __restrict__ src_ver,
    const int32_t* __restrict__ dst_ids, const int32_t* __restrict__ dst_ver,
    int64_t M, int64_t K, uint8_t* __restrict__ push,
    uint8_t* __restrict__ drop) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i < M) {
    const int32_t x = src_ids[i];
    int64_t pos = lower_bound(dst_ids, K, x);
    if (pos > K - 1) pos = K - 1;
    const bool valid = x != kInvalid;
    const bool hit = valid && __ldg(dst_ids + pos) == x;
    const bool stale = hit && __ldg(dst_ver + pos) != src_ver[i];
    push[i] = valid && (!hit || stale);
  } else if (i < M + K) {
    const int64_t j = i - M;
    const int32_t y = dst_ids[j];
    int64_t pos = lower_bound(src_ids, M, y);
    if (pos > M - 1) pos = M - 1;
    const bool valid = y != kInvalid;
    drop[j] = valid && __ldg(src_ids + pos) != y;
  }
}

// Exclusive block-wide scan of v over kTile threads; *total gets the sum.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* total) {
  __shared__ int32_t warp_sums[kTile / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kTile / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kTile / 32; off <<= 1) {
      const int32_t t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < kTile / 32) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int32_t before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kTile / 32 - 1];
  return before + inc - v;
}

struct MergeScratch {
  int32_t* cand_loc;   // [M] in-tile exclusive ranks: pushed | dup << 16
  int32_t* keep_loc;   // [K] in-tile exclusive ranks of kept rows
  int32_t* cand_tot;   // [Bm] tile totals, packed as cand_loc
  int32_t* keep_tot;   // [Bk]
  int32_t* push_off;   // [Bm] exclusive prefix over tiles
  int32_t* dup_off;    // [Bm]
  int32_t* keep_off;   // [Bk]
  int32_t* totals;     // [4]: P, D, V
  uint8_t* flags;      // [M] bit 0 pushed, bit 1 duplicate
};

__device__ __forceinline__ bool kept(const int32_t* a_ids, const uint8_t* drop,
                                     int64_t k) {
  return a_ids[k] != kInvalid && !(drop != nullptr && drop[k]);
}

__global__ void __launch_bounds__(kTile) merge_count_kernel(
    const int32_t* __restrict__ d_ids, const uint8_t* __restrict__ push,
    const int32_t* __restrict__ a_ids, const uint8_t* __restrict__ drop,
    int64_t M, int64_t K, int64_t Bm, MergeScratch sc) {
  const int64_t b = blockIdx.x;
  int32_t total;
  if (b < Bm) {
    const int64_t i = b * kTile + threadIdx.x;
    int32_t packed = 0;
    if (i < M) {
      const int32_t x = d_ids[i];
      const bool pushed = push[i] && x != kInvalid;
      bool dup = false;
      if (pushed) {
        const int64_t pos = lower_bound(a_ids, K, x);
        dup = pos < K && __ldg(a_ids + pos) == x && kept(a_ids, drop, pos);
      }
      sc.flags[i] = static_cast<uint8_t>(pushed | (dup << 1));
      packed = static_cast<int32_t>(pushed) | (static_cast<int32_t>(dup) << 16);
    }
    const int32_t ex = block_exclusive_scan(packed, &total);
    if (i < M) sc.cand_loc[i] = ex;
    if (threadIdx.x == 0) sc.cand_tot[b] = total;
  } else {
    const int64_t k = (b - Bm) * kTile + threadIdx.x;
    const int32_t keep = k < K && kept(a_ids, drop, k);
    const int32_t ex = block_exclusive_scan(keep, &total);
    if (k < K) sc.keep_loc[k] = ex;
    if (threadIdx.x == 0) sc.keep_tot[b - Bm] = total;
  }
}

// Exclusive prefix sums of n tile totals into out (field f of each packed
// total: bits [16 f, 16 f + 16), or the whole word for f < 0); returns the
// grand total in thread 0.  One block of kScanThreads; each thread sums a
// run of consecutive tiles, the runs' sums are scanned, then each run is
// written.
__device__ int64_t scan_tiles(const int32_t* __restrict__ tot, int64_t n,
                              int f, int32_t* __restrict__ out) {
  __shared__ int64_t sums[kScanThreads];
  auto field = [&](int64_t t) -> int64_t {
    const int32_t w = tot[t];
    return f < 0 ? w : (w >> (16 * f)) & 0xffff;
  };
  const int64_t run = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * run;
  const int64_t hi = lo + run < n ? lo + run : n;
  int64_t s = 0;
  for (int64_t t = lo; t < hi; ++t) s += field(t);
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // Hillis-Steele
    const int64_t add = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += add;
    __syncthreads();
  }
  int64_t acc = sums[threadIdx.x] - s;  // exclusive
  for (int64_t t = lo; t < hi; ++t) {
    out[t] = static_cast<int32_t>(acc);
    acc += field(t);
  }
  const int64_t grand = sums[kScanThreads - 1];
  __syncthreads();  // sums is reused by the next call
  return grand;
}

__global__ void __launch_bounds__(kScanThreads) merge_scan_kernel(
    int64_t Bm, int64_t Bk, MergeScratch sc) {
  const int64_t P = scan_tiles(sc.cand_tot, Bm, 0, sc.push_off);
  const int64_t D = scan_tiles(sc.cand_tot, Bm, 1, sc.dup_off);
  const int64_t V = scan_tiles(sc.keep_tot, Bk, -1, sc.keep_off);
  if (threadIdx.x == 0) {
    sc.totals[0] = static_cast<int32_t>(P);
    sc.totals[1] = static_cast<int32_t>(D);
    sc.totals[2] = static_cast<int32_t>(V);
  }
}

__global__ void __launch_bounds__(kTile) merge_scatter_kernel(
    const int32_t* __restrict__ d_ids, const int32_t* __restrict__ d_ver,
    const int32_t* __restrict__ d_node, const int32_t* __restrict__ a_ids,
    const int32_t* __restrict__ a_ver, const int32_t* __restrict__ a_node,
    const uint8_t* __restrict__ drop, int64_t M, int64_t K, int64_t Bm,
    MergeScratch sc, int32_t* __restrict__ out_ids,
    int32_t* __restrict__ out_ver, int32_t* __restrict__ out_node) {
  const int64_t P = sc.totals[0], D = sc.totals[1], V = sc.totals[2];
  const int64_t W = P + V - D;
  // global exclusive counts before row p of each table (p may be the end)
  auto pushed_before = [&](int64_t p) -> int64_t {
    return p >= M ? P : sc.push_off[p / kTile] + (sc.cand_loc[p] & 0xffff);
  };
  auto dups_before = [&](int64_t p) -> int64_t {
    return p >= M ? D : sc.dup_off[p / kTile] + (sc.cand_loc[p] >> 16);
  };
  auto kept_before = [&](int64_t p) -> int64_t {
    return p >= K ? V : sc.keep_off[p / kTile] + sc.keep_loc[p];
  };
  const int64_t b = blockIdx.x;
  int64_t slot;
  int32_t id, ver, node = 0;
  if (b < Bm) {
    const int64_t i = b * kTile + threadIdx.x;
    if (i >= M) return;
    const int64_t before = pushed_before(i);
    if (sc.flags[i] & 1) {
      id = d_ids[i];
      slot = before + kept_before(lower_bound(a_ids, K, id)) - dups_before(i);
    } else {
      id = kInvalid;
      slot = W + D + (i - before);
    }
    ver = d_ver[i];
    if (out_node != nullptr) node = d_node[i];
  } else {
    const int64_t k = (b - Bm) * kTile + threadIdx.x;
    if (k >= K) return;
    const int32_t y = a_ids[k];
    const int64_t before = kept_before(k);
    if (kept(a_ids, drop, k)) {
      const int64_t pos = lower_bound(d_ids, M, y);
      const bool dup = pos < M && __ldg(d_ids + pos) == y && (sc.flags[pos] & 1);
      if (dup) {
        id = kInvalid;
        slot = W + dups_before(pos);
      } else {
        id = y;
        slot = before + pushed_before(pos) - dups_before(pos);
      }
    } else {
      id = kInvalid;
      slot = W + D + (M - P) + (k - before);
    }
    ver = a_ver[k];
    if (out_node != nullptr) node = a_node[k];
  }
  if (slot >= K) return;
  out_ids[slot] = id;
  out_ver[slot] = ver;
  if (out_node != nullptr) out_node[slot] = node;
}

int64_t tiles(int64_t n) { return (n + kTile - 1) / kTile; }

bool sizes_ok(int64_t M, int64_t K) {
  return M >= 1 && K >= 1 && M < (int64_t{1} << 31) && K < (int64_t{1} << 31);
}

}  // namespace

extern "C" int reconcile_diff(const void* src_ids, const void* src_ver,
                              const void* dst_ids, const void* dst_ver,
                              int64_t M, int64_t K, void* push, void* drop,
                              void* stream) {
  if (!sizes_ok(M, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = tiles(M + K);
  diff_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_ids), static_cast<const int32_t*>(src_ver),
      static_cast<const int32_t*>(dst_ids), static_cast<const int32_t*>(dst_ver),
      M, K, static_cast<uint8_t*>(push), static_cast<uint8_t*>(drop));
  return static_cast<int>(cudaGetLastError());
}

// scratch: scratch_bytes >= 4 (M + K + 3 Bm + 2 Bk + 4) + M bytes, 4-byte
// aligned (Bm, Bk = tiles of kTile rows; kernels.merge_scratch_bytes).
// d_node, a_node and out_node come together or not at all; drop may be
// null (apply_push).
extern "C" int reconcile_merge(const void* d_ids, const void* d_ver,
                               const void* d_node, const void* push,
                               const void* a_ids, const void* a_ver,
                               const void* a_node, const void* drop,
                               int64_t M, int64_t K, void* scratch,
                               int64_t scratch_bytes, void* out_ids,
                               void* out_ver, void* out_node, void* stream) {
  if (!sizes_ok(M, K)) return static_cast<int>(cudaErrorInvalidValue);
  const bool nodes = d_node != nullptr;
  if ((a_node != nullptr) != nodes || (out_node != nullptr) != nodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t Bm = tiles(M), Bk = tiles(K);
  const int64_t words = M + K + 3 * Bm + 2 * Bk + 4;
  if (scratch_bytes < 4 * words + M ||
      (reinterpret_cast<uintptr_t>(scratch) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* w = static_cast<int32_t*>(scratch);
  MergeScratch sc;
  sc.cand_loc = w; w += M;
  sc.keep_loc = w; w += K;
  sc.cand_tot = w; w += Bm;
  sc.keep_tot = w; w += Bk;
  sc.push_off = w; w += Bm;
  sc.dup_off = w; w += Bm;
  sc.keep_off = w; w += Bk;
  sc.totals = w; w += 4;
  sc.flags = reinterpret_cast<uint8_t*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* di = static_cast<const int32_t*>(d_ids);
  const auto* ai = static_cast<const int32_t*>(a_ids);
  const auto* dr = static_cast<const uint8_t*>(drop);
  const auto grid = static_cast<unsigned>(Bm + Bk);
  merge_count_kernel<<<grid, kTile, 0, s>>>(
      di, static_cast<const uint8_t*>(push), ai, dr, M, K, Bm, sc);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  merge_scan_kernel<<<1, kScanThreads, 0, s>>>(Bm, Bk, sc);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  merge_scatter_kernel<<<grid, kTile, 0, s>>>(
      di, static_cast<const int32_t*>(d_ver),
      static_cast<const int32_t*>(d_node), ai,
      static_cast<const int32_t*>(a_ver), static_cast<const int32_t*>(a_node),
      dr, M, K, Bm, sc, static_cast<int32_t*>(out_ids),
      static_cast<int32_t*>(out_ver), static_cast<int32_t*>(out_node));
  return static_cast<int>(cudaGetLastError());
}
