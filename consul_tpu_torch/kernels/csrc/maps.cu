// K9 subject_maps: the four [N] subject-indexed maps of the rumor table,
// built once a probe tick, and their incremental updates (map_add after
// each origination, maps_convert after each suspect -> dead conversion).
//
// Replaces: consul_tpu/models/swim.py _subject_map/_maps, _map_add and
// _maps_convert, which XLA runs as [U] -> [N] scatter-max/min reductions
// into a fresh -1 vector (four for _maps, one for _map_add, two for
// _maps_convert): slots outside the mask scatter -1 (max) or 1 << 30 (min)
// into index 0.
//
// subject_maps, one launch: block b owns the contiguous nodes [b * kRange,
// (b + 1) * kRange), kRange a multiple of 4.  In its prelude warp 0 reads
// the <= 64-entry table once (a lane a slot, two ballots) and lists in
// shared memory the active entries whose subject falls in the block's
// range, with their kind and value (the slot, or for an alive rumor
// r_inc * U + slot, wrapping as lax's int32 arithmetic).  At N = 1M and U =
// 32 nearly every block's list is empty.  Then each thread writes 4
// consecutive nodes of each of the four maps as one 16-byte store: -1, or
// the largest value among its list entries of that kind and node (the
// scatter's max; the masked entries' -1 into index 0 changes nothing in a
// map that starts at -1).  A group that is not 16-byte aligned (a map at
// an odd offset, as the rows of a [4, N] block with N % 4 != 0 are) or
// that runs past N (the ragged tail) is stored element by element.  No
// node scans the table.
//
// map_add and maps_convert update their maps in place, one warp each:
// map_add applies atomicMax(&map[subject], slot) for each pair under ok,
// and atomicMax(&map[0], -1) when any pair is masked; maps_convert applies
// atomicMin(&suspect_of[subject], -1) and atomicMax(&dead_of[subject], u)
// for each converting slot u, and atomicMin(&suspect_of[0], 1 << 30),
// atomicMax(&dead_of[0], -1) when not every slot converts.  That is the
// reference's scatter, entry by entry; max and min do not depend on the
// order, so the atomics give the same map on every run.  The maps are
// never rebuilt from the table by the updates: after an eviction they are
// stale by design (swim.py:_maps), and map_add/maps_convert keep them so.
//
// Block form (a node-sharded pool, parallel/mesh.py): each entry point
// takes the global rows [row0, row0 + rows) its maps hold.  subject_maps
// fills those rows alone (its blocks own ranges from row0); map_add and
// maps_convert apply only the entries whose subject falls in them, and
// the masked entries' scatter into index 0 only where row0 = 0: a launch
// a block gives each atomic to the block that owns its subject, and the
// sentinel to global row 0.  A one-device launch is row0 = 0, rows = N.
//
// Bound on an H100: memory.  subject_maps writes 4 x 4 bytes a node (16 MB
// at N = 1M, ~0.005 ms at 3.35 TB/s).  map_add and maps_convert need only
// their <= 64 entries and the 32-byte map sectors at their subjects (a few
// KB, ~0): launch latency.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kRange = 4 * kThreads;  // nodes a block owns
constexpr int kAlive = 0, kSuspect = 1, kDead = 2, kLeft = 3;
constexpr int32_t kBig = 1 << 30;

// The 4 local rows i0 .. i0 + 3 of one map: a 16-byte store where they
// lie in [0, N) (the launch's rows) and the address is 16-byte aligned,
// else one store a node.
__device__ __forceinline__ void store4(int32_t* map, int64_t i0, int64_t N, const int32_t (&v)[4]) {
  int32_t* p = map + i0;
  if (i0 + 4 <= N && aligned16(p)) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i0 + j < N) p[j] = v[j];
}

__global__ void __launch_bounds__(kThreads)
subject_maps_kernel(const uint8_t* __restrict__ r_active, const int8_t* __restrict__ r_kind,
                    const int32_t* __restrict__ r_subject, const int32_t* __restrict__ r_inc,
                    int64_t row0, int64_t rows, int U, int32_t* __restrict__ suspect_of,
                    int32_t* __restrict__ dead_of, int32_t* __restrict__ left_of,
                    int32_t* __restrict__ alive_val) {
  // the block's list: subject, kind (the map it goes to) and value
  __shared__ int32_t s_subj[64], s_val[64];
  __shared__ int8_t s_map[64];
  __shared__ int s_count;
  const int64_t lo = row0 + static_cast<int64_t>(blockIdx.x) * kRange;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int u = lane + 32 * half;
      bool in = false;
      int32_t subj = 0, val = 0;
      int kind = -1;
      if (u < U && r_active[u]) {
        kind = r_kind[u];
        subj = r_subject[u];
        in = kind >= kAlive && kind <= kLeft && subj >= lo && subj < lo + kRange;
        val = kind == kAlive ? wrap_add(wrap_mul(r_inc[u], U), u) : u;
      }
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int at = base + __popc(m & ((1u << lane) - 1u));
        s_subj[at] = subj;
        s_val[at] = val;
        s_map[at] = static_cast<int8_t>(kind);
      }
      base += __popc(m);
    }
    if (lane == 0) s_count = base;
  }
  __syncthreads();
  const int count = s_count;
  const int64_t i0 = lo + 4 * static_cast<int64_t>(threadIdx.x);
  if (i0 >= row0 + rows) return;
  int32_t sus[4], dead[4], left[4], alive[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sus[j] = dead[j] = left[j] = alive[j] = -1;
  for (int k = 0; k < count; ++k) {
    const int64_t at = s_subj[k] - i0;
    if (at < 0 || at >= 4) continue;
    const int32_t v = s_val[k];
    const int kind = s_map[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at != j) continue;
      if (kind == kSuspect) sus[j] = max(sus[j], v);
      else if (kind == kDead) dead[j] = max(dead[j], v);
      else if (kind == kLeft) left[j] = max(left[j], v);
      else alive[j] = max(alive[j], v);
    }
  }
  store4(suspect_of, i0 - row0, rows, sus);
  store4(dead_of, i0 - row0, rows, dead);
  store4(left_of, i0 - row0, rows, left);
  store4(alive_val, i0 - row0, rows, alive);
}

// map.at[where(ok, subjects, 0)].max(where(ok, slots, -1)), in place
__global__ void __launch_bounds__(32)
map_add_kernel(int32_t* __restrict__ map, const int32_t* __restrict__ subjects,
               const int32_t* __restrict__ slots, const uint8_t* __restrict__ ok, int64_t row0,
               int64_t rows, int A) {
  const int lane = threadIdx.x;
  bool masked = false;
  for (int k = lane; k < A; k += 32) {
    if (!ok[k]) {
      masked = true;
      continue;
    }
    const int64_t at = static_cast<int64_t>(subjects[k]) - row0;
    if (subjects[k] >= 0 && at >= 0 && at < rows) atomicMax(&map[at], slots[k]);
  }
  if (__any_sync(0xffffffffu, masked) && lane == 0 && row0 == 0) atomicMax(&map[0], -1);
}

// suspect_of.at[where(convert, subject, 0)].min(where(convert, -1, 1 << 30))
// dead_of.at[where(convert, subject, 0)].max(where(convert, slot, -1)),
// both in place
__global__ void __launch_bounds__(32)
maps_convert_kernel(int32_t* __restrict__ suspect_of, int32_t* __restrict__ dead_of,
                    const uint8_t* __restrict__ convert, const int32_t* __restrict__ r_subject,
                    int64_t row0, int64_t rows, int U) {
  const int lane = threadIdx.x;
  const uint64_t conv = warp_slot_mask(convert, U);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int u = lane + 32 * half;
    if (!((conv >> u) & 1ull)) continue;
    const int64_t at = static_cast<int64_t>(r_subject[u]) - row0;
    if (r_subject[u] < 0 || at < 0 || at >= rows) continue;
    atomicMin(&suspect_of[at], -1);
    atomicMax(&dead_of[at], u);
  }
  if (conv != all_slots(U) && lane == 0 && row0 == 0) {
    atomicMin(&suspect_of[0], kBig);
    atomicMax(&dead_of[0], -1);
  }
}

}  // namespace

// The maps hold global rows [row0, row0 + rows) of N.
extern "C" int subject_maps(const void* r_active, const void* r_kind, const void* r_subject,
                            const void* r_inc, int64_t N, int U, int64_t row0, int64_t rows,
                            void* suspect_of, void* dead_of, void* left_of, void* alive_val,
                            void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || row0 < 0 || rows < 1 ||
      row0 + rows > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (rows + kRange - 1) / kRange;
  subject_maps_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject), static_cast<const int32_t*>(r_inc), row0, rows,
      U, static_cast<int32_t*>(suspect_of), static_cast<int32_t*>(dead_of),
      static_cast<int32_t*>(left_of), static_cast<int32_t*>(alive_val));
  return static_cast<int>(cudaGetLastError());
}

// map: global rows [row0, row0 + rows) of an [N] int32 map, updated in
// place.
extern "C" int map_add(void* map, const void* subjects, const void* slots, const void* ok,
                       int64_t N, int A, int64_t row0, int64_t rows, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || A < 1 || A > 64 || row0 < 0 || rows < 1 ||
      row0 + rows > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  map_add_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(map), static_cast<const int32_t*>(subjects),
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(ok), row0, rows, A);
  return static_cast<int>(cudaGetLastError());
}

// suspect_of, dead_of: global rows [row0, row0 + rows) of [N] int32 maps,
// updated in place.
extern "C" int maps_convert(void* suspect_of, void* dead_of, const void* convert,
                            const void* r_subject, int64_t N, int U, int64_t row0,
                            int64_t rows, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64 || row0 < 0 || rows < 1 ||
      row0 + rows > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  maps_convert_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(suspect_of), static_cast<int32_t*>(dead_of),
      static_cast<const uint8_t*>(convert), static_cast<const int32_t*>(r_subject), row0, rows,
      U);
  return static_cast<int>(cudaGetLastError());
}
