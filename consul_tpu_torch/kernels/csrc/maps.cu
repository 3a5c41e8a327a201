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
// One launch each, a thread per node over a grid-stride loop.  The <= 64
// table entries (or <= A allocated pairs) sit in shared memory, and node i
// scans the ones whose subject is i and takes their max (min): the same
// value as the scatter, with no atomics.  The masked entries' write into
// index 0 is applied by node 0 as the scatter applies it.  The maps are
// never rebuilt from the table by the updates: after an eviction they are
// stale by design (swim.py:_maps), and map_add/maps_convert keep them so.
//
// Bound on an H100: memory.  subject_maps writes 4 x 4 bytes a node (16 MB
// at N = 1M, ~0.005 ms at 3.35 TB/s).  map_add and maps_convert, updating
// in place, need only their <= 64 entries and the 32-byte map sectors at
// their subjects (a few KB, ~0): these kernels read and write whole maps
// (8 and 16 MB) because their outputs are fresh.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kAlive = 0, kSuspect = 1, kDead = 2, kLeft = 3;
constexpr int32_t kBig = 1 << 30;

__global__ void __launch_bounds__(kThreads)
subject_maps_kernel(const uint8_t* __restrict__ r_active, const int8_t* __restrict__ r_kind,
                    const int32_t* __restrict__ r_subject, const int32_t* __restrict__ r_inc,
                    int64_t N, int U, int32_t* __restrict__ suspect_of,
                    int32_t* __restrict__ dead_of, int32_t* __restrict__ left_of,
                    int32_t* __restrict__ alive_val) {
  __shared__ int32_t s_subj[64], s_val[64];
  __shared__ int8_t s_kind[64];
  __shared__ uint64_t s_active;
  if (threadIdx.x < 32) {
    const uint64_t m = warp_slot_mask(r_active, U);
    if (threadIdx.x == 0) s_active = m;
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const int kind = r_kind[u];
    s_subj[u] = r_subject[u];
    s_kind[u] = static_cast<int8_t>(kind);
    s_val[u] = kind == kAlive ? wrap_add(wrap_mul(r_inc[u], U), u) : u;
  }
  __syncthreads();
  const uint64_t active = s_active;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    int32_t sus = -1, dead = -1, left = -1, alive = -1;
    for (uint64_t m = active; m; m &= m - 1) {
      const int u = __ffsll(m) - 1;
      if (s_subj[u] != i) continue;
      const int32_t v = s_val[u];
      switch (s_kind[u]) {
        case kSuspect: sus = v > sus ? v : sus; break;
        case kDead: dead = v > dead ? v : dead; break;
        case kLeft: left = v > left ? v : left; break;
        case kAlive: alive = v > alive ? v : alive; break;
        default: break;
      }
    }
    suspect_of[i] = sus;
    dead_of[i] = dead;
    left_of[i] = left;
    alive_val[i] = alive;
  }
}

// map.at[where(ok, subjects, 0)].max(where(ok, slots, -1))
__global__ void __launch_bounds__(kThreads)
map_add_kernel(const int32_t* __restrict__ map, const int32_t* __restrict__ subjects,
               const int32_t* __restrict__ slots, const uint8_t* __restrict__ ok, int64_t N,
               int A, int32_t* __restrict__ out) {
  __shared__ int32_t s_subj[64], s_slot[64];
  __shared__ int s_pairs, s_masked;
  if (threadIdx.x == 0) {
    int n = 0;
    bool masked = false;
    for (int k = 0; k < A; ++k) {
      if (ok[k]) {
        s_subj[n] = subjects[k];
        s_slot[n++] = slots[k];
      } else {
        masked = true;
      }
    }
    s_pairs = n;
    s_masked = masked;
  }
  __syncthreads();
  const int pairs = s_pairs;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    int32_t v = map[i];
    for (int k = 0; k < pairs; ++k) {
      if (s_subj[k] == i && s_slot[k] > v) v = s_slot[k];
    }
    if (i == 0 && s_masked && v < -1) v = -1;
    out[i] = v;
  }
}

// suspect_of.at[where(convert, subject, 0)].min(where(convert, -1, 1 << 30))
// dead_of.at[where(convert, subject, 0)].max(where(convert, slot, -1))
__global__ void __launch_bounds__(kThreads)
maps_convert_kernel(const int32_t* __restrict__ suspect_of, const int32_t* __restrict__ dead_of,
                    const uint8_t* __restrict__ convert, const int32_t* __restrict__ r_subject,
                    int64_t N, int U, int32_t* __restrict__ suspect_out,
                    int32_t* __restrict__ dead_out) {
  __shared__ int32_t s_subj[64];
  __shared__ uint64_t s_convert;
  if (threadIdx.x < 32) {
    const uint64_t m = warp_slot_mask(convert, U);
    if (threadIdx.x == 0) s_convert = m;
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) s_subj[u] = r_subject[u];
  __syncthreads();
  const uint64_t conv = s_convert;
  const bool masked = conv != all_slots(U);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    int32_t sus = suspect_of[i], dead = dead_of[i];
    for (uint64_t m = conv; m; m &= m - 1) {
      const int u = __ffsll(m) - 1;
      if (s_subj[u] != i) continue;
      sus = sus < -1 ? sus : -1;
      dead = dead > u ? dead : u;
    }
    if (i == 0 && masked) {
      sus = sus < kBig ? sus : kBig;
      dead = dead > -1 ? dead : -1;
    }
    suspect_out[i] = sus;
    dead_out[i] = dead;
  }
}

int node_blocks(int64_t N) {
  const int64_t need = (N + kThreads - 1) / kThreads;
  return static_cast<int>(need < 2048 ? need : 2048);
}

}  // namespace

extern "C" int subject_maps(const void* r_active, const void* r_kind, const void* r_subject,
                            const void* r_inc, int64_t N, int U, void* suspect_of,
                            void* dead_of, void* left_of, void* alive_val, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  subject_maps_kernel<<<node_blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r_active), static_cast<const int8_t*>(r_kind),
      static_cast<const int32_t*>(r_subject), static_cast<const int32_t*>(r_inc), N, U,
      static_cast<int32_t*>(suspect_of), static_cast<int32_t*>(dead_of),
      static_cast<int32_t*>(left_of), static_cast<int32_t*>(alive_val));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int map_add(const void* map, const void* subjects, const void* slots,
                       const void* ok, int64_t N, int A, void* out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || A < 1 || A > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  map_add_kernel<<<node_blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(map), static_cast<const int32_t*>(subjects),
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(ok), N, A,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int maps_convert(const void* suspect_of, const void* dead_of, const void* convert,
                            const void* r_subject, int64_t N, int U, void* suspect_out,
                            void* dead_out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || U < 1 || U > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  maps_convert_kernel<<<node_blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(suspect_of), static_cast<const int32_t*>(dead_of),
      static_cast<const uint8_t*>(convert), static_cast<const int32_t*>(r_subject), N, U,
      static_cast<int32_t*>(suspect_out), static_cast<int32_t*>(dead_out));
  return static_cast<int>(cudaGetLastError());
}
