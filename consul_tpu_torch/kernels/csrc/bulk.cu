// K14 bulk_step: the bulk death channel advanced one gossip tick, then its
// rolling commit, on every tick of a mass event.
//
// Replaces: consul_tpu/models/swim.py _bulk_disseminate and _bulk_commit
// under step_with_obs' lax.cond on any(bulk_member), which XLA and the
// port's plain twin (models/swim.py:_bulk_step_plain) run as some forty
// small [N] passes: the counts and sums, three ring pulls of the supply
// (six more under the nemesis build), the per-view updates, the coverage
// step and the commit.
//
// Four launches on one stream, no host sync.  Each grid-wide sum is a
// last-block result (common.cuh:grid_sum, in doubles: exact for the
// counts, and for the float sums the exact sum of the float32 terms up to
// 2^53, rounded once to float32 where it is used) that the next launch
// reads from the scratch:
//   1. count: V = sum(bulk_member), n_up = sum(up);
//   2. supply: sum over up rows of min(bulk_heard, v), v = max(V, 1);
//   3. advance, a row a thread: heard = min(bulk_heard[i], v), then for
//      each of the G ring views in turn the peer j = (i + offs[g]) % N's
//      old supply (up[j] ? min(bulk_heard[j], v) : 0; under the nemesis
//      build 0 across groups, else (supply * ok[j]) * ok[i]), clamped to
//      cap, adds supply * (1 - heard / v) * p_ok to a live receiver's
//      heard (at most v), each view with the heard the one before left;
//      sel = min((1 / max(mean_supply, 1)) * cap, 1) (the twin's cap /
//      tensor is a reciprocal times cap), q = 1 - clip((cov * sel) * p_ok,
//      0, 1), q^G by XLA's square-and-multiply (q * (q * q) for G = 3),
//      cov' = clip(cov + (1 - cov) * (1 - q^G), 0, 1) at members, else 0;
//      done = member & cov' >= 0.995.  heard and cov' go to the outputs;
//      the grid sums removed = sum(done ? cov' : 0) and v_new =
//      sum(member & !done);
//   4. commit, a row a thread: heard = min(max(heard - removed, 0),
//      v_new), cov' = 0 and member cleared where done, committed_dead |=
//      done.
// With V = 0 (the lax.cond's other branch) every output is its input.
// Every float step is explicitly rounded in the twin's order; only the
// two float sums differ from torch's summation order, in a fixed order of
// their own (each block's partial in its own slot, added in block order).
//
// Bound on an H100: memory.  The least bytes read bulk_member, up, member
// and bulk_heard once (7 bytes a node), bulk_cov only in the 32-byte
// sectors of members (cov' is 0 elsewhere) and committed_dead not at all
// (an OR with done), and write each output in place, only in the sectors
// that change: at the correlated bench's mid-drain (1% of 1M nodes in the
// channel, no commit) about 12 MB, ~0.0035 ms at 3.35 TB/s.  With the fresh
// copies, six leaves read and four written whole, 22 bytes a node: 22 MB,
// ~0.0066 ms; the nemesis build reads 6 more (groups and rates).  This
// design reads bulk_member and up in launches 1-3, bulk_heard in 2 and 3
// (and at the G peers, mostly from L2), and writes then rereads heard and
// cov' between 3 and 4: ~53 MB.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxViews = 16;
// scratch: the results (doubles), then grid_sum's count and partials
enum Result : int { kV = 0, kUp = 1, kSupply = 2, kRemoved = 3, kVNew = 4, kResults = 5 };
constexpr float kCommitBar = 0.995f;

struct BulkArgs {
  const uint8_t* bulk_member;
  const float* bulk_heard;
  const float* bulk_cov;
  const uint8_t* up;
  const uint8_t* member;
  const uint8_t* committed_dead;
  const int32_t* offs;      // [G] ring offsets, on the device
  const int16_t* group;     // [N] or null (the nemesis build)
  const float* node_ok;     // [N] or null
  int64_t N;
  int G;
  float cap, p_ok;
  u64* scratch;
  uint8_t* bulk_member_out;
  float* bulk_heard_out;
  float* bulk_cov_out;
  uint8_t* committed_dead_out;
};

__device__ __forceinline__ double result(const BulkArgs& a, int k) {
  return __longlong_as_double(static_cast<long long>(__ldcg(&a.scratch[k])));
}

__device__ __forceinline__ void publish(const BulkArgs& a, int k, double v) {
  a.scratch[k] = static_cast<u64>(__double_as_longlong(v));
}

__device__ __forceinline__ u64* sums(const BulkArgs& a) { return a.scratch + kResults; }

// max(float(V), 1): the twin's bulk_member.sum().to(float32).clamp_min(1)
__device__ __forceinline__ float v_of(double V) { return fmaxf(__double2float_rn(V), 1.0f); }

__device__ __forceinline__ int64_t grid_start() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

__global__ void __launch_bounds__(kThreads) bulk_count_kernel(const __grid_constant__ BulkArgs a) {
  double v[2] = {0.0, 0.0};
  for (int64_t i = grid_start(); i < a.N; i += grid_stride()) {
    v[0] += a.bulk_member[i] ? 1.0 : 0.0;
    v[1] += a.up[i] ? 1.0 : 0.0;
  }
  double tot[2];
  if (grid_sum<2>(v, sums(a), tot)) {
    publish(a, kV, tot[0]);
    publish(a, kUp, tot[1]);
  }
}

__global__ void __launch_bounds__(kThreads) bulk_supply_kernel(const __grid_constant__ BulkArgs a) {
  const double V = result(a, kV);
  const float vf = v_of(V);
  double v[1] = {0.0};
  if (V > 0.0) {
    for (int64_t i = grid_start(); i < a.N; i += grid_stride()) {
      if (a.up[i]) v[0] += static_cast<double>(fminf(a.bulk_heard[i], vf));
    }
  }
  double tot[1];
  if (grid_sum<1>(v, sums(a), tot)) publish(a, kSupply, tot[0]);
}

// x^y by XLA's integer_pow (models/swim.py:_integer_pow): square and
// multiply from the low bit, each product rounded.
__device__ __forceinline__ float integer_pow(float x, int y) {
  float acc = 1.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) bulk_advance_kernel(const __grid_constant__ BulkArgs a) {
  __shared__ int64_t s_offs[kMaxViews];
  const int64_t N = a.N;
  if (threadIdx.x < a.G) {
    const int64_t d = static_cast<int64_t>(a.offs[threadIdx.x]) % N;
    s_offs[threadIdx.x] = d < 0 ? d + N : d;
  }
  __syncthreads();
  const double V = result(a, kV);
  double v[2] = {0.0, 0.0};  // removed, v_new
  if (V > 0.0) {
    const float vf = v_of(V);
    const float n_up = fmaxf(__double2float_rn(result(a, kUp)), 1.0f);
    const float mean_supply = __fdiv_rn(__double2float_rn(result(a, kSupply)), n_up);
    const float sel = fminf(__fmul_rn(__frcp_rn(fmaxf(mean_supply, 1.0f)), a.cap), 1.0f);
    const bool chaos = a.group != nullptr;
    for (int64_t i = grid_start(); i < N; i += grid_stride()) {
      const bool recv = a.up[i] && a.member[i];
      float heard = fminf(a.bulk_heard[i], vf);
      for (int g = 0; g < a.G; ++g) {
        const int64_t j = i + s_offs[g] >= N ? i + s_offs[g] - N : i + s_offs[g];
        float view = a.up[j] ? fminf(a.bulk_heard[j], vf) : 0.0f;
        if (chaos) {
          view = a.group[j] == a.group[i]
                     ? __fmul_rn(__fmul_rn(view, a.node_ok[j]), a.node_ok[i])
                     : 0.0f;
        }
        const float supply = fminf(view, a.cap);
        const float novelty = __fsub_rn(1.0f, __fdiv_rn(heard, vf));
        if (recv) {
          heard = fminf(__fadd_rn(heard, __fmul_rn(__fmul_rn(supply, novelty), a.p_ok)), vf);
        }
      }
      const float cov = a.bulk_cov[i];
      const bool member = a.bulk_member[i];
      const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(cov, sel), a.p_ok), 0.0f), 1.0f);
      const float p_learn = __fsub_rn(1.0f, integer_pow(__fsub_rn(1.0f, x), a.G));
      const float grown =
          fminf(fmaxf(__fadd_rn(cov, __fmul_rn(__fsub_rn(1.0f, cov), p_learn)), 0.0f), 1.0f);
      const float cov_new = member ? grown : 0.0f;
      const bool done = member && cov_new >= kCommitBar;
      a.bulk_heard_out[i] = heard;
      a.bulk_cov_out[i] = cov_new;
      v[0] += done ? static_cast<double>(cov_new) : 0.0;
      v[1] += member && !done ? 1.0 : 0.0;
    }
  } else {
    for (int64_t i = grid_start(); i < N; i += grid_stride()) {
      a.bulk_heard_out[i] = a.bulk_heard[i];
      a.bulk_cov_out[i] = a.bulk_cov[i];
    }
  }
  double tot[2];
  if (grid_sum<2>(v, sums(a), tot)) {
    publish(a, kRemoved, tot[0]);
    publish(a, kVNew, tot[1]);
  }
}

__global__ void __launch_bounds__(kThreads) bulk_commit_kernel(const __grid_constant__ BulkArgs a) {
  const bool live = result(a, kV) > 0.0;
  const float removed = __double2float_rn(result(a, kRemoved));
  const float v_new = __double2float_rn(result(a, kVNew));
  for (int64_t i = grid_start(); i < a.N; i += grid_stride()) {
    const bool member = a.bulk_member[i];
    if (!live) {
      a.bulk_member_out[i] = member;
      a.committed_dead_out[i] = a.committed_dead[i];
      continue;
    }
    const float cov = a.bulk_cov_out[i];
    const bool done = member && cov >= kCommitBar;
    a.bulk_heard_out[i] = fminf(fmaxf(__fsub_rn(a.bulk_heard_out[i], removed), 0.0f), v_new);
    if (done) a.bulk_cov_out[i] = 0.0f;
    a.bulk_member_out[i] = member && !done;
    a.committed_dead_out[i] = a.committed_dead[i] || done;
  }
}

}  // namespace

// One bulk step: the four launches above into the four *_out leaves.
// offs: [G] int32 on the device, 1 <= G <= 16; group and node_ok both
// given (the nemesis build) or both null; scratch: kResults + 1 + 2 *
// scratch_blocks u64, its count zeroed once (grid_sum resets it).
extern "C" int bulk_step(const void* bulk_member, const void* bulk_heard, const void* bulk_cov,
                         const void* up, const void* member, const void* committed_dead,
                         const void* offs, const void* group, const void* node_ok, int64_t N,
                         int G, float cap, float p_ok, void* scratch, int scratch_blocks,
                         void* bulk_member_out, void* bulk_heard_out, void* bulk_cov_out,
                         void* committed_dead_out, void* stream) {
  if (N < 1 || N >= (int64_t{1} << 31) || G < 1 || G > kMaxViews || scratch_blocks < 1 ||
      (group == nullptr) != (node_ok == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BulkArgs a;
  a.bulk_member = static_cast<const uint8_t*>(bulk_member);
  a.bulk_heard = static_cast<const float*>(bulk_heard);
  a.bulk_cov = static_cast<const float*>(bulk_cov);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.committed_dead = static_cast<const uint8_t*>(committed_dead);
  a.offs = static_cast<const int32_t*>(offs);
  a.group = static_cast<const int16_t*>(group);
  a.node_ok = static_cast<const float*>(node_ok);
  a.N = N;
  a.G = G;
  a.cap = cap;
  a.p_ok = p_ok;
  a.scratch = static_cast<u64*>(scratch);
  a.bulk_member_out = static_cast<uint8_t*>(bulk_member_out);
  a.bulk_heard_out = static_cast<float*>(bulk_heard_out);
  a.bulk_cov_out = static_cast<float*>(bulk_cov_out);
  a.committed_dead_out = static_cast<uint8_t*>(committed_dead_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int count_card = 0, supply_card = 0, advance_card = 0, commit_card = 0;
  bulk_count_kernel<<<persistent_blocks(bulk_count_kernel, kThreads, N, scratch_blocks,
                                        count_card),
                      kThreads, 0, s>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  bulk_supply_kernel<<<persistent_blocks(bulk_supply_kernel, kThreads, N, scratch_blocks,
                                         supply_card),
                       kThreads, 0, s>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  bulk_advance_kernel<<<persistent_blocks(bulk_advance_kernel, kThreads, N, scratch_blocks,
                                          advance_card),
                        kThreads, 0, s>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  bulk_commit_kernel<<<persistent_blocks(bulk_commit_kernel, kThreads, N, 1 << 20,
                                         commit_card),
                       kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
