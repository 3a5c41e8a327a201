// K14 bulk_step: the bulk death channel advanced one gossip tick, then its
// rolling commit, on every tick of a mass event, in place.
//
// Replaces: consul_tpu/models/swim.py _bulk_disseminate and _bulk_commit
// under step_with_obs' lax.cond on any(bulk_member), which XLA and the
// port's plain twin (models/swim.py:_bulk_step_plain) run as some forty
// small [N] passes: the ring offsets' randint, the counts and sums, three
// ring pulls of the supply (six more under the nemesis build), the
// per-view updates, the coverage step and the commit.
//
// One cooperative launch (cudaLaunchCooperativeKernel on the co-resident
// grid of common.cuh:persistent_blocks), four phases split by grid
// barriers.  Each block first draws the G ring offsets itself from the
// randint spec the host passes by value (common.cuh:randint_lanes, K1's
// RANDINT steps: the gossip tick's stream 4, as rolls.offsets draws them),
// so no barrier waits on them.
//   1. count: V = sum(bulk_member), 16 bytes a load.  After the barrier
//      every block reads V; with V = 0 (the lax.cond's other branch) every
//      block returns, the branch being uniform, and nothing is written.
//   2. supply: n_up = sum(up) and the sum over up rows of min(bulk_heard,
//      v), v = max(V, 1).  The same pass computes each row's heard' from
//      the *old* bulk_heard: heard = min(bulk_heard[i], v), then for each
//      of the G ring views in turn the peer j = (i + offs[g]) % N's supply
//      (up[j] ? min(bulk_heard[j], v) : 0; under the nemesis build 0
//      across groups, else (supply * ok[j]) * ok[i]), clamped to cap,
//      adds supply * (1 - heard / v) * p_ok to a live receiver's heard (at
//      most v), each view with the heard the one before left.  heard'
//      goes to the carry.
//   3. advance: sel = min((1 / max(mean_supply, 1)) * cap, 1) (the twin's
//      cap / tensor is a reciprocal times cap), and at each member q = 1 -
//      clip((cov * sel) * p_ok, 0, 1), q^G by XLA's square-and-multiply,
//      cov' = clip(cov + (1 - cov) * (1 - q^G), 0, 1), done = cov' >=
//      0.995; the sums removed = sum(done ? cov' : 0) and v_new =
//      sum(member & !done).  Non-members have cov' = 0 and no sum term.
//   4. commit, a row a thread: heard'' = min(max(heard' - removed, 0),
//      v_new); cov'' = done ? 0 : cov' at members (cov' recomputed from the
//      row's own bulk_cov, which only this thread writes, after its read),
//      0 elsewhere; at a done member bulk_member cleared and
//      committed_dead set.
// In place, and only where a value changes: bulk_heard where heard''
// differs from the input (bit for bit), bulk_cov where cov'' does (at
// members, and wherever a non-member's input is not +0), bulk_member and
// committed_dead only at done subjects.  Why it is race-free: every read
// of bulk_heard at a peer happens in phase 2, every write of any leaf in
// phase 4, after two more barriers; phases 3 and 4 read only the row
// itself.
//
// The carry of heard' across barriers 2-3 is one per-device float scratch
// of N (the host's, grown with N): a persistent grid holds a bounded
// number of rows in registers, and one code path must serve every N.  At
// N = 1M its 4 MB is written and reread within the 50 MB L2.  cov' is not
// carried: phase 4 recomputes it from the same inputs, bit for bit.
//
// The sums are doubles (exact for the counts; for the float sums the exact
// sum of the float32 terms up to 2^53, rounded once to float32 where it is
// used).  Each block's partials go in its own slots of the scratch and,
// after each barrier, every block adds them in the same fixed order
// (common.cuh:block_partials/grid_totals), so every block, and two
// launches on the same inputs, get the same bits; only the two float sums
// differ from torch's summation order.  No slot needs a reset.  Every
// float step is explicitly rounded in the twin's order.
//
// The grid: 1,024-thread blocks, two an SM (264 blocks on an H100), so the
// barriers wait on few blocks and each block's totals read few partials; a
// thread takes rows i, i + stride, ... in each phase.
//
// Bound on an H100: memory.  The least bytes read bulk_member, up, member
// and bulk_heard once (7 bytes a node), bulk_cov only in the 32-byte
// sectors of members (cov' is 0 elsewhere) and committed_dead not at all
// (an OR with done), and write each output only in the sectors that
// change: at the correlated bench's mid-drain (1% of 1M nodes in the
// channel, no commit) about 12 MB, ~0.0035 ms at 3.35 TB/s.  On an empty
// channel it reads bulk_member alone: 1 MB, ~0.0003 ms.  This design also
// reads bulk_cov whole in phase 4 and moves the 4 MB carry through L2.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace consul_kernels;
namespace cg = cooperative_groups;

namespace {

// Large blocks, few of them: after each barrier every block adds every
// block's partials, so the grid's reads of them grow with its square.
constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxViews = 16;
// each block's partial sums, in doubles: its slots kV .. kVNew of kResults
enum Result : int { kV = 0, kUp = 1, kSupply = 2, kRemoved = 3, kVNew = 4, kResults = 5 };
constexpr float kCommitBar = 0.995f;

// Built with -DBULK_PHASE_TIMES (build.variant; chip_smoke.py's phase
// split), the kernel stamps %globaltimer into partials words kStamps..
// (free while the grid has at most 2,048 blocks; the caller zeroes them):
// 0 block 0's start, then the latest block at 1 the end of its count, 2
// its copy of V, 3 the end of its supply pass, 4 its copy of those sums, 5
// the end of its advance pass, 6 its copy of those sums, 7 its end.
constexpr int kStamps = kResults * 2048;
#ifdef BULK_PHASE_TIMES
__device__ __forceinline__ void stamp(double* partials, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(reinterpret_cast<u64*>(partials) + kStamps + k, t);
  }
}
#else
__device__ __forceinline__ void stamp(double*, int) {}
#endif

struct BulkArgs {
  uint8_t* bulk_member;        // updated in place
  float* bulk_heard;           // updated in place
  float* bulk_cov;             // updated in place
  const uint8_t* up;
  const uint8_t* member;
  uint8_t* committed_dead;     // updated in place
  const int16_t* group;        // [N] or null (the nemesis build)
  const float* node_ok;        // [N] or null
  int64_t N;
  float cap, p_ok;
  double* partials;            // kResults a block
  float* carry;                // [N]: heard' across barriers 2-3
  DrawSpec offs;               // the G = offs.n ring offsets' randint
};

// max(float(V), 1): the twin's bulk_member.sum().to(float32).clamp_min(1)
__device__ __forceinline__ float v_of(double V) { return fmaxf(__double2float_rn(V), 1.0f); }

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

// A member's coverage after the tick: clip(cov + (1 - cov) * (1 - q^G),
// 0, 1), q = 1 - clip((cov * sel) * p_ok, 0, 1).
__device__ __forceinline__ float grown(float cov, float sel, float p_ok, int G) {
  const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(cov, sel), p_ok), 0.0f), 1.0f);
  const float p_learn = __fsub_rn(1.0f, integer_pow(__fsub_rn(1.0f, x), G));
  return fminf(fmaxf(__fadd_rn(cov, __fmul_rn(__fsub_rn(1.0f, cov), p_learn)), 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bulk_kernel(const __grid_constant__ BulkArgs a) {
  __shared__ int64_t s_offs[kMaxViews];
  __shared__ double red1[1][32], red2[2][32];
  cg::grid_group grid = cg::this_grid();
  const int64_t N = a.N;
  const int G = static_cast<int>(a.offs.n);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (blockIdx.x == 0) stamp(a.partials, 0);
  if (threadIdx.x < G) {  // element g of the offsets' randint draw
    uint32_t v[1];
    randint_lanes<1>(a.offs, 0u, threadIdx.x, v);
    const int64_t d = static_cast<int64_t>(static_cast<int32_t>(v[0])) % N;
    s_offs[threadIdx.x] = d < 0 ? d + N : d;
  }

  // 1. count
  double c[1] = {0.0};
  int64_t done_rows = 0;
  if (aligned16(a.bulk_member)) {
    const int64_t vecs = N / 16;
    const uint4* bm = reinterpret_cast<const uint4*>(a.bulk_member);
    for (int64_t k = tid; k < vecs; k += stride) {
      const uint4 w = bm[k];
      c[0] += __popc(nonzero_bytes(w.x)) + __popc(nonzero_bytes(w.y)) +
              __popc(nonzero_bytes(w.z)) + __popc(nonzero_bytes(w.w));
    }
    done_rows = vecs * 16;
  }
  for (int64_t i = done_rows + tid; i < N; i += stride) c[0] += a.bulk_member[i] ? 1.0 : 0.0;
  block_partials<1>(c, red1, a.partials + kV, kResults);
  stamp(a.partials, 1);
  grid.sync();
  double t1[1];
  grid_totals<1>(a.partials + kV, kResults, red1, t1);
  stamp(a.partials, 2);
  const double V = t1[0];
  if (V == 0.0) {  // grid-uniform: the channel is empty
    stamp(a.partials, 7);
    return;
  }

  // 2. supply, and heard' from the old bulk_heard (read-only until phase
  // 4, so its loads take the non-coherent path)
  const float vf = v_of(V);
  const bool chaos = a.group != nullptr;
  double p2[2] = {0.0, 0.0};  // n_up, supply
  for (int64_t i = tid; i < N; i += stride) {
    const bool up = __ldg(&a.up[i]);
    float heard = fminf(__ldg(&a.bulk_heard[i]), vf);
    if (up) {
      p2[0] += 1.0;
      p2[1] += static_cast<double>(heard);
    }
    if (up && __ldg(&a.member[i])) {  // a live receiver
      for (int g = 0; g < G; ++g) {    // each view with the heard the one before left
        const int64_t j = i + s_offs[g] >= N ? i + s_offs[g] - N : i + s_offs[g];
        float view = __ldg(&a.up[j]) ? fminf(__ldg(&a.bulk_heard[j]), vf) : 0.0f;
        if (chaos) {
          view = __ldg(&a.group[j]) == __ldg(&a.group[i])
                     ? __fmul_rn(__fmul_rn(view, __ldg(&a.node_ok[j])), __ldg(&a.node_ok[i]))
                     : 0.0f;
        }
        const float supply = fminf(view, a.cap);
        const float novelty = __fsub_rn(1.0f, __fdiv_rn(heard, vf));
        heard = fminf(__fadd_rn(heard, __fmul_rn(__fmul_rn(supply, novelty), a.p_ok)), vf);
      }
    }
    a.carry[i] = heard;
  }
  block_partials<2>(p2, red2, a.partials + kUp, kResults);
  stamp(a.partials, 3);
  grid.sync();
  double t2[2];
  grid_totals<2>(a.partials + kUp, kResults, red2, t2);
  stamp(a.partials, 4);

  // 3. advance: the members' coverage, and what the commit removes
  const float n_up = fmaxf(__double2float_rn(t2[0]), 1.0f);
  const float mean_supply = __fdiv_rn(__double2float_rn(t2[1]), n_up);
  const float sel = fminf(__fmul_rn(__frcp_rn(fmaxf(mean_supply, 1.0f)), a.cap), 1.0f);
  double p3[2] = {0.0, 0.0};  // removed, v_new
  for (int64_t i = tid; i < N; i += stride) {
    if (!__ldg(&a.bulk_member[i])) continue;
    const float cov = grown(__ldg(&a.bulk_cov[i]), sel, a.p_ok, G);
    if (cov >= kCommitBar) p3[0] += static_cast<double>(cov);
    else p3[1] += 1.0;
  }
  block_partials<2>(p3, red2, a.partials + kRemoved, kResults);
  stamp(a.partials, 5);
  grid.sync();
  double t3[2];
  grid_totals<2>(a.partials + kRemoved, kResults, red2, t3);
  stamp(a.partials, 6);

  // 4. commit, in place where a value changes: a row's leaves are read and
  // written by its own thread alone; the carry was written before the
  // barriers
  const float removed = __double2float_rn(t3[0]);
  const float v_new = __double2float_rn(t3[1]);
  for (int64_t i = tid; i < N; i += stride) {
    const float old_heard = a.bulk_heard[i];
    const float heard = fminf(fmaxf(__fsub_rn(__ldcg(&a.carry[i]), removed), 0.0f), v_new);
    if (__float_as_uint(heard) != __float_as_uint(old_heard)) a.bulk_heard[i] = heard;
    const float old_cov = a.bulk_cov[i];
    float cov = 0.0f;
    if (a.bulk_member[i]) {
      cov = grown(old_cov, sel, a.p_ok, G);
      if (cov >= kCommitBar) {
        cov = 0.0f;
        a.bulk_member[i] = 0;
        if (!a.committed_dead[i]) a.committed_dead[i] = 1;
      }
    }
    if (__float_as_uint(cov) != __float_as_uint(old_cov)) a.bulk_cov[i] = cov;
  }
  stamp(a.partials, 7);
}

}  // namespace

// One bulk step, in place on the four leaves.  offsets: a host pointer to
// the ring offsets' randint DrawSpec (mode RANDINT, n = G with 1 <= G <=
// 16, range >= 1; its out is not used); group and node_ok both given (the
// nemesis build) or both null; partials: kResults * scratch_blocks
// doubles; carry: N floats.  Neither scratch needs a reset.
extern "C" int bulk_step(void* bulk_member, void* bulk_heard, void* bulk_cov, const void* up,
                         const void* member, void* committed_dead, const void* offsets,
                         const void* group, const void* node_ok, int64_t N, float cap,
                         float p_ok, void* partials, int scratch_blocks, void* carry,
                         void* stream) {
  if (offsets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DrawSpec& offs = *static_cast<const DrawSpec*>(offsets);
  if (N < 1 || N >= (int64_t{1} << 31) || offs.n < 1 || offs.n > kMaxViews ||
      offs.range == 0 || scratch_blocks < 1 || (group == nullptr) != (node_ok == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BulkArgs a;
  a.bulk_member = static_cast<uint8_t*>(bulk_member);
  a.bulk_heard = static_cast<float*>(bulk_heard);
  a.bulk_cov = static_cast<float*>(bulk_cov);
  a.up = static_cast<const uint8_t*>(up);
  a.member = static_cast<const uint8_t*>(member);
  a.committed_dead = static_cast<uint8_t*>(committed_dead);
  a.group = static_cast<const int16_t*>(group);
  a.node_ok = static_cast<const float*>(node_ok);
  a.N = N;
  a.cap = cap;
  a.p_ok = p_ok;
  a.partials = static_cast<double*>(partials);
  a.carry = static_cast<float*>(carry);
  a.offs = offs;
  static PerCard per_card;
  const int blocks = persistent_blocks(bulk_kernel, kThreads, N, scratch_blocks, per_card);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bulk_kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
