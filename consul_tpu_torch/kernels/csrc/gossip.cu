// K2 gossip_disseminate: one fanout round of infection-style gossip over the
// [N, S] knowledge matrix, one thread per receiving row.
//
// Replaces: consul_tpu/ops/gossip.py disseminate (non-chaos path), which
// XLA runs as G dynamic slices of a doubled [2N, S] buffer built by
// ops/rolls.py pull_multi, fused with the mask algebra and three
// reductions.
//
// Row i pulls the queued cells of its G ring peers (i + offsets[g]) % N in
// place: no doubled buffer is built.  The offsets stay on the device (read
// once per block), so the host never learns them and never syncs.
//
// Bound on an H100: memory.  The minimum traffic is each row's own
// know/sends_left (2S bytes), the loss mask (G bytes), sender/receiver
// flags, and the three S-byte output rows; the G peer rows are other rows
// of the same arrays, which L2 serves.  The design: every row is read and
// written as 16-byte vectors (S a multiple of 16; byte by byte otherwise)
// and carried as a 64-bit slot mask, a peer's budget bytes are read only
// where it knows something, and the rows of a warp are neighbours, so the
// 1M independent threads keep enough loads in flight to stream.  The
// three counters are summed per block and folded into integer atomics
// (exact at any N, where the JAX package sums in float32), the last block
// converting them to float32.  Outputs go to fresh buffers because other
// rows still read the old rows.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kMaxFanout = 16;

__device__ __forceinline__ unsigned set_byte(unsigned w, int j, int v) {
  const int sh = 8 * j;
  return (w & ~(0xffu << sh)) | ((static_cast<unsigned>(v) & 0xffu) << sh);
}

// new sends_left of one slot: the full budget on learn, the budget less
// one transmission per contact while queued, else unchanged
__device__ __forceinline__ int next_budget(int sl, bool learned, bool served,
                                           int limit, int G) {
  if (learned) return limit;
  if (served) return sl - G > 0 ? sl - G : 0;
  return sl;
}

__global__ void gossip_kernel(const uint8_t* __restrict__ know,
                              const int8_t* __restrict__ sends,
                              const int32_t* __restrict__ offsets, int G,
                              const uint8_t* __restrict__ sender_ok,
                              const uint8_t* __restrict__ receiver_ok,
                              const uint8_t* __restrict__ slot_active,
                              const uint8_t* __restrict__ ok,  // [N, G] or null
                              int64_t N, int S, int limit,
                              uint8_t* __restrict__ new_know,
                              int8_t* __restrict__ new_sends,
                              uint8_t* __restrict__ newly,
                              u64* __restrict__ acc,  // [4]
                              float* __restrict__ counters) {  // [3]
  __shared__ int64_t s_off[kMaxFanout];
  __shared__ uint64_t s_active;
  if (threadIdx.x < G) {
    int64_t off = static_cast<int64_t>(offsets[threadIdx.x]) % N;
    s_off[threadIdx.x] = off < 0 ? off + N : off;
  }
  if (threadIdx.x == 0) {
    uint64_t m = 0;
    for (int s = 0; s < S; ++s) if (slot_active[s]) m |= 1ull << s;
    s_active = m;
  }
  __syncthreads();

  u64 v[3] = {0, 0, 0};  // delivered, own queued cells, lost cells
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < N) {
    uint64_t got = 0;
    for (int g = 0; g < G; ++g) {
      int64_t src = i + s_off[g];
      if (src >= N) src -= N;
      const uint64_t srv = sender_ok[src]
          ? queued_mask(know + src * S, sends + src * S, S) : 0;
      if (ok == nullptr || ok[i * G + g]) {
        got |= srv;
      } else {
        v[2] += __popcll(srv);
      }
    }
    const uint8_t* k = know + i * S;
    const int8_t* sl = sends + i * S;
    const uint64_t own = row_mask(k, S);
    const uint64_t serve = sender_ok[i] ? queued_mask(k, sl, S) : 0;
    const uint64_t nw = receiver_ok[i] ? (got & s_active & ~own) : 0;
    v[0] = __popcll(nw);
    v[1] = __popcll(serve);

    uint8_t* nk = new_know + i * S;
    int8_t* ns = new_sends + i * S;
    uint8_t* nl = newly + i * S;
    int u = 0;
    if (aligned16(k) && aligned16(nk) && aligned16(ns) && aligned16(nl)) {
      for (; u + 16 <= S; u += 16) {
        const unsigned learned16 = static_cast<unsigned>(nw >> u) & 0xffffu;
        const unsigned served16 = static_cast<unsigned>(serve >> u) & 0xffffu;
        *reinterpret_cast<uint4*>(nk + u) =
            bytes16(static_cast<unsigned>((own | nw) >> u) & 0xffffu);
        *reinterpret_cast<uint4*>(nl + u) = bytes16(learned16);
        uint4 b = ld16(sl + u);
        unsigned w[4] = {b.x, b.y, b.z, b.w};
        for (unsigned touched = learned16 | served16; touched;
             touched &= touched - 1) {
          const int j = __ffs(touched) - 1;
          const int cur = static_cast<int8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
          w[j >> 2] = set_byte(w[j >> 2], j & 3,
                               next_budget(cur, (learned16 >> j) & 1u,
                                           (served16 >> j) & 1u, limit, G));
        }
        *reinterpret_cast<uint4*>(ns + u) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    for (; u < S; ++u) {
      const bool learned = (nw >> u) & 1ull;
      nk[u] = ((own | nw) >> u) & 1ull;
      nl[u] = learned ? 1 : 0;
      ns[u] = static_cast<int8_t>(next_budget(sl[u], learned,
                                              (serve >> u) & 1ull, limit, G));
    }
  }
  if (block_accumulate<3>(v, acc)) {
    const u64 delivered = take(&acc[0]);
    const u64 cells = take(&acc[1]);
    const u64 lost = take(&acc[2]);
    take(&acc[3]);
    counters[0] = static_cast<float>(delivered);
    counters[1] = static_cast<float>(cells) * static_cast<float>(G);
    counters[2] = static_cast<float>(lost);
  }
}

}  // namespace

extern "C" int gossip_disseminate(const void* know, const void* sends,
                                  const void* offsets, int G,
                                  const void* sender_ok, const void* receiver_ok,
                                  const void* slot_active, const void* ok,
                                  int64_t N, int S, int limit, void* new_know,
                                  void* new_sends, void* newly, void* acc,
                                  void* counters, void* stream) {
  if (G < 1 || G > kMaxFanout) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int64_t blocks = (N + threads - 1) / threads;
  gossip_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(know), static_cast<const int8_t*>(sends),
      static_cast<const int32_t*>(offsets), G,
      static_cast<const uint8_t*>(sender_ok),
      static_cast<const uint8_t*>(receiver_ok),
      static_cast<const uint8_t*>(slot_active),
      static_cast<const uint8_t*>(ok), N, S, limit,
      static_cast<uint8_t*>(new_know), static_cast<int8_t*>(new_sends),
      static_cast<uint8_t*>(newly), static_cast<u64*>(acc),
      static_cast<float*>(counters));
  return static_cast<int>(cudaGetLastError());
}
