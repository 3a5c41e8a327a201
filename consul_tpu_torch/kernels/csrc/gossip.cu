// K2 gossip: one fanout round of infection-style gossip over the [N, S]
// knowledge matrix, with the swim caller's learn-tick stamp and counter
// update and the per-contact loss draw folded in.  Two launches:
// gossip_pack, then gossip_exchange.
//
// Replaces: consul_tpu/ops/gossip.py disseminate (both paths), which
// XLA runs as G dynamic slices of a doubled [2N, S] buffer built by
// ops/rolls.py pull_multi, fused with the mask algebra and three
// reductions; plus, for the swim caller, the learn-tick `where` and the
// counter adds of consul_tpu/models/swim.py _disseminate, and the
// jax.random.bernoulli [N, G] loss mask the pass consumes.
//
// Bound on an H100: memory.  The function must read know, sends_left and
// (swim caller) learn_tick once, write them once, and read the [N]
// sender/receiver flags: 8 * N * S + 2 * N bytes for S = 32 with a stamp,
// ~258 MB at N = 1M, 0.077 ms at 3.35 TB/s.  Row r is also the peer of
// the rows r - offsets[g]; the offsets are random over [1, N), so reading
// peer ROWS re-reads each row G more times from HBM (the 50 MB L2 cannot
// hold the reuse distance).  The design:
//
//   pack:     reads know and sends_left once and writes two words per
//             row, its know mask and its queued mask (know & sends > 0 &
//             sender_ok): 4 bytes each for S <= 32, 8 for S <= 64, 8 MB
//             together at N = 1M.
//   exchange: row i ORs the G peers' queued words, which stay in L2,
//             after dropping the contacts the loss draw loses, and writes
//             its output rows in one pass: know from its own know word
//             (the know bytes are not read again), sends_left read once
//             (budget spent where queued, the full limit where learned),
//             learn_tick read once and stamped where learned, newly when
//             asked.  Delivered, served and lost are popcounts of the
//             words; the last block publishes them and, for the swim
//             caller, ctr + [.., delivered, served, lost] (its last three
//             entries) as a fresh float32 vector.
//
// Both passes give a row S / 16 (pack) or S / 8 (exchange) lanes, one
// 16- or 8-slot chunk each, so a warp's loads and stores cover contiguous
// bytes, with evict-first hints on the row streams so the words stay in
// L2; the lanes of a row share its words and split its G contacts, and
// combine them with shuffles.  Other S (or unaligned rows) take one
// thread per row, byte by byte.  Loss: contact (i, g) is delivered when
// jax.random.uniform's float of element i*G + g of the threefry stream of
// the tick's key is < 1 - p_loss, the exact bits of prng.bernoulli, drawn
// only for contacts whose sender queues something.  Offsets are reduced
// modulo N in 32-bit arithmetic (N < 2^31 is checked); rolls.offsets
// draws them in [1, N).  Outputs go to fresh buffers: callers hold the
// old state across ticks.
//
// Blocks (a node-sharded pool, parallel/mesh.py): the pack runs per block
// over its L rows, as on one device.  The exchange runs per block over
// rows [row0, row0 + rows) and reads every peer's word (and, in chaos
// mode, group and rate) through block tables (common.cuh:BlockRows), so a
// peer row may sit in another block, on this card or on a peer card; the
// one-device launch is the B = 1 table.  Row indices stay global: the
// loss draw's element is i*G + g for the global row i, so a sharded
// round draws what the unsharded one draws.  A per-block launch writes
// its integer totals to its own [3] slot of `partial`; gossip_combine
// then adds the B slots in block order and publishes them as the
// one-device launch does, so the counters are the same integers whatever
// B is and their float32 values the same bits.
//
// Chaos mode (the nemesis build, consul_tpu/ops/gossip.py:82-100): with a
// partition group [N] int16 and/or a per-node delivery rate [N] float32,
// contact (i, g) with sender j = (i + off_g) % N exists only where
// group[i] == group[j] (a severed link neither delivers nor counts as
// lost), and delivers when the same uniform float is < (p_ok * ok[i]) *
// ok[j], rounded step by step as the plain twin multiplies.  The draw is
// the non-chaos stream's; only its threshold becomes per contact.  The
// extra reads are 6 bytes a row plus the peers' values through L2; with
// both pointers null the exchange is the non-chaos one, bit for bit.

#include "common.cuh"

using namespace consul_kernels;

namespace {

constexpr int kMaxFanout = 16;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int popc(uint32_t w) { return __popc(w); }
__device__ __forceinline__ int popc(uint64_t w) { return __popcll(w); }
__device__ __forceinline__ uint32_t or_lanes(uint32_t w, int o) {
  return w | __shfl_xor_sync(kFull, w, o);
}
__device__ __forceinline__ uint64_t or_lanes(uint64_t w, int o) {
  return w | static_cast<uint64_t>(__shfl_xor_sync(kFull, static_cast<u64>(w), o));
}

__device__ __forceinline__ int log2_lanes(int lanes) {
  return lanes == 1 ? 0 : lanes == 2 ? 1 : lanes == 4 ? 2 : 3;
}

// A 4-bit mask as 0xff in each set byte (bit j -> byte j).
__device__ __forceinline__ unsigned byte_mask4(unsigned m) {
  return (((m & 0xfu) * 0x00204081u) & 0x01010101u) * 0xffu;
}

// The budget word b (four int8) after a round: max(b - G, 0) where queued
// (qm), the full limit where learned (lm), else unchanged.
__device__ __forceinline__ unsigned next_sends(unsigned b, unsigned qm,
                                               unsigned lm, unsigned gsub,
                                               unsigned lim4) {
  const unsigned spent = __vmaxs4(__vsubss4(b, gsub), 0u);
  const unsigned x = (spent & qm) | (b & ~qm);
  return (lim4 & lm) | (x & ~lm);
}

// Two int16 learn ticks in w: tick16 in each half whose bit of m2 is set.
__device__ __forceinline__ unsigned stamp2(unsigned w, unsigned m2,
                                           unsigned t2) {
  const unsigned m = ((m2 & 1u) ? 0x0000ffffu : 0u) | ((m2 & 2u) ? 0xffff0000u : 0u);
  return (t2 & m) | (w & ~m);
}

template <typename W>
__global__ void __launch_bounds__(kThreads) gossip_pack_kernel(
    const uint8_t* __restrict__ know, const int8_t* __restrict__ sends,
    const uint8_t* __restrict__ sender_ok, int64_t N, int S, int vec,
    W* __restrict__ kword, W* __restrict__ qword) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!vec) {
    for (int64_t i = tid; i < N; i += stride) {
      const bool snd = sender_ok[i] != 0;
      u64 km = 0, qm = 0;
      for (int u = 0; u < S; ++u) {
        const bool k = know[i * S + u] != 0;
        if (k) km |= 1ull << u;
        if (k && snd && sends[i * S + u] > 0) qm |= 1ull << u;
      }
      kword[i] = static_cast<W>(km);
      qword[i] = static_cast<W>(qm);
    }
    return;
  }
  const int lanes = S / 16, shift = log2_lanes(lanes);
  const int64_t items = N << shift;  // (row, 16-slot chunk) pairs
  const int lane = threadIdx.x & 31;
  // warp-uniform trip count, so every lane reaches the shuffles
  for (int64_t item0 = tid - lane; item0 < items; item0 += stride) {
    const int64_t item = item0 + lane;
    const int chunk = static_cast<int>(item & (lanes - 1));
    W km = 0, qm = 0;
    if (item < items) {
      const int64_t row = item >> shift;
      const int64_t off = row * S + 16 * chunk;
      const uint4 k = __ldcs(reinterpret_cast<const uint4*>(know + off));
      const uint4 b = __ldcs(reinterpret_cast<const uint4*>(sends + off));
      const uint4 nz = make_uint4(nonzero_bytes(k.x), nonzero_bytes(k.y),
                                  nonzero_bytes(k.z), nonzero_bytes(k.w));
      km = static_cast<W>(flags16(nz)) << (16 * chunk);
      if (sender_ok[row]) {
        qm = static_cast<W>(flags16(make_uint4(
                 nz.x & positive_bytes(b.x), nz.y & positive_bytes(b.y),
                 nz.z & positive_bytes(b.z), nz.w & positive_bytes(b.w))))
             << (16 * chunk);
      }
    }
    for (int o = 1; o < lanes; o <<= 1) {
      km = or_lanes(km, o);
      qm = or_lanes(qm, o);
    }
    if (item < items && chunk == 0) {
      kword[item >> shift] = km;
      qword[item >> shift] = qm;
    }
  }
}

// The three totals as the plain twin rounds them: each integer converted
// once, served times G, each added to ctr once (no FMA).
__device__ __forceinline__ void publish(const u64 (&tot)[3], int G, float* counters,
                                        const float* ctr, float* ctr_out, int C) {
  const float out[3] = {__ull2float_rn(tot[0]),
                        __fmul_rn(__ull2float_rn(tot[1]), static_cast<float>(G)),
                        __ull2float_rn(tot[2])};
  counters[0] = out[0];
  counters[1] = out[1];
  counters[2] = out[2];
  if (ctr_out != nullptr) {
    for (int k = 0; k < C; ++k) {
      const int j = k - (C - 3);
      ctr_out[k] = __fadd_rn(ctr[k], (j >= 0 && j < 3) ? out[j] : 0.0f);
    }
  }
}

// kOne: compiled for the one-device launch (B = 1), whose table reads are
// plain indexed loads
template <typename W, bool kOne>
__global__ void __launch_bounds__(kThreads) gossip_exchange_kernel(
    const __grid_constant__ BlockRows<W> kword,
    const __grid_constant__ BlockRows<W> qword,
    int64_t row0, int64_t rows,
    const int32_t* __restrict__ offsets, int G,
    const uint8_t* __restrict__ receiver_ok,
    const uint8_t* __restrict__ slot_active, const int8_t* __restrict__ sends,
    const int16_t* __restrict__ learn, int64_t N, int S, int vec,
    uint32_t k0, uint32_t k1, int lossy, float p_ok,
    const __grid_constant__ BlockRows<int16_t> group,
    const __grid_constant__ BlockRows<float> node_ok,
    int limit, int tick16,
    uint8_t* __restrict__ new_know, int8_t* __restrict__ new_sends,
    int16_t* __restrict__ new_learn, uint8_t* __restrict__ newly,
    u64* __restrict__ scratch, float* __restrict__ counters,
    const float* __restrict__ ctr, float* __restrict__ ctr_out, int C,
    u64* __restrict__ partial) {
  __shared__ int32_t s_off[kMaxFanout];
  __shared__ uint64_t s_active;
  if (threadIdx.x < G) {
    const int32_t n32 = static_cast<int32_t>(N);
    const int32_t off = offsets[threadIdx.x] % n32;
    s_off[threadIdx.x] = off < 0 ? off + n32 : off;
  }
  if (threadIdx.x < 32) {
    const uint64_t m = warp_slot_mask(slot_active, S);
    if (threadIdx.x == 0) s_active = m;
  }
  __syncthreads();
  const W active = static_cast<W>(s_active);
  const bool grouped = group.base[0] != nullptr;
  const bool rated = node_ok.base[0] != nullptr;

  u64 v[3] = {0, 0, 0};  // delivered cells, own queued cells, lost cells
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the peers' queued cells reaching global row i over contacts g0,
  // g0 + step, ..
  auto gather = [&](int64_t i, int g0, int step) -> W {
    W got = 0;
    for (int g = g0; g < G; g += step) {
      int64_t src = i + s_off[g];
      if (src >= N) src -= N;
      const W w = qword.template at<kOne>(src);
      if (w == 0) continue;  // nothing carried: the draw cannot matter
      if (grouped && group.template at<kOne>(i) != group.template at<kOne>(src)) {
        continue;  // severed
      }
      float p = p_ok;
      if (rated) {
        p = __fmul_rn(__fmul_rn(p_ok, node_ok.template at<kOne>(i)),
                      node_ok.template at<kOne>(src));
      }
      const bool ok = !lossy || unit_float(threefry_xor(
          k0, k1, static_cast<uint64_t>(i) * G + g)) < p;
      if (ok) {
        got |= w;
      } else {
        v[2] += popc(w);
      }
    }
    return got;
  };

  if (!vec) {
    for (int64_t r = tid; r < rows; r += stride) {
      const int64_t i = row0 + r;
      const W got = gather(i, 0, 1);
      const W kw = kword.template at<kOne>(i), qw = qword.template at<kOne>(i);
      const W nw = receiver_ok[r] ? (got & active & ~kw) : W(0);
      v[0] += popc(nw);
      v[1] += popc(qw);
      const int64_t base = r * S;
      for (int u = 0; u < S; ++u) {
        const bool learned = (nw >> u) & 1u;
        const int b = sends[base + u];
        new_know[base + u] = ((kw | nw) >> u) & 1u;
        new_sends[base + u] = static_cast<int8_t>(
            learned ? limit : ((qw >> u) & 1u) ? (b - G > 0 ? b - G : 0) : b);
        if (new_learn != nullptr) {
          new_learn[base + u] = learned ? static_cast<int16_t>(tick16) : learn[base + u];
        }
        if (newly != nullptr) newly[base + u] = learned ? 1 : 0;
      }
    }
  } else {
    const int lanes = S / 8, shift = log2_lanes(lanes);
    const int64_t items = rows << shift;  // (row, 8-slot chunk) pairs
    const int lane = threadIdx.x & 31;
    const unsigned gsub = 0x01010101u * static_cast<unsigned>(G);
    const unsigned lim4 = 0x01010101u * static_cast<unsigned>(limit & 0xff);
    const unsigned t2 = 0x00010001u * static_cast<unsigned>(tick16 & 0xffff);
    for (int64_t item0 = tid - lane; item0 < items; item0 += stride) {
      const int64_t item = item0 + lane;
      const bool live = item < items;
      const int64_t row = item >> shift;  // the block's row; row0 + row global
      const int chunk = static_cast<int>(item & (lanes - 1));
      const int64_t off = row * S + 8 * chunk;
      uint2 b = make_uint2(0u, 0u);
      uint4 lt = make_uint4(0u, 0u, 0u, 0u);
      W got = 0, kw = 0, qw = 0;
      bool recv = false;
      if (live) {  // the row streams first, so their loads overlap the gather
        b = __ldcs(reinterpret_cast<const uint2*>(sends + off));
        if (new_learn != nullptr) lt = __ldcs(reinterpret_cast<const uint4*>(learn + off));
        kw = kword.template at<kOne>(row0 + row);
        qw = qword.template at<kOne>(row0 + row);
        recv = receiver_ok[row] != 0;
        got = gather(row0 + row, chunk, lanes);
      }
      for (int o = 1; o < lanes; o <<= 1) got = or_lanes(got, o);
      if (!live) continue;  // warp-uniform trips: only the shuffles need all lanes
      const W nw = recv ? (got & active & ~kw) : W(0);
      if (chunk == 0) {
        v[0] += popc(nw);
        v[1] += popc(qw);
      }
      const unsigned n8 = static_cast<unsigned>(nw >> (8 * chunk)) & 0xffu;
      const unsigned k8 = static_cast<unsigned>(kw >> (8 * chunk)) & 0xffu;
      const unsigned q8 = static_cast<unsigned>(qw >> (8 * chunk)) & 0xffu;
      const unsigned kn = k8 | n8;
      __stcs(reinterpret_cast<uint2*>(new_know + off),
             make_uint2(byte_mask4(kn) & 0x01010101u,
                        byte_mask4(kn >> 4) & 0x01010101u));
      __stcs(reinterpret_cast<uint2*>(new_sends + off),
             make_uint2(next_sends(b.x, byte_mask4(q8), byte_mask4(n8), gsub, lim4),
                        next_sends(b.y, byte_mask4(q8 >> 4), byte_mask4(n8 >> 4),
                                   gsub, lim4)));
      if (new_learn != nullptr) {
        __stcs(reinterpret_cast<uint4*>(new_learn + off),
               make_uint4(stamp2(lt.x, n8, t2), stamp2(lt.y, n8 >> 2, t2),
                          stamp2(lt.z, n8 >> 4, t2), stamp2(lt.w, n8 >> 6, t2)));
      }
      if (newly != nullptr) {
        __stcs(reinterpret_cast<uint2*>(newly + off),
               make_uint2(byte_mask4(n8) & 0x01010101u,
                          byte_mask4(n8 >> 4) & 0x01010101u));
      }
    }
  }
  u64 tot[3];
  if (grid_sum<3>(v, scratch, tot)) {
    if (partial != nullptr) {  // one block of a sharded round: its own slot
      partial[0] = tot[0];
      partial[1] = tot[1];
      partial[2] = tot[2];
    } else {
      publish(tot, G, counters, ctr, ctr_out, C);
    }
  }
}

// The B blocks' [3] partials added in block order, then published.
__global__ void gossip_combine_kernel(const u64* __restrict__ partials, int B, int G,
                                      float* __restrict__ counters,
                                      const float* __restrict__ ctr,
                                      float* __restrict__ ctr_out, int C) {
  if (threadIdx.x != 0) return;
  u64 tot[3] = {0, 0, 0};
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < 3; ++k) tot[k] += partials[3 * b + k];
  }
  publish(tot, G, counters, ctr, ctr_out, C);
}

template <typename W>
int pack(const void* know, const void* sends, const void* sender_ok,
         int64_t N, int S, int vec, void* kword, void* qword,
         cudaStream_t stream) {
  static PerCard per_card;
  const int blocks = persistent_blocks(gossip_pack_kernel<W>, kThreads,
                                       vec ? N * (S / 16) : N, 1 << 20, per_card);
  gossip_pack_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(know), static_cast<const int8_t*>(sends),
      static_cast<const uint8_t*>(sender_ok), N, S, vec,
      static_cast<W*>(kword), static_cast<W*>(qword));
  return static_cast<int>(cudaGetLastError());
}

template <typename W, bool kOne>
int exchange(const void* kword, const void* qword, int B, int64_t L,
             int64_t row0, int64_t rows, const void* offsets, int G,
             const void* receiver_ok, const void* slot_active,
             const void* sends, const void* learn, int S, int vec,
             uint32_t k0, uint32_t k1, int lossy, float p_ok,
             const void* group, const void* node_ok, int limit,
             int tick16, void* new_know, void* new_sends, void* new_learn,
             void* newly, void* scratch, int scratch_blocks, void* counters,
             const void* ctr, void* ctr_out, int C, void* partial,
             cudaStream_t stream) {
  static PerCard per_card;
  const int blocks = persistent_blocks(gossip_exchange_kernel<W, kOne>, kThreads,
                                       vec ? rows * (S / 8) : rows, scratch_blocks,
                                       per_card);
  gossip_exchange_kernel<W, kOne><<<blocks, kThreads, 0, stream>>>(
      block_rows<W>(kword, B, L), block_rows<W>(qword, B, L), row0, rows,
      static_cast<const int32_t*>(offsets), G,
      static_cast<const uint8_t*>(receiver_ok),
      static_cast<const uint8_t*>(slot_active),
      static_cast<const int8_t*>(sends), static_cast<const int16_t*>(learn),
      static_cast<int64_t>(B) * L, S, vec, k0, k1, lossy, p_ok,
      block_rows<int16_t>(group, B, L), block_rows<float>(node_ok, B, L),
      limit, tick16,
      static_cast<uint8_t*>(new_know), static_cast<int8_t*>(new_sends),
      static_cast<int16_t*>(new_learn), static_cast<uint8_t*>(newly),
      static_cast<u64*>(scratch), static_cast<float*>(counters),
      static_cast<const float*>(ctr), static_cast<float*>(ctr_out), C,
      static_cast<u64*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// The word width and the table form: B = 1 takes the kernel compiled for
// one block.
template <typename W>
int exchange_any(int B, const void* kword, const void* qword, int64_t L,
                 int64_t row0, int64_t rows, const void* offsets, int G,
                 const void* receiver_ok, const void* slot_active,
                 const void* sends, const void* learn, int S, int vec,
                 uint32_t k0, uint32_t k1, int lossy, float p_ok,
                 const void* group, const void* node_ok, int limit,
                 int tick16, void* new_know, void* new_sends, void* new_learn,
                 void* newly, void* scratch, int scratch_blocks, void* counters,
                 const void* ctr, void* ctr_out, int C, void* partial,
                 cudaStream_t stream) {
  auto run = B == 1 ? exchange<W, true> : exchange<W, false>;
  return run(kword, qword, B, L, row0, rows, offsets, G, receiver_ok, slot_active,
             sends, learn, S, vec, k0, k1, lossy, p_ok, group, node_ok, limit,
             tick16, new_know, new_sends, new_learn, newly, scratch,
             scratch_blocks, counters, ctr, ctr_out, C, partial, stream);
}

bool valid(int64_t N, int S, int G) {
  return N >= 1 && N < (int64_t{1} << 31) && S >= 1 && S <= 64 && G >= 1 &&
         G <= kMaxFanout;
}

}  // namespace

// Words are uint32 for S <= 32 and uint64 for S <= 64; vec != 0 takes the
// lanes-per-row path (S = 16, 32 or 64, every row buffer 16-byte aligned).
extern "C" int gossip_pack(const void* know, const void* sends,
                           const void* sender_ok, int64_t N, int S, int vec,
                           void* kword, void* qword, void* stream) {
  if (!valid(N, S, 1) || (vec && S != 16 && S != 32 && S != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return S <= 32 ? pack<uint32_t>(know, sends, sender_ok, N, S, vec, kword, qword, st)
                 : pack<uint64_t>(know, sends, sender_ok, N, S, vec, kword, qword, st);
}

// kword, qword, group and node_ok are host arrays of B block base pointers
// (group and node_ok null outside chaos mode), L rows a block; the launch
// covers rows [row0, row0 + rows) of the N = B * L, whose own buffers
// (receiver_ok, sends, learn and the outputs) start at that block's row 0.
// With `partial` (3 u64) the launch writes its totals there and leaves
// counters and ctr_out to gossip_combine.
extern "C" int gossip_exchange(const void* kword, const void* qword, int B,
                               int64_t L, int64_t row0, int64_t rows,
                               const void* offsets, int G,
                               const void* receiver_ok,
                               const void* slot_active, const void* sends,
                               const void* learn, int S, int vec,
                               uint32_t k0, uint32_t k1, int lossy,
                               float p_ok, const void* group,
                               const void* node_ok, int limit, int tick16,
                               void* new_know, void* new_sends,
                               void* new_learn, void* newly, void* scratch,
                               int scratch_blocks, void* counters,
                               const void* ctr, void* ctr_out, int C,
                               void* partial, void* stream) {
  const int64_t N = static_cast<int64_t>(B) * L;
  if (!valid(N, S, G) || B < 1 || B > kMaxBlocks || scratch_blocks < 1 ||
      row0 < 0 || rows < 1 || row0 + rows > N ||
      (partial == nullptr && counters == nullptr) ||
      (vec && S != 16 && S != 32 && S != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto run = S <= 32 ? exchange_any<uint32_t> : exchange_any<uint64_t>;
  return run(B, kword, qword, L, row0, rows, offsets, G, receiver_ok, slot_active,
             sends, learn, S, vec, k0, k1, lossy, p_ok, group, node_ok, limit,
             tick16, new_know, new_sends, new_learn, newly, scratch,
             scratch_blocks, counters, ctr, ctr_out, C, partial, st);
}

// The sharded round's totals: partials [B * 3] u64 in block order into
// counters [3] and ctr_out = ctr + them (ctr null: no counter vector).
extern "C" int gossip_combine(const void* partials, int B, int G,
                              void* counters, const void* ctr, void* ctr_out,
                              int C, void* stream) {
  if (B < 1 || G < 1 || G > kMaxFanout || partials == nullptr || counters == nullptr ||
      (ctr == nullptr) != (ctr_out == nullptr) || (ctr != nullptr && C < 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gossip_combine_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(partials), B, G, static_cast<float*>(counters),
      static_cast<const float*>(ctr), static_cast<float*>(ctr_out), C);
  return static_cast<int>(cudaGetLastError());
}

// Peer access from card a to card b (both indices of this process's
// devices): 0 when a can reach b's memory (enabled now or before), else
// the CUDA error, cudaErrorPeerAccessUnsupported when the pair cannot.
extern "C" int enable_peer_access(int a, int b) {
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, a, b);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int was = 0;
  cudaGetDevice(&was);
  cudaSetDevice(a);
  rc = cudaDeviceEnablePeerAccess(b, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error the call left behind
    rc = cudaSuccess;
  }
  cudaSetDevice(was);
  return static_cast<int>(rc);
}
