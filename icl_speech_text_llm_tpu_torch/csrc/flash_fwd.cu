// Flash-attention forward, causal and non-causal, for Hopper (sm_90a).
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   _flash_forward / _flash_kernel            (causal, LLM prefill)
//   _flash_forward_noncausal / _flash_inf_kernel (non-causal, Whisper encoder)
//
// What bounds it on the H100. At the Whisper shape (24, 20, 1500, 64),
// non-causal, the tensor cores and the special-function unit are about
// equal: 276 GFLOP is 0.28 ms at the bf16 peak, and the 1.08e9 exp2 are
// ~0.29 ms at 16 MUFU.EX2 a clock per SM. So the exponentials of one key
// tile must run while the matrix products of another are in flight, or the
// kernel cannot come near its bound. At the LLM prefill shape (4, 32, 1024,
// 128), causal with ragged key lengths, the work is small (34 GFLOP,
// 0.035 ms) and uneven: a query tile near the diagonal of a long sample
// does up to 8× the key tiles of one near the top, so the tail of the grid
// and the partly masked diagonal tiles are what cost.
//
// What the design does about it:
// - Block: the query rows of one (sample, head) split over consumer
//   warpgroups of 64 rows each, plus one producer warpgroup: three consumers
//   (192 rows) at D = 64, where the softmax is the larger share and a third
//   warpgroup keeps the tensor cores fed while two compute exponentials;
//   two (128 rows) at D = 128, whose 64 + 64 accumulator registers leave no
//   room for a third. setmaxnreg moves registers from the producer to the
//   consumers (32 → 160 a thread at D = 64, 56 → 224 at D = 128).
// - Loads: one thread of the producer issues TMA copies (cp.async.bulk.tensor,
//   rank-4 tensor maps {D, S, H, B} built on the host from the strides, so
//   model views such as .view(B, T, H, hd).transpose(1, 2) are read in place)
//   with the 128-byte swizzle: Q once, then K and V tiles of 128 keys into a
//   ring of stages (4 at D = 64, 3 at D = 128) guarded by mbarriers, "full"
//   (transaction bytes) and "empty" (one arrival per consumer warp). A box is
//   at most 64 bf16 wide under this swizzle, so D = 128 loads two boxes a
//   tile. Tiles wholly past the sample's length or above the diagonal are
//   never loaded; rows past S are zero-filled by TMA and masked by index.
// - Products: S = Q·Kᵀ as wgmma m64n128k16 with both operands K-major in
//   shared memory; O += P·V as wgmma m64nDk16 with P from registers (the S
//   accumulator rounded to bf16 A fragments, no trip through shared memory)
//   and V read MN-major through the descriptor's transpose flag. The
//   warpgroup index is broadcast from lane 0, so the compiler knows it is
//   uniform and keeps the descriptors in uniform registers; without that the
//   D = 128 kernel spilled and ptxas serialised every wgmma.
// - Overlap: inside a warpgroup, tile j's Q·Kᵀ is issued together with tile
//   j − 1's P·V, and tile j's softmax runs while P·V is in flight; the
//   consumer warpgroups take turns to issue (named barriers 1..NC, round
//   robin), so one warpgroup's exponentials run under another's products.
// - Softmax in f32 in the exp2 domain: the row max is kept in raw-score
//   units and p = exp2(s·scale·log2e − m·scale·log2e) is one FMA and one
//   MUFU.EX2; P is rounded to bf16 for P·V, the row sum l stays f32. (An FMA
//   polynomial for part of the exp2 was tried and was slower: the card is
//   not MUFU-bound here.)
// - Grid: persistent, one block per SM. Each block walks work items (a
//   block of query rows of one sample and head) in zig-zag order over the
//   grid, so one item's epilogue and the next one's Q load overlap the K/V
//   stream, which runs on through the ring from item to item (the Q buffer
//   has its own full/empty barriers). Items are numbered with the query
//   tile fastest, so the blocks in flight share a few heads' K/V in L2;
//   for causal the tiles of a head go heaviest first, and the zig-zag gives
//   a block that took a heavy tile a light one next. An item of a sample
//   with no valid key writes o = 0, m = −inf, l = 0 at once.
// - GQA reads kv head h / (H / Hkv) through the tensor map, no repeated copy.
// - The tensor maps are encoded on the host for every call with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no link
//   against libcuda).
//
// The PTX wrappers, the softmax of a score tile and the tensor-map encoding
// live in hopper.cuh, shared with the gated-bias kernel (gated_bias.cu).
#include <algorithm>

#include "hopper.cuh"

namespace iclk {
namespace {

// NC consumer warpgroups of 64 query rows each, plus the producer.
template <int D, int NC>
struct Cfg {
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBlockM = NC * kRowsWG;            // query rows of a block
  static constexpr int kBoxes = D / 64;                   // boxes across the head dim
  static constexpr int kStages = D == 64 ? 4 : 3;         // K/V ring depth
  static constexpr int kQBoxBytes = NC * kWGBoxBytes;     // one Q box
  static constexpr int kQBytes = kBoxes * kQBoxBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;      // K and V
  static constexpr int kBarBytes = 8 * (2 * kStages + 2);
  // + 1024: the base is rounded up to the 1024-byte swizzle atom
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + kBarBytes + 1024;
  // Registers a thread: the block is given kLaunchRegs for every thread;
  // setmaxnreg then moves them from the producer to the consumers, so the
  // two counts must fit in what the block holds (in steps of 8).
  static constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
  static constexpr int kProducerRegs = NC == 2 ? 56 : 32;
  static constexpr int kConsumerRegs =
      ((kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * NC)) / 8 * 8;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct FwdArgs {
  bf16* o;
  float* m_out;        // (B, H, S) row max, e-domain; may be null
  float* l_out;        // (B, H, S) row sum; may be null
  const int* lengths;  // (B,) valid key count; null = all S_kv keys
  int B, H, Hkv, S, S_kv;
  long long o_sb, o_sh, o_ss;  // element strides of o (head dim contiguous)
  float sm_scale;
};

// ---------------------------------------------------------- consumer ----

// Shared-memory layout from the 1024-aligned base: the Q tile (kBoxes boxes
// of kBlockM rows × 128 bytes), then the stages (K tile, V tile: kBoxes boxes
// of 128 rows × 128 bytes each), then the barriers: full[stages],
// empty[stages], q_full, q_empty.
template <int D, int NC>
struct Smem {
  using C = Cfg<D, NC>;
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int st) const { return base + C::kQBytes + st * C::kStageBytes; }
  __device__ uint32_t v(int st) const { return k(st) + C::kTileBytes; }
  __device__ uint32_t full(int st) const {
    return base + C::kQBytes + C::kStages * C::kStageBytes + 8 * st;
  }
  __device__ uint32_t empty(int st) const { return full(C::kStages + st); }
  __device__ uint32_t q_full() const { return full(2 * C::kStages); }
  __device__ uint32_t q_empty() const { return full(2 * C::kStages + 1); }
};

// s = Q_wg · K_tileᵀ: k-step kk reads 32 bytes into box kk / 4 of each row.
template <int D, int NC>
__device__ __forceinline__ void issue_scores(float (&s)[64], const Smem<D, NC>& sm, int c,
                                             int st) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t q_off = (kk / 4) * Cfg<D, NC>::kQBoxBytes + c * kWGBoxBytes + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, smem_desc(sm.q() + q_off, 16, 1024), smem_desc(sm.k(st) + k_off, 16, 1024),
                  kk > 0);
  }
}

// o += P · V_tile: k-step kk covers keys 16kk..16kk+15 (two 8-row swizzle
// atoms, 2048 bytes); the head dim runs across the boxes (LBO = one box).
template <int D, int NC>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pr)[32],
                                         const Smem<D, NC>& sm, int st) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t db = smem_desc(sm.v(st) + kk * 2048, kBoxBytes, 1024);
    if constexpr (D == 64)
      wgmma_rs_n64(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3], db);
    else
      wgmma_rs_n128(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3], db);
  }
}

// One work item: a block of query rows of one (sample, head), and the key
// tiles it reads.
struct Work {
  int q0, h, hk, b, len, n_tiles;
};

// Work items are numbered (b, h, query tile) with the query tile fastest,
// so the blocks in flight share the K/V of a few heads in L2; for causal
// the query tiles of a head run from the heaviest (the last rows) down.
template <bool CAUSAL, int BLOCK_M>
__device__ __forceinline__ Work work_of(const FwdArgs& p, int item, int n_q) {
  Work w;
  const int r = item % n_q, bh = item / n_q;
  w.q0 = (CAUSAL ? n_q - 1 - r : r) * BLOCK_M;
  w.h = bh % p.H;
  w.b = bh / p.H;
  w.hk = w.h / (p.H / p.Hkv);
  w.len = p.lengths == nullptr ? p.S_kv : min(max(p.lengths[w.b], 0), p.S_kv);
  const int kv_end = CAUSAL ? min(w.len, w.q0 + BLOCK_M) : w.len;
  w.n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  return w;
}

// One consumer warpgroup's share of a work item: rows r_wg..r_wg + 63.
// `q_phase` is the parity of this item's Q load, `t0` the ring index of its
// first key tile (tile j sits in stage (t0 + j) % kStages).
template <int D, bool CAUSAL, int NC>
__device__ __forceinline__ void consumer_item(const FwdArgs& p, const Smem<D, NC>& sm, int c,
                                              const Work& w, uint32_t q_phase, int t0) {
  using C = Cfg<D, NC>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r_wg = w.q0 + c * kRowsWG;  // first query row of this warpgroup
  const int row0 = r_wg + warp * 16 + g;
  const float scale2 = p.sm_scale * kLog2eF;
  const int n_tiles = w.n_tiles;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  if (n_tiles > 0) {
    // Turns between the consumer warpgroups, round robin: warpgroup c
    // issues its products after bar.sync on barrier 1 + c, then releases
    // the next one by bar.arrive on its barrier. Consumer 0 goes first; the
    // last consumer skips its last release of the item, which no one waits
    // for, so that every item starts from the same state.
    const int next = c + 1 == NC ? 0 : c + 1;
    const bool last_wg = c == NC - 1;
    if (last_wg) named_bar_arrive(1, 2 * 128);
    auto need_mask = [&](int kv0) {
      return kv0 + kBlockN > w.len || (CAUSAL && kv0 + kBlockN - 1 > r_wg);
    };
    auto stage = [&](int j) { return (t0 + j) % C::kStages; };
    auto phase = [&](int j) { return (uint32_t)((t0 + j) / C::kStages) & 1u; };
    float s[64];
    uint32_t pr[32];
    float alpha[2];

    mbar_wait(sm.q_full(), q_phase);
    named_bar_sync(1 + c, 2 * 128);
    mbar_wait(sm.full(stage(0)), phase(0));
    wgmma_fence();
    issue_scores<D, NC>(s, sm, c, stage(0));
    wgmma_commit();
    if (!last_wg || n_tiles > 1) named_bar_arrive(1 + next, 2 * 128);
    wgmma_wait<0>();
    fence_regs(s);
    if (n_tiles == 1 && lane == 0) mbar_arrive(sm.q_empty());  // Q read for the last time
    softmax_tile<CAUSAL>(s, m, l, alpha, need_mask(0), 0, w.len, row0, t, scale2);
    scores_to_a(pr, s);

    for (int j = 1; j < n_tiles; ++j) {
      named_bar_sync(1 + c, 2 * 128);
      mbar_wait(sm.full(stage(j)), phase(j));
      wgmma_fence();
      issue_scores<D, NC>(s, sm, c, stage(j));
      wgmma_commit();
      issue_pv<D, NC>(o, pr, sm, stage(j - 1));
      wgmma_commit();
      if (!last_wg || j < n_tiles - 1) named_bar_arrive(1 + next, 2 * 128);
      wgmma_wait<1>();  // the scores of tile j; P·V of tile j − 1 runs on
      fence_regs(s);
      if (j == n_tiles - 1 && lane == 0) mbar_arrive(sm.q_empty());
      softmax_tile<CAUSAL>(s, m, l, alpha, need_mask(j * kBlockN), j * kBlockN, w.len, row0,
                           t, scale2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pr);
      if (lane == 0) mbar_arrive(sm.empty(stage(j - 1)));
      rescale<D>(o, alpha);
      scores_to_a(pr, s);
    }
    wgmma_fence();
    issue_pv<D, NC>(o, pr, sm, stage(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pr);
    if (lane == 0) mbar_arrive(sm.empty(stage(n_tiles - 1)));
  }

  // Epilogue: normalise by l and store rows < S; m in the e-domain and l.
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float lr = l[ri];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * ri;
    if (row >= p.S) continue;
    const float inv = lr == 0.f ? 1.f : 1.f / lr;
    bf16* orow =
        p.o + (long long)w.b * p.o_sb + (long long)w.h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * t) =
          pack_bf16(o[4 * i + 2 * ri] * inv, o[4 * i + 2 * ri + 1] * inv);
    if (p.m_out != nullptr && t == 0) {
      const long long idx = ((long long)w.b * p.H + w.h) * p.S + row;
      p.m_out[idx] = m[ri] * p.sm_scale;
      p.l_out[idx] = lr;
    }
  }
}

// A persistent grid: one block per SM walks work items (item_of), so that
// one item's epilogue and the next one's Q load overlap the K/V stream,
// which runs on through the ring from item to item.
template <int D, bool CAUSAL, int NC>
__global__ void __launch_bounds__(Cfg<D, NC>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const FwdArgs p) {
  using C = Cfg<D, NC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<D, NC> sm{(smem_u32(smem_raw) + 1023u) & ~1023u};
  const int n_q = (p.S + C::kBlockM - 1) / C::kBlockM;
  const int n_items = n_q * p.H * p.B;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 4 * NC);  // lane 0 of each consumer warp
    }
    mbar_init(sm.q_full(), 1);
    mbar_init(sm.q_empty(), 4 * NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so that the compiler knows it
  // is uniform and keeps the shared-memory descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      int n_q_loads = 0, t = 0;
      for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
        const int item = item_of(k);
        if (item >= n_items) continue;
        const Work w = work_of<CAUSAL, C::kBlockM>(p, item, n_q);
        if (w.n_tiles == 0) continue;
        mbar_wait(sm.q_empty(), (n_q_loads & 1) ^ 1);
        ++n_q_loads;
        mbar_expect_tx(sm.q_full(), C::kQBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx)
          tma_load_4d(sm.q() + bx * C::kQBoxBytes, &tm_q, sm.q_full(), 64 * bx, w.q0, w.h, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++t) {
          const int st = t % C::kStages;
          mbar_wait(sm.empty(st), ((t / C::kStages) & 1) ^ 1);
          mbar_expect_tx(sm.full(st), C::kStageBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx) {
            tma_load_4d(sm.k(st) + bx * kBoxBytes, &tm_k, sm.full(st), 64 * bx, j * kBlockN,
                        w.hk, w.b);
            tma_load_4d(sm.v(st) + bx * kBoxBytes, &tm_v, sm.full(st), 64 * bx, j * kBlockN,
                        w.hk, w.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    int n_q_loads = 0, t = 0;
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int item = item_of(k);
      if (item >= n_items) continue;
      const Work w = work_of<CAUSAL, C::kBlockM>(p, item, n_q);
      consumer_item<D, CAUSAL, NC>(p, sm, wg - 1, w, n_q_loads & 1, t);
      if (w.n_tiles > 0) ++n_q_loads;
      t += w.n_tiles;
    }
  }
}

// ------------------------------------------------------------- host ----

// Consumer warpgroups of a block: three at D = 64, two at D = 128.
template <int D>
constexpr int kConsumers = D == 64 ? 3 : 2;

template <int D, bool CAUSAL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const FwdArgs& a, int B,
                       const long long* st, cudaStream_t stream) {
  constexpr int NC = kConsumers<D>;
  using C = Cfg<D, NC>;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, D, a.S, a.H, B, st[0], st[1], st[2], C::kBlockM) ||
      !encode_operand(&tk, k, D, a.S_kv, a.Hkv, B, st[3], st[4], st[5], kBlockN) ||
      !encode_operand(&tv, v, D, a.S_kv, a.Hkv, B, st[6], st[7], st[8], kBlockN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D, CAUSAL, NC>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long n_items = (long long)((a.S + C::kBlockM - 1) / C::kBlockM) * a.H * B;
  if (n_items > (1ll << 30)) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min<long long>(n_items, sms);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iclk

using namespace iclk;

// q (B, H, S, D), k/v (B, Hkv, S_kv, D), o like q: bf16, head_dim contiguous,
// other axes strided (strides: 15 int64 on the host: q, k, v, o as (b, h, s),
// then three unused). m/l: (B, H, S) f32 row statistics or null. lengths:
// (B,) int32 or null. Returns the CUDA error of the launch (0 on success).
extern "C" int iclk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* m, void* l, const void* lengths, int B, int H,
                              int Hkv, int S, int S_kv, int D, int causal,
                              const long long* strides, float sm_scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || S_kv <= 0 || Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) ||
      (causal && S != S_kv))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.o = static_cast<bf16*>(o);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.lengths = static_cast<const int*>(lengths);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.S_kv = S_kv;
  a.o_sb = strides[9];
  a.o_sh = strides[10];
  a.o_ss = strides[11];
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)(causal ? launch_fwd<64, true>(q, k, v, a, B, strides, st)
                        : launch_fwd<64, false>(q, k, v, a, B, strides, st));
  return (int)(causal ? launch_fwd<128, true>(q, k, v, a, B, strides, st)
                      : launch_fwd<128, false>(q, k, v, a, B, strides, st));
}

// Dynamic shared memory of a block of the forward kernel at head dim D (0
// for a D it does not take), for the build report.
extern "C" int iclk_flash_fwd_smem_bytes(int D) {
  return D == 64 ? Cfg<64, kConsumers<64>>::kSmem
                 : D == 128 ? Cfg<128, kConsumers<128>>::kSmem : 0;
}

// Text of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* iclk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
