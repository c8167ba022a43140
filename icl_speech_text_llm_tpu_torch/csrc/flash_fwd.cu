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
#include <cuda.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace iclk {
namespace {

constexpr int kRowsWG = 64;           // query rows of a consumer warpgroup
constexpr int kBlockN = 128;          // keys of a tile
constexpr int kBoxBytes = 128 * 128;  // one K/V box: 128 rows of 64 bf16, swizzled
constexpr int kWGBoxBytes = kRowsWG * 128;  // a consumer warpgroup's rows of a Q box
constexpr float kLog2eF = 1.4426950408889634f;

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

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in flight in a wgmma at this point of the program, so the
// compiler neither reads an accumulator before its wait nor reuses an
// operand's registers while the tensor cores still read them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

#define ICLK_F8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ICLK_F32 ICLK_F8(0), ICLK_F8(8), ICLK_F8(16), ICLK_F8(24)
#define ICLK_F64 ICLK_F32, ICLK_F8(32), ICLK_F8(40), ICLK_F8(48), ICLK_F8(56)
#define ICLK_R32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define ICLK_R64                                                                          \
  ICLK_R32                                                                                \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64×128 f32) (+)= A·B, A (64×16) and B (128×16) K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" ICLK_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ICLK_F64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64×64 f32) += A·B, A (64×16 bf16) from registers, B (16×64) MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" ICLK_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ICLK_F32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64×128 f32) += A·B, A (64×16 bf16) from registers, B (16×128) MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" ICLK_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ICLK_F64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// 2^x on the special-function unit (MUFU.EX2); 2^−inf = 0.
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// Online softmax of one tile's raw scores (this thread: rows row0 and
// row0 + 8, columns kv0 + 8i + 2t + {0, 1}). Masks by index where asked,
// updates the running max m (raw-score units) and the partial sums l, and
// leaves p = exp2((s − m)·scale2) in s; alpha rescales the older state.
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool mask, int kv0, int len,
                                             int row0, int t, float scale2) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * i + 2 * t + (e & 1);
        bool ok = col < len;
        if (CAUSAL) ok = ok && col <= row0 + 8 * (e >> 1);
        if (!ok) s[4 * i + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
  float msub[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
    alpha[ri] = m[ri] == -INFINITY ? 0.f : exp2_mufu((m[ri] - mx[ri]) * scale2);
    m[ri] = mx[ri];
    msub[ri] = mx[ri] == -INFINITY ? 0.f : mx[ri] * scale2;
    l[ri] *= alpha[ri];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2_mufu(fmaf(s[4 * i + e], scale2, -msub[e >> 1]));
      s[4 * i + e] = pe;
      l[e >> 1] += pe;
    }
}

// P as bf16 A fragments: k-step kk takes pr[4kk..4kk+3], i.e. the score
// pairs (row g, keys 16kk+2t), (row g+8, same), (row g, +8), (row g+8, +8),
// which are s[8kk..8kk+7] in order.
__device__ __forceinline__ void scores_to_a(uint32_t (&pr)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pr[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
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

// The k-th item of this block: zig-zag over the grid (k even: k·G + i, k
// odd: (k + 1)·G − 1 − i), so that a block that takes a heavy causal tile in
// one round takes a light one in the next.
__device__ __forceinline__ int item_of(int k) {
  return (k & 1) ? (k + 1) * (int)gridDim.x - 1 - (int)blockIdx.x
                 : k * (int)gridDim.x + (int)blockIdx.x;
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Rank-4 map {D, S, H, B} of a bf16 operand with element strides (sb, sh,
// ss) and a contiguous head dim; boxes of 64 × `rows`, 128-byte swizzle,
// zero fill out of bounds. An axis of size 1 gets the packed stride (its
// own is never used, and may be 0).
bool encode_operand(CUtensorMap* map, const void* ptr, int D, int S, int H, int B, long long sb,
                    long long sh, long long ss, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  long long st[4] = {1, ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 1; i < 4; ++i) {
    if (dims[i] == 1) st[i] = st[i - 1] * (long long)dims[i - 1];
    if (st[i] <= 0) return false;
    strides[i - 1] = (cuuint64_t)st[i] * sizeof(bf16);
  }
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
