// Single-token decode attention over the KV cache (flash decode) for Hopper
// (sm_90a): a bf16 cache (K7) and an int8 cache with per-position scales
// (K7 q8), two kernels behind one C entry.
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   _flash_decode / _decode_kernel (flash_decode_attention and
//   flash_decode_attention_q8), in the zero-copy decode step of
//   models/llama.py:_decode_step_zero_copy.
// o[b, h] = softmax over the cached keys [0, lengths[b]) and, when given,
// the current token's own (k_new, v_new) column; query head h reads kv head
// h / (H / Hkv).
//
// Math (the Pallas kernel's): f32 scores q·k·sm_scale, times k's scale of
// the position for an int8 cache; an online softmax; v's scale multiplies p
// after p is summed into l; p is rounded to bf16 for the P·V product (f32
// accumulate); the self column is the f32 Σ q·k_new·sm_scale and
// p_self·v_new is added in f32, unquantized; l == 0 gives o = 0.
//
// What bounds it on the H100: the cache bytes. One decode step of Vicuna-7B
// at batch 4 and ~900 cached positions reads 59 MB a layer (~18 µs at
// 3.35 TB/s) for ~0.03 GFLOP; an int8 cache reads half the bytes plus
// 1/64 of them in scales. The arithmetic is ~1 FLOP a byte.
//
// bf16 cache (flash_decode_kernel): one block of 8 warps per (sample, kv
// head) streams that head's rows [0, length) once for all H / Hkv query
// heads of its group (GQA without a repeated copy), in one launch per layer.
// Each half-warp owns a row at a time, a 16-byte load per lane, and keeps
// several rows in flight; the dot product is a 4-step shuffle reduction
// inside the half-warp, and each half-warp keeps its own f32 (m, l, acc) per
// query head. The halves of a warp merge by shuffles, the 8 warps through
// shared memory, and the last step folds in the self column and writes o.
//
// int8 cache (flash_decode_q8_kernel):
// - Each (sample, kv head) is split over a thread-block cluster of `splits`
//   blocks (grid (splits, Hkv, B)). ops/flash_attention.py:decode_splits
//   picks the split: the largest whose grid the card holds in one wave and
//   whose busiest SM has at most 1.1× the mean work (at the 13B decode, B =
//   4 and Hkv = 40, 160 pairs for 132 SMs: clusters of 3). Rank r takes the
//   rows [len·r/splits, len·(r+1)/splits) of the sample's own length, each
//   start rounded down to a multiple of 4, computed on the device from
//   lengths[b]: a short sample costs only its rows.
// - One (sample, head)'s k rows are one contiguous run of len × 128 bytes,
//   and so are its v rows and its two scale rows. One producer thread keeps
//   a ring of kStages stages full: per stage a TMA box of 32 k rows and one
//   of the same v rows (rank-4 maps over the layer, 128-byte swizzle, zero
//   fill past S) and both tiles' scales (1-D bulk copies). Each stage
//   belongs to one consumer warp, two stages a warp, so a warp's next tile
//   loads while it reads the other; five small blocks share an SM, so an SM
//   keeps well over the ~25 KB in flight that 3.35 TB/s ÷ 132 SMs × ~1 µs
//   of latency asks for.
// - Products on the tensor cores (mma.sync m16n8k16, bf16, f32 accumulate;
//   int8 and bf16 products are exact, only the order of the sums differs):
//   S = Q·Kᵀ with the query heads as A (rows ≥ H / Hkv zero) and the k rows
//   as B, and Oᵀ = Vᵀ·Pᵀ with the v rows read as A and the probabilities,
//   which a lane holds exactly where P·V's B fragment wants them, as B. The
//   rows of each 8-row group are taken in the order 0 5 2 7 4 1 6 3, which
//   with the swizzle makes every shared-memory load free of bank conflicts.
// - int8 → bf16 without I2F: for a byte b with low 7 bits c and sign s,
//   bf16(0x4300 | c) = 128 + c and bf16(0x4300 | s << 7) = 128 + 128·s, so
//   one bf16x2 subtraction gives c − 128·s = b exactly; two LOP3 and one
//   HSUB2 a pair of values.
// - Scores take k's scale and the softmax scale (in the exp2 domain) in f32;
//   each tile's maximum rescales the warp's (l, acc) once a tile.
// - The warps merge their (m, l, acc) in shared memory, then every rank
//   writes its state into the owner's (rank 0) shared memory through
//   distributed shared memory; after one cluster barrier the owner merges
//   the ranks in rank order, folds in the self column and writes o. One
//   launch, no workspace, the same bits on every call.
// - Measured on an H100 (PERF.md): at the 13B decode the copies alone,
//   without the math, take 1.7× the byte bound, and the math alone 1.2×.
//   Between the 4-row and 16-row shapes the copies stream at the card's
//   rate, so what holds the call is a fixed cost of ~8 µs (the launch, the
//   first copies' latency, the merge). Grids larger than one wave run in
//   lockstep waves and lose ~30%.
#include <cooperative_groups.h>
#include <math.h>

#include "hopper.cuh"

using namespace iclk;

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 128;        // head_dim
constexpr int kWarps = 8;
constexpr int kDecodeThreads = kWarps * 32;
constexpr int kHalves = 2 * kWarps;  // half-warps per block

struct DecodeArgs {
  const bf16* q;          // (B, H, D) contiguous
  const void* k;          // bf16 or int8, (b, h, s) strides, head_dim contiguous
  const void* v;
  const float* k_s;       // (b, h, s) strides; null for a bf16 cache
  const float* v_s;
  const bf16* k_new;      // (B, Hkv, D) contiguous, or null (no self column)
  const bf16* v_new;
  bf16* o;                // (B, H, D) contiguous
  const int* lengths;     // (B,) cached positions to attend
  int H, Hkv, S;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, ks_ss, vs_sb, vs_sh, vs_ss;
  float sm_scale;
};

// 8 bf16 cache values at this lane's columns → f32.
struct Row8 {
  uint4 raw;
  __device__ __forceinline__ void load(const void* base, long long off) {
    raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + off);
  }
  __device__ __forceinline__ void to_float(float (&f)[8]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void bf16x8(const bf16* src, float (&f)[8]) {
  Row8 r;
  r.raw = *reinterpret_cast<const uint4*>(src);
  r.to_float(f);
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Merge an (m, l, acc) state with another of the same query head.
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[8], float m2,
                                      float l2, const float (&acc2)[8]) {
  const float mn = fmaxf(m, m2);
  const float a = (m == -INFINITY) ? 0.f : expf(m - mn);
  const float c = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
  l = l * a + l2 * c;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = acc[i] * a + acc2[i] * c;
  m = mn;
}

template <int NREP>
__global__ void __launch_bounds__(kDecodeThreads) flash_decode_kernel(const DecodeArgs p) {
  // rows a half-warp keeps in flight
  constexpr int U = NREP == 1 ? 8 : (NREP <= 2 ? 4 : 2);
  __shared__ float sm_acc[kWarps][NREP][kD];
  __shared__ float sm_m[kWarps][NREP];
  __shared__ float sm_l[kWarps][NREP];
  __shared__ float sm_self[NREP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, col = (lane & 15) * 8;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int len = min(max(p.lengths[b], 0), p.S);
  const int h0 = hk * NREP;

  float qv[NREP][8];
#pragma unroll
  for (int j = 0; j < NREP; ++j) bf16x8(p.q + ((long long)b * p.H + h0 + j) * kD + col, qv[j]);

  float m[NREP], l[NREP], acc[NREP][8];
#pragma unroll
  for (int j = 0; j < NREP; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  }

  const long long k_off = (long long)b * p.k_sb + (long long)hk * p.k_sh + col;
  const long long v_off = (long long)b * p.v_sb + (long long)hk * p.v_sh + col;
  // warp-uniform loop: the two halves of a warp take rows base + half·U + u
  for (int base = warp * 2 * U; base < len; base += kHalves * U) {
    Row8 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + half * U + u;
      if (row < len) {
        kr[u].load(p.k, k_off + (long long)row * p.k_ss);
        vr[u].load(p.v, v_off + (long long)row * p.v_ss);
      } else {
        kr[u].raw = make_uint4(0u, 0u, 0u, 0u);
        vr[u].raw = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool valid = base + half * U + u < len;
      float kf[8];
      kr[u].to_float(kf);
      float s[NREP];
#pragma unroll
      for (int j = 0; j < NREP; ++j) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qv[j][i], kf[i], d);
        s[j] = half_warp_sum(d) * p.sm_scale;  // every lane of the warp shuffles
      }
      if (!valid) continue;
      float vf[8];
      vr[u].to_float(vf);
#pragma unroll
      for (int j = 0; j < NREP; ++j) {
        const float mn = fmaxf(m[j], s[j]);
        const float alpha = expf(m[j] - mn);  // 0 while m is −inf
        float pr = expf(s[j] - mn);
        l[j] = l[j] * alpha + pr;
        pr = __bfloat162float(__float2bfloat16(pr));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(pr, vf[i], acc[j][i] * alpha);
        m[j] = mn;
      }
    }
  }

  // the two halves of each warp → one state, lanes 0..15 store it
#pragma unroll
  for (int j = 0; j < NREP; ++j) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m[j], 16);
    const float l2 = __shfl_xor_sync(0xffffffffu, l[j], 16);
    float acc2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc2[i] = __shfl_xor_sync(0xffffffffu, acc[j][i], 16);
    merge(m[j], l[j], acc[j], m2, l2, acc2);
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[warp][j][col + i] = acc[j][i];
      if (lane == 0) {
        sm_m[warp][j] = m[j];
        sm_l[warp][j] = l[j];
      }
    }
  }
  // the self column's score, one query head per warp (NREP ≤ kWarps)
  if (p.k_new != nullptr && warp < NREP) {
    float kn[8];
    bf16x8(p.k_new + ((long long)b * p.Hkv + hk) * kD + col, kn);
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < NREP; ++j) {
      if (j == warp) {  // qv indexed by a constant: it stays in registers
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qv[j][i], kn[i], d);
      }
    }
    d = half_warp_sum(d);
    if (lane == 0) sm_self[warp] = d * p.sm_scale;
  }
  __syncthreads();

  for (int idx = tid; idx < NREP * kD; idx += kDecodeThreads) {
    const int j = idx / kD, d = idx % kD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][j]);
    const bool self = p.k_new != nullptr;
    const float s_self = self ? sm_self[j] : -INFINITY;
    const float Mt = fmaxf(M, s_self);
    float L = 0.f, A = 0.f;
    if (Mt != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w][j];
        const float c = (mw == -INFINITY) ? 0.f : expf(mw - Mt);
        L = fmaf(sm_l[w][j], c, L);
        A = fmaf(sm_acc[w][j][d], c, A);
      }
      if (self) {
        const float ps = expf(s_self - Mt);
        L += ps;
        A = fmaf(ps, __bfloat162float(p.v_new[((long long)b * p.Hkv + hk) * kD + d]), A);
      }
    }
    const float out = (L == 0.f) ? 0.f : A * (1.f / L);
    p.o[((long long)b * p.H + h0 + j) * kD + d] = __float2bfloat16(out);
  }
}

// ------------------------------------------------------- int8 cache ----

namespace q8 {

constexpr int kTile = 32;       // cache rows a stage
constexpr int kSlices = kTile / 16;  // 16-row k steps of P·V a tile
constexpr int kWarps = 2;       // consumer warps; tile j → warp j % kWarps
constexpr int kStages = 4;      // two a warp: one loads while the other is read
constexpr int kMinBlocks = 5;   // blocks an SM that the registers must allow
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kMaxSplits = 8;   // blocks of a cluster: the portable limit
constexpr int kRowBytes = kD;   // one int8 row
constexpr int kKBytes = kTile * kRowBytes;
constexpr int kScaleBytes = kTile * 4;
// the k and v tiles of a stage 1024-byte aligned, as the 128-byte swizzle asks
constexpr int kStageBytes = (2 * kKBytes + 2 * kScaleBytes + 1023) / 1024 * 1024;
constexpr int kRing = kStages * kStageBytes;
// stage st only ever holds tiles of warp st % kWarps, so a warp never waits
// on a stage more than one phase ahead (an mbarrier tells phases apart by
// their parity alone)
static_assert(kStages % kWarps == 0, "each stage belongs to one consumer warp");

// Shared memory of a block: the ring (reused by the warps' merge once every
// tile is consumed), the owner's receive slots (one (acc, m, l) state per
// rank), the self column's scores, the full and empty barriers.
template <int NREP>
struct Smem {
  static constexpr int kSlot = NREP * (kD + 2);  // floats: acc[NREP][kD], m[NREP], l[NREP]
  static constexpr int kRecv = kMaxSplits * kSlot * 4;
  static constexpr int kSelf = 8 * 4;
  static constexpr int kBytes = 1024 + kRing + kRecv + kSelf + 2 * kStages * 8;
  static_assert(kWarps * kSlot * 4 <= kRing, "the warps' states fit in the ring");
};

// The int8 values in bytes 0 and 2 of x → the bf16 pair, exactly and
// without I2F: (128 + low 7 bits) − (128 + 128·sign bit).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t x) {
  const uint32_t a = and_or(x, 0x007F007Fu, 0x43004300u);
  const uint32_t b = and_or(x, 0x00800080u, 0x43004300u);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Row j of each 8-row group as the products take them: even j in place,
// odd j from row j ^ 4, so that the lanes of every quarter-warp read eight
// different 16-byte chunks of the swizzled tiles (no bank conflict).
__device__ __forceinline__ int row_of(int j) { return (j & 1) ? j ^ 4 : j; }

// Byte offset of 16-byte chunk c of row r in a tile written by TMA with the
// 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// x / c for c in 1..kMaxSplits, each a division by a constant (a multiply
// and a shift: a division by a value known only at run time goes through I2F)
__device__ __forceinline__ uint32_t div_split(uint32_t x, int c) {
  switch (c) {
    case 1: return x;
    case 2: return x / 2;
    case 3: return x / 3;
    case 4: return x / 4;
    case 5: return x / 5;
    case 6: return x / 6;
    case 7: return x / 7;
    default: return x / 8;
  }
}

// One consumer warp's tiles. Lane (g, t) = (lane / 4, lane % 4); below,
// row j of an 8-row group stands for the tile's row row_of(j) of the group.
// Q·K (A = the query heads, B = Kᵀ): k step kk of n-tile rows r..r+7 takes
// from row r + g the 32-bit word widx = kk < 4 ? 4t + kk : 16 + 4t + kk − 4
// (bytes 0, 2 → B's k positions 2t, 2t + 1; bytes 1, 3 → 2t + 8, 2t + 9), so
// a lane reads two 16-byte runs of a row; the query fragments hold head g's
// values at the same head-dim positions (d = 4·widx + {0, 2} and {1, 3}).
// The scores come out as c[e] = S[head g][row 2t + e] of each 8-row n-tile,
// which is B of the P·V product: Oᵀ (d × heads) += Vᵀ (d × 16 rows) · Pᵀ.
// Its A fragments come from 16-byte runs of v rows 2t, 2t + 1, 2t + 8,
// 2t + 9 at bytes 16g..16g + 15: word q, bytes 2pp and 2pp + 1 of each make
// the A tile (q, pp), whose M-row g is d = 16g + 4q + 2pp and M-row g + 8 is
// d + 1. acc[q][pp] = {O[2t][d], O[2t + 1][d], O[2t][d + 1], O[2t + 1][d + 1]}.
template <int NREP>
__device__ __forceinline__ void consume(const DecodeArgs& p, uint32_t base, uint32_t bars,
                                        int b, int hk, int row0, int row_end, int n_tiles,
                                        int warp, int lane, float& m_out, float& l_out,
                                        float (&acc)[4][2][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[8][2];
  if (g < NREP) {
    const bf16* qrow = p.q + ((long long)b * p.H + (long long)hk * NREP + g) * kD;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint4 x = *reinterpret_cast<const uint4*>(qrow + 64 * hf + 16 * t);
      const uint4 y = *reinterpret_cast<const uint4*>(qrow + 64 * hf + 16 * t + 8);
      const uint32_t z[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        qa[4 * hf + k][0] = __byte_perm(z[2 * k], z[2 * k + 1], 0x5410);
        qa[4 * hf + k][1] = __byte_perm(z[2 * k], z[2 * k + 1], 0x7632);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) qa[k][0] = qa[k][1] = 0u;
  }
  const float qscale = p.sm_scale * kLog2eF;
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][pp][e] = 0.f;

  for (int j = warp; j < n_tiles; j += kWarps) {
    const int st = j % kStages;
    const uint32_t sb = base + st * kStageBytes;
    const int rows = min(kTile, row_end - (row0 + j * kTile));
    mbar_wait(bars + 8 * st, (j / kStages) & 1);

    // S = Q·Kᵀ over the tile's 4 slices of 16 rows
    float c[kSlices][2][4];
    uint4 kw[kSlices][2][2];
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r = 16 * i + 8 * n + row_of(g);
        kw[i][n][0] = lds128(sb + swz(r, t));
        kw[i][n][1] = lds128(sb + swz(r, 4 + t));
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
#pragma unroll
      for (int i = 0; i < kSlices; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t w = word(kw[i][n][kk >> 2], kk & 3);
          mma_16816(c[i][n], a, i8x2_to_bf16x2(w), i8x2_to_bf16x2(w >> 8));
        }
    }
    // scores in the exp2 domain, k's scale, rows past the tile's end masked
    float s[kSlices][2][2], vs[kSlices][2][2];
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r0 = 16 * i + 8 * n + row_of(2 * t), r1 = 16 * i + 8 * n + row_of(2 * t + 1);
        const uint32_t sc = sb + 2 * kKBytes;
        s[i][n][0] = r0 < rows ? c[i][n][0] * qscale * lds_f32(sc + 4 * r0) : -INFINITY;
        s[i][n][1] = r1 < rows ? c[i][n][1] * qscale * lds_f32(sc + 4 * r1) : -INFINITY;
        vs[i][n][0] = lds_f32(sc + kScaleBytes + 4 * r0);
        vs[i][n][1] = lds_f32(sc + kScaleBytes + 4 * r1);
        mt = fmaxf(mt, fmaxf(s[i][n][0], s[i][n][1]));
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mn = fmaxf(m, mt);
    const float alpha = m == -INFINITY ? 0.f : exp2_mufu(m - mn);
    const float msub = mn == -INFINITY ? 0.f : mn;
    m = mn;
    l *= alpha;
    // p into l unscaled, then times v's scale, rounded to bf16: P·V's B
    uint32_t pb[kSlices][2];
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r0 = 16 * i + 8 * n + row_of(2 * t), r1 = 16 * i + 8 * n + row_of(2 * t + 1);
        const float p0 = exp2_mufu(s[i][n][0] - msub), p1 = exp2_mufu(s[i][n][1] - msub);
        l += p0 + p1;
        pb[i][n] = pack_bf16(r0 < rows ? p0 * vs[i][n][0] : 0.f,
                             r1 < rows ? p1 * vs[i][n][1] : 0.f);
      }
    // the state of heads 2t, 2t + 1 rescales once a tile
    const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
    const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        acc[q][pp][0] *= a0;
        acc[q][pp][1] *= a1;
        acc[q][pp][2] *= a0;
        acc[q][pp][3] *= a1;
      }
    // Oᵀ += Vᵀ·Pᵀ
#pragma unroll
    for (int i = 0; i < kSlices; ++i) {
      const uint32_t va = sb + kKBytes;
      const int r0 = 16 * i + row_of(2 * t), r1 = 16 * i + row_of(2 * t + 1);
      const uint4 w0 = lds128(va + swz(r0, g)), w1 = lds128(va + swz(r1, g));
      const uint4 w2 = lds128(va + swz(r0 + 8, g)), w3 = lds128(va + swz(r1 + 8, g));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t x0 = word(w0, q), x1 = word(w1, q), x2 = word(w2, q), x3 = word(w3, q);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const uint32_t a[4] = {i8x2_to_bf16x2(pair_bytes(x0, x1, 2 * pp)),
                                 i8x2_to_bf16x2(pair_bytes(x0, x1, 2 * pp + 1)),
                                 i8x2_to_bf16x2(pair_bytes(x2, x3, 2 * pp)),
                                 i8x2_to_bf16x2(pair_bytes(x2, x3, 2 * pp + 1))};
          mma_16816(acc[q][pp], a, pb[i][0], pb[i][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  m_out = m;
  l_out = l;
}

template <int NREP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_decode_q8_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const DecodeArgs p) {
  using Sm = Smem<NREP>;
  constexpr int kSlot = Sm::kSlot;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* scratch = reinterpret_cast<float*>(smem);  // the warps' states, after the ring
  float* recv = reinterpret_cast<float*>(smem + kRing);
  float* s_self = reinterpret_cast<float*>(smem + kRing + Sm::kRecv);
  const uint32_t bars = base + kRing + Sm::kRecv + Sm::kSelf;  // full[kStages], empty[kStages]

  const int rank = blockIdx.x, splits = gridDim.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(p.lengths[b], 0), p.S);
  // this rank's rows: an equal share of the sample's own, starting at a
  // multiple of 4 (every scale copy 16-byte aligned)
  const int row0 = (int)(div_split((uint32_t)(len * rank), splits) & ~3u);
  const int row_end =
      rank + 1 == splits ? len : (int)(div_split((uint32_t)(len * (rank + 1)), splits) & ~3u);
  const int n_tiles = (row_end - row0 + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();  // waited for before the first remote write

  if (warp == kWarps) {
    // producer: one thread issues every copy of this rank's tiles
    if (lane == 0) {
      const float* ksp = p.k_s + b * p.ks_sb + hk * p.ks_sh;
      const float* vsp = p.v_s + b * p.vs_sb + hk * p.vs_sh;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t full = bars + 8 * st, sb = base + st * kStageBytes;
        const int r0 = row0 + j * kTile, rows = min(kTile, row_end - r0);
        const int srows = (rows + 3) & ~3;  // ≤ S, a multiple of 4
        mbar_wait(bars + 8 * (kStages + st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * kKBytes + 2 * srows * 4);  // TMA counts a whole box
        tma_load_4d(sb, &tm_k, full, 0, r0, hk, b);
        tma_load_4d(sb + kKBytes, &tm_v, full, 0, r0, hk, b);
        bulk_load(sb + 2 * kKBytes, ksp + r0, srows * 4, full);
        bulk_load(sb + 2 * kKBytes + kScaleBytes, vsp + r0, srows * 4, full);
      }
    }
    cluster_wait();
  } else {
    float m, l, acc[4][2][4];
    consume<NREP>(p, base, bars, b, hk, row0, row_end, n_tiles, warp, lane, m, l, acc);
    named_bar_sync(1, 32 * kWarps);  // every tile consumed: the ring is free
    const int g = lane >> 2, t = lane & 3;
    float* mine = scratch + warp * kSlot;
    if (t == 0 && g < NREP) {
      mine[NREP * kD + g] = m;
      mine[NREP * kD + NREP + g] = l;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 2 * t + (e & 1);
          if (h < NREP) mine[h * kD + 16 * g + 4 * q + 2 * pp + (e >> 1)] = acc[q][pp][e];
        }
    // the owner's self-column scores (exp2 domain), one head per warp at a time
    if (rank == 0 && p.k_new != nullptr) {
      for (int h = warp; h < NREP; h += kWarps) {
        const bf16* qrow = p.q + ((long long)b * p.H + (long long)hk * NREP + h) * kD;
        const bf16* krow = p.k_new + ((long long)b * p.Hkv + hk) * kD;
        const uint2 qx = *reinterpret_cast<const uint2*>(qrow + 4 * lane);
        const uint2 kx = *reinterpret_cast<const uint2*>(krow + 4 * lane);
        const uint32_t qw[2] = {qx.x, qx.y}, kw[2] = {kx.x, kx.y};
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          d = fmaf(__uint_as_float(qw[i] << 16), __uint_as_float(kw[i] << 16), d);
          d = fmaf(__uint_as_float(qw[i] & 0xffff0000u), __uint_as_float(kw[i] & 0xffff0000u), d);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (lane == 0) s_self[h] = d * p.sm_scale * kLog2eF;
      }
    }
    named_bar_sync(1, 32 * kWarps);
    // the warps' states → this rank's, written into the owner's slot
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every block of the cluster has started
    float* slot = cluster.map_shared_rank(recv, 0) + rank * kSlot;
    for (int idx = threadIdx.x; idx < NREP * kD; idx += 32 * kWarps) {
      const int h = idx / kD, d = idx % kD;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, scratch[w * kSlot + NREP * kD + h]);
      float L = 0.f, A = 0.f;
      if (M != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float mw = scratch[w * kSlot + NREP * kD + h];
          const float cw = mw == -INFINITY ? 0.f : exp2_mufu(mw - M);
          L = fmaf(scratch[w * kSlot + NREP * kD + NREP + h], cw, L);
          A = fmaf(scratch[w * kSlot + h * kD + d], cw, A);
        }
      }
      slot[h * kD + d] = A;
      if (d == 0) {
        slot[NREP * kD + h] = M;
        slot[NREP * kD + NREP + h] = L;
      }
    }
  }

  cluster_arrive();
  cluster_wait();
  if (rank != 0 || warp == kWarps) return;
  // the owner: the ranks in rank order, then the self column
  const bool self = p.k_new != nullptr;
  for (int idx = threadIdx.x; idx < NREP * kD; idx += 32 * kWarps) {
    const int h = idx / kD, d = idx % kD;
    float M = self ? s_self[h] : -INFINITY;
    for (int r = 0; r < splits; ++r) M = fmaxf(M, recv[r * kSlot + NREP * kD + h]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int r = 0; r < splits; ++r) {
        const float mr = recv[r * kSlot + NREP * kD + h];
        const float cr = mr == -INFINITY ? 0.f : exp2_mufu(mr - M);
        L = fmaf(recv[r * kSlot + NREP * kD + NREP + h], cr, L);
        A = fmaf(recv[r * kSlot + h * kD + d], cr, A);
      }
      if (self) {
        const float ps = exp2_mufu(s_self[h] - M);
        L += ps;
        A = fmaf(ps, __bfloat162float(p.v_new[((long long)b * p.Hkv + hk) * kD + d]), A);
      }
    }
    p.o[((long long)b * p.H + (long long)hk * NREP + h) * kD + d] =
        __float2bfloat16(L == 0.f ? 0.f : A / L);
  }
}

// Rank-4 map {D bytes, S, Hkv, B} of an int8 cache operand with byte
// strides (sb, sh) and rows of kD bytes; boxes of 64 rows, 128-byte swizzle,
// zero fill past S. An axis of size 1 gets the packed stride.
bool encode_rows(CUtensorMap* map, const void* ptr, int S, int Hkv, int B, long long sb,
                 long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)S, (cuuint64_t)Hkv, (cuuint64_t)B};
  long long st[4] = {1, kRowBytes, sh, sb};
  cuuint64_t strides[3];
  for (int i = 1; i < 4; ++i) {
    if (dims[i] == 1) st[i] = st[i - 1] * (long long)dims[i - 1];
    if (st[i] <= 0) return false;
    strides[i - 1] = (cuuint64_t)st[i];
  }
  cuuint32_t box[4] = {(cuuint32_t)kRowBytes, (cuuint32_t)kTile, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NREP>
cudaError_t launch_q8(const DecodeArgs& a, int B, int splits, cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!encode_rows(&tk, a.k, a.S, a.Hkv, B, a.k_sb, a.k_sh) ||
      !encode_rows(&tv, a.v, a.S, a.Hkv, B, a.v_sb, a.v_sh))
    return cudaErrorInvalidValue;
  auto kern = flash_decode_q8_kernel<NREP>;
  constexpr int smem = Smem<NREP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tk, tv, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of `splits` blocks of the NREP instance that the card holds at once.
template <int NREP>
int max_clusters(int splits) {
  auto kern = flash_decode_q8_kernel<NREP>;
  constexpr int smem = Smem<NREP>::kBytes;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1024, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace q8

template <int NREP>
cudaError_t launch_nrep(const DecodeArgs& a, int B, bool quant, int splits,
                        cudaStream_t stream) {
  if (quant) return q8::launch_q8<NREP>(a, B, splits, stream);
  flash_decode_kernel<NREP><<<dim3(a.Hkv, B), kDecodeThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The int8 instance's layout: k/v rows contiguous along S (128 bytes a
// row), scales contiguous along S, every (sample, head) run of rows and of
// scales 16-byte aligned, S a multiple of 4 (the bulk copies' 16 bytes).
bool q8_layout_ok(const DecodeArgs& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.k_s) |
                         reinterpret_cast<uintptr_t>(a.v_s);
  return a.k_ss == kD && a.v_ss == kD && a.ks_ss == 1 && a.vs_ss == 1 && a.S % 4 == 0 &&
         a.S <= (1 << 27) &&
         ptrs % 16 == 0 && (a.k_sb | a.k_sh | a.v_sb | a.v_sh) % 16 == 0 &&
         (a.ks_sb | a.ks_sh | a.vs_sb | a.vs_sh) % 4 == 0;
}

}  // namespace

// q (B, H, 1, D) bf16 contiguous; k/v a (B, Hkv, S, D) view (bf16, or int8
// with k_s/v_s (B, Hkv, S) f32 scales) with head_dim contiguous; the int8
// cache's rows and scales contiguous along S (``q8_layout_ok``); strides: 12
// int64, k (b, h, s), v (b, h, s), k_s (b, h, s), v_s (b, h, s); k_new/v_new
// (B, Hkv, D) bf16 or null; o (B, H, 1, D) bf16; lengths (B,) int32; splits
// the int8 instance's cluster size (1-8, ops/flash_attention.py:
// decode_splits; 1 for the bf16 cache).
extern "C" int iclk_flash_decode(const void* q, const void* k, const void* v,
                                 const void* k_s, const void* v_s, const void* k_new,
                                 const void* v_new, void* o, const void* lengths, int B,
                                 int H, int Hkv, int S, int D, int splits,
                                 const long long* strides, float sm_scale, void* stream) {
  const bool quant = k_s != nullptr;
  if (B <= 0 || Hkv <= 0 || S <= 0 || D != kD || H % Hkv != 0 || B > 65535 || Hkv > 65535 ||
      (k_s == nullptr) != (v_s == nullptr) || (k_new == nullptr) != (v_new == nullptr) ||
      splits < 1 || splits > (quant ? q8::kMaxSplits : 1))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = k;
  a.v = v;
  a.k_s = static_cast<const float*>(k_s);
  a.v_s = static_cast<const float*>(v_s);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.o = static_cast<bf16*>(o);
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.k_sb = strides[0]; a.k_sh = strides[1]; a.k_ss = strides[2];
  a.v_sb = strides[3]; a.v_sh = strides[4]; a.v_ss = strides[5];
  a.ks_sb = strides[6]; a.ks_sh = strides[7]; a.ks_ss = strides[8];
  a.vs_sb = strides[9]; a.vs_sh = strides[10]; a.vs_ss = strides[11];
  a.sm_scale = sm_scale;
  if (quant && !q8_layout_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / Hkv) {
    case 1: return (int)launch_nrep<1>(a, B, quant, splits, st);
    case 2: return (int)launch_nrep<2>(a, B, quant, splits, st);
    case 3: return (int)launch_nrep<3>(a, B, quant, splits, st);
    case 4: return (int)launch_nrep<4>(a, B, quant, splits, st);
    case 5: return (int)launch_nrep<5>(a, B, quant, splits, st);
    case 6: return (int)launch_nrep<6>(a, B, quant, splits, st);
    case 7: return (int)launch_nrep<7>(a, B, quant, splits, st);
    case 8: return (int)launch_nrep<8>(a, B, quant, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a block of the int8 instance with n_rep query
// heads a kv head (1-8), for the build report; 0 otherwise.
extern "C" int iclk_flash_decode_q8_smem_bytes(int n_rep) {
  switch (n_rep) {
    case 1: return q8::Smem<1>::kBytes;
    case 2: return q8::Smem<2>::kBytes;
    case 3: return q8::Smem<3>::kBytes;
    case 4: return q8::Smem<4>::kBytes;
    case 5: return q8::Smem<5>::kBytes;
    case 6: return q8::Smem<6>::kBytes;
    case 7: return q8::Smem<7>::kBytes;
    case 8: return q8::Smem<8>::kBytes;
    default: return 0;
  }
}

// Clusters of `splits` (1-8) blocks of the int8 instance with n_rep query
// heads a kv head that the card holds at once; -1 on error.
extern "C" int iclk_flash_decode_q8_max_clusters(int n_rep, int splits) {
  if (splits < 1 || splits > q8::kMaxSplits) return -1;
  switch (n_rep) {
    case 1: return q8::max_clusters<1>(splits);
    case 2: return q8::max_clusters<2>(splits);
    case 3: return q8::max_clusters<3>(splits);
    case 4: return q8::max_clusters<4>(splits);
    case 5: return q8::max_clusters<5>(splits);
    case 6: return q8::max_clusters<6>(splits);
    case 7: return q8::max_clusters<7>(splits);
    case 8: return q8::max_clusters<8>(splits);
    default: return -1;
  }
}
