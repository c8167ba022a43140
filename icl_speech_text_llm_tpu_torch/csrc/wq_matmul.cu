// Weight-quantized matmuls for Hopper (sm_90a): y (M, N) = x (M, K) @ W,
// x bf16 row-major, W stored in 4 or 8 bits, f32 accumulate, y bf16.
//
// Replaces: icl_speech_text_llm_tpu/ops/int4_matmul.py int4_matmul /
//   _int4_kernel (K10): W split-half packed uint8 (K/2, N), byte i holding
//   row i in its low nibble and row i + K/2 in its high nibble, each as
//   v + 8; f32 scales (K/group, N), low-half groups first.
// Also the int8 weight-only matmul the JAX package leaves to XLA's fused
//   convert (icl_speech_text_llm_tpu/ops/quant.py:141, K12 in PERF.md):
//   W int8 (K, N), one f32 scale per column applied once at the end.
//
// What bounds it on the H100: the weight bytes. A decode step multiplies 4
// rows by every weight of the model once, ~16 flops per weight byte, far
// below the ~295 flop/byte at which the tensor cores become the limit. The
// design is a weight stream: bytes in flight on every SM, the same bytes on
// every SM, one launch, and few instructions per weight byte.
// - A block (CTA) owns TN = 128 or 64 columns, MT = 8 or 16 rows (decode;
//   64 for M > 16) and a contiguous range of 64-row k steps. One producer
//   thread keeps a ring of kStages shared-memory stages full: per step a TMA
//   box of the weight (64 rows × TN bytes, 128- or 64-byte swizzle), a TMA
//   box of the step's x columns for each half (64 bf16 × MT rows; rows past
//   M are TMA's zero fill) and, for int4, the step's two scale rows (bulk
//   copies). Consumer warps wait on a stage's full barrier and release it
//   on its empty barrier: no block-wide barrier in the loop. Several blocks
//   share an SM, so one block's start and end overlap the others' streams.
// - K is split over a thread-block cluster of S <= 8 blocks (the grid's x
//   axis), each taking a balanced share of the k steps; the column tile and
//   S are chosen per shape by ops/int4_matmul.py:partition so that every SM
//   streams the same bytes. The split sum stays in the cluster: every rank
//   writes its f32 partial tile, cut in S shares, into the owning ranks'
//   shared memory (distributed shared memory); after one cluster barrier
//   each rank adds its share over the ranks in rank order and stores bf16.
//   One launch, no workspace, the same bits on every call.
// - Products are mma.sync m16n8k16 bf16 -> f32. Decode puts the weight in
//   the A operand and x^T in B, so one product covers 16 columns of 8 rows
//   (M <= 8 uses 4 of them) rather than 8 columns of 16 rows. A lane reads
//   32-bit words of 4 neighbouring columns from rows 2t, 2t+1, 2t+8, 2t+9,
//   and byte permutes build the fragments of two 16-column A tiles; the B
//   fragments come by ldmatrix from the swizzled x box. For M > 16 the
//   roles are the usual ones (x in A, 16 rows a warp).
// - Unpack: one LOP3 turns a nibble pair into the bf16 pair 128 + n (bit
//   pattern 0x4300 | n). Decode multiplies those as they are and takes
//   136 × the step's row sums of x (one more product, with an all-ones A)
//   off before the scales: (x.(128 + n) - 136 sum x) s = (x.(n - 8)) s,
//   which is the Pallas kernel's zero-point fold (x.q - 8 sum x) s; for
//   M > 16 a bf16x2 subtract of 136 leaves n - 8 exactly. f32 group
//   scales, applied once a step; int8 bytes convert through f32 (exact,
//   |v| <= 127) and take their per-column scale once, in the split sum.
// M up to 1024 (the gate of ops/int4_matmul.py); rows past M are TMA's zeros
// in shared memory and are not stored.
#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper.cuh"

namespace iclk {
namespace {

namespace cg = cooperative_groups;

constexpr int kStepRows = 64;  // weight rows per k step (packed rows for int4)
constexpr int kMaxSplits = 8;  // CTAs of a cluster: the portable limit

template <bool INT4, int MT, int TN>
struct WqCfg {
  // decode (M <= 16): the weight is the mma's A operand, x^T its B, so that
  // an m16n8k16 product covers 16 columns of 8 rows (M <= 8) instead of 8
  // columns of 16 rows
  static constexpr bool kDecode = MT <= 16;
  static constexpr int kHalves = INT4 ? 2 : 1;
  static constexpr int kWarpsN = TN / 32;
  static constexpr int kConsumerWarps = kWarpsN * (kDecode ? 1 : MT / 16);
  static constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
  static constexpr int kWBytes = TN * kStepRows;                // weight box
  static constexpr int kXBytes = MT * kStepRows * 2;            // one half's x box
  static constexpr int kSBytes = INT4 ? 2 * TN * 4 : 0;         // two scale rows
  static constexpr int kTx = kWBytes + kHalves * kXBytes + kSBytes;
  static constexpr int kStageBytes = (kTx + 1023) / 1024 * 1024;
  // 3 stages: the decode blocks are small enough that 4-5 share an SM, and
  // their rings together keep 44-59 KB of weight in flight an SM on an H100
  static constexpr int kStages = 3;
  // the receive slots of the split sum: per source rank, a share of the
  // tile's float4s (at most MT * TN / 4 / S + 1 each)
  static constexpr int kRecvBytes = (MT * TN / 4 + kMaxSplits) * 16;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kRecvBytes + 2 * kStages * 8;
};

struct WqArgs {
  const float* s;  // int4 (n_groups, N); int8 (N,)
  bf16* y;         // (M, N)
  int M, N, K, n_groups, n_steps;
};

// Byte offset in a TMA box of TN-byte rows written with the 128-byte (TN =
// 128) or 64-byte (TN = 64) swizzle: 16-byte chunk bits XOR row bits.
template <int TN>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (TN == 128 ? 7u : 3u)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&a)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr));
}

// The word at addr + OFF (OFF a constant: no address arithmetic).
template <int OFF>
__device__ __forceinline__ uint32_t ld_shared_u32_at(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1+%2];\n" : "=r"(v) : "r"(addr), "n"(OFF));
  return v;
}

__device__ __forceinline__ float4 ld_shared_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Two nibbles in bits 0-3 and 16-19 -> the bf16 pair (128 + n0, 128 + n1).
__device__ __forceinline__ uint32_t nibbles_biased(uint32_t v) {
  return and_or(v, 0x000F000Fu, 0x43004300u);
}

// Two nibbles in bits 0-3 and 16-19 -> the bf16 pair (n0 - 8, n1 - 8), exactly.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  const uint32_t biased = nibbles_biased(v);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Two int8 in bytes 0 and 2 -> the bf16 pair, exactly.
__device__ __forceinline__ uint32_t int8_to_bf16x2(uint32_t v) {
  return pack_bf16((float)(int8_t)(v & 0xFFu), (float)(int8_t)((v >> 16) & 0xFFu));
}

// The split sum's receive side. The tile's valid float4s (n4: rows below M
// × TN / 4) are cut in S shares in rank order, share r summed by rank r;
// every rank writes each float4 of its partial tile into the owner's slot
// for the source rank through distributed shared memory, so that after one
// cluster barrier each owner adds only local slots, in rank order.
struct SplitSink {
  float4* recv;  // this CTA's slots (a shared-memory pointer)
  int rank, S, n4, span, cols4;
  __device__ __forceinline__ void put(cg::cluster_group& cluster, int row, int col,
                                      float4 v) const {
    const int u = row * cols4 + col / 4;
    if (u >= n4) return;  // a row past M
    const int owner = ((u + 1) * S - 1) / n4;
    cluster.map_shared_rank(recv, owner)[rank * span + u - owner * n4 / S] = v;
  }
};

// Rows 16k + {2t, 2t+1, 2t+8, 2t+9} of a weight box from the addresses of
// rows 2t (wa0) and 2t + 1 (wa1); k is a constant once the caller's loop is
// unrolled.
template <int TN>
__device__ __forceinline__ void load_words(uint32_t (&w)[4], uint32_t wa0, uint32_t wa1, int k) {
#define ICLK_WORDS(K)                                      \
  w[0] = ld_shared_u32_at<16 * TN * K>(wa0);              \
  w[1] = ld_shared_u32_at<16 * TN * K>(wa1);              \
  w[2] = ld_shared_u32_at<16 * TN * K + 8 * TN>(wa0);     \
  w[3] = ld_shared_u32_at<16 * TN * K + 8 * TN>(wa1);
  switch (k) {
    case 0: ICLK_WORDS(0) break;
    case 1: ICLK_WORDS(1) break;
    case 2: ICLK_WORDS(2) break;
    default: ICLK_WORDS(3) break;
  }
#undef ICLK_WORDS
}

// Decode consumer: this warp's 32 columns (wn) of every step. W is the A
// operand: A tile p (p = 0, 1) row r < 8 is physical column 4r + 2p, row
// r + 8 column 4r + 2p + 1, so a lane's four 32-bit weight words (rows 2t,
// 2t+1, 2t+8, 2t+9 at columns 4g..4g+3) build both tiles' fragments. For int4 the
// nibbles go in as 128 + n and 136 × the step's row sums of x (an mma with
// an all-ones A) come off before the scales: (x.(128 + n) - 136 sum(x)) s =
// (x.(n - 8)) s, the Pallas kernel's zero-point fold.
template <bool INT4, int MT, int TN>
__device__ __forceinline__ void consume_decode(uint32_t base, uint32_t bars, const SplitSink& sink,
                                               int n_my, int warp, int lane) {
  using C = WqCfg<INT4, MT, TN>;
  constexpr int NB = MT / 8;                        // n8 blocks of x rows
  constexpr int KK = kStepRows / 16;  // k16 slices of a step
  const int wn = warp;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ones = 0x3F803F80u;  // bf16 (1, 1)
  const uint32_t ones_a[4] = {ones, ones, ones, ones};
  float acc[2][NB][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][nb][e] = 0.f;
  // ldmatrix: lane / 8 picks the matrix (int4: lo k 0-7, lo k 8-15, hi k
  // 0-7, hi k 8-15; int8: k 0-7, k 8-15), lane % 8 its row. Offsets in a
  // stage are the same every step: computed once. A weight row + 8 or + 16
  // keeps its swizzle pattern, so rows 2t and 2t + 1 give every word's
  // address with a constant offset.
  const int mat = (lane >> 3) & (INT4 ? 3 : 1);
  const uint32_t w_col = wn * 32 + 4 * g;
  uint32_t x_off[KK][NB];
#pragma unroll
  for (int k = 0; k < KK; ++k)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      x_off[k][nb] = C::kWBytes + (INT4 ? (mat >> 1) * C::kXBytes : 0) +
                     swizzle<128>((nb * 8 + (lane & 7)) * 128 +
                                  (2 * k + (mat & 1)) * 16);
  const uint32_t w_off0 = swizzle<TN>(2 * t * TN + w_col);
  const uint32_t w_off1 = swizzle<TN>((2 * t + 1) * TN + w_col);
  const uint32_t s_off = C::kWBytes + 2 * C::kXBytes + 4 * w_col;
  for (int j = 0; j < n_my; ++j) {
    const int st = j % C::kStages;
    const uint32_t sb = base + st * C::kStageBytes;
    mbar_wait(bars + 8 * st, (j / C::kStages) & 1);
    // every shared load of the step first, then the products
    uint32_t b[KK][C::kHalves][NB][2], w[KK][4];
    const uint32_t wa0 = sb + w_off0, wa1 = sb + w_off1;
#pragma unroll
    for (int k = 0; k < KK; ++k) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if constexpr (INT4) {
          uint32_t r[4];
          ldmatrix_x4(r, sb + x_off[k][nb]);
          b[k][0][nb][0] = r[0];
          b[k][0][nb][1] = r[1];
          b[k][C::kHalves - 1][nb][0] = r[2];
          b[k][C::kHalves - 1][nb][1] = r[3];
        } else {
          ldmatrix_x2(b[k][0][nb], sb + x_off[k][nb]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KK; ++k) load_words<TN>(w[k], wa0, wa1, k);
    float c[C::kHalves][2][NB][4], cs[C::kHalves][NB][4];
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[hf][0][nb][e] = c[hf][1][nb][e] = 0.f;
          cs[hf][nb][e] = 0.f;
        }
#pragma unroll
    for (int k = 0; k < KK; ++k) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t f[4] = {pair_bytes(w[k][0], w[k][1], 2 * q),
                               pair_bytes(w[k][0], w[k][1], 2 * q + 1),
                               pair_bytes(w[k][2], w[k][3], 2 * q),
                               pair_bytes(w[k][2], w[k][3], 2 * q + 1)};
        if constexpr (INT4) {
          const uint32_t lo[4] = {nibbles_biased(f[0]), nibbles_biased(f[1]),
                                  nibbles_biased(f[2]), nibbles_biased(f[3])};
          const uint32_t hi[4] = {nibbles_biased(f[0] >> 4), nibbles_biased(f[1] >> 4),
                                  nibbles_biased(f[2] >> 4), nibbles_biased(f[3] >> 4)};
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            mma_16816(c[0][q][nb], lo, b[k][0][nb][0], b[k][0][nb][1]);
            mma_16816(c[C::kHalves - 1][q][nb], hi, b[k][C::kHalves - 1][nb][0],
                      b[k][C::kHalves - 1][nb][1]);
          }
        } else {
          const uint32_t a[4] = {int8_to_bf16x2(f[0]), int8_to_bf16x2(f[1]),
                                 int8_to_bf16x2(f[2]), int8_to_bf16x2(f[3])};
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma_16816(c[0][q][nb], a, b[k][0][nb][0], b[k][0][nb][1]);
        }
      }
      if constexpr (INT4) {
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma_16816(cs[hf][nb], ones_a, b[k][hf][nb][0], b[k][hf][nb][1]);
      }
    }
    if constexpr (INT4) {
      // columns wn*32 + 4g + (2q + (e >> 1)) of both scale rows
      const uint32_t ss = sb + s_off;
      const float4 lo4 = ld_shared_f32x4(ss), hi4 = ld_shared_f32x4(ss + TN * 4);
      const float slo[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
      const float shi[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[q][nb][e] += (c[0][q][nb][e] - 136.f * cs[0][nb][e]) * slo[2 * q + (e >> 1)] +
                             (c[1][q][nb][e] - 136.f * cs[1][nb][e]) * shi[2 * q + (e >> 1)];
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][nb][e] += c[0][q][nb][e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + st));
  }
  // rows 8nb + 2t + r, columns wn*32 + 4g + {0, 1, 2, 3}
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sink.put(cluster, nb * 8 + 2 * t + r, w_col,
               make_float4(acc[0][nb][r], acc[0][nb][2 + r], acc[1][nb][r], acc[1][nb][2 + r]));
}

// Row-tile consumer (M > 16): x is the A operand (16 rows a warp, wm), the
// weight B; a lane's word of 4 neighbouring columns serves 4 n8 tiles (tile
// i's column j is physical column 4j + i). Nibbles go in as n - 8.
template <bool INT4, int MT, int TN>
__device__ __forceinline__ void consume_rows(uint32_t base, uint32_t bars, const SplitSink& sink,
                                             int n_my, int warp, int lane) {
  using C = WqCfg<INT4, MT, TN>;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // ldmatrix rows of this lane: matrix lane / 8 of (rows 0-7 | 8-15) x
  // (k 0-7 | 8-15) of the warp's 16 rows
  const int mat = lane >> 3;
  const uint32_t x_row = wm * 16 + (lane & 7) + 8 * (mat & 1);
  const uint32_t w_col = wn * 32 + 4 * g;
  for (int j = 0; j < n_my; ++j) {
    const int st = j % C::kStages;
    const uint32_t sb = base + st * C::kStageBytes;
    mbar_wait(bars + 8 * st, (j / C::kStages) & 1);
    float c[C::kHalves][4][4];
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[hf][i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kStepRows / 16; ++kk) {
      uint32_t a[C::kHalves][4];
      const uint32_t x_off = x_row * 128 + (2 * kk + (mat >> 1)) * 16;
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf)
        ldmatrix_x4(a[hf], sb + C::kWBytes + hf * C::kXBytes + swizzle<128>(x_off));
      const uint32_t r0 = (kk * 16 + 2 * t) * TN + w_col;
      const uint32_t w0 = ld_shared_u32_at<0>(sb + swizzle<TN>(r0));
      const uint32_t w1 = ld_shared_u32_at<0>(sb + swizzle<TN>(r0 + TN));
      const uint32_t w2 = ld_shared_u32_at<0>(sb + swizzle<TN>(r0 + 8 * TN));
      const uint32_t w3 = ld_shared_u32_at<0>(sb + swizzle<TN>(r0 + 9 * TN));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t p01 = pair_bytes(w0, w1, i), p89 = pair_bytes(w2, w3, i);
        if constexpr (INT4) {
          mma_16816(c[0][i], a[0], nibbles_to_bf16x2(p01), nibbles_to_bf16x2(p89));
          mma_16816(c[C::kHalves - 1][i], a[C::kHalves - 1], nibbles_to_bf16x2(p01 >> 4),
                    nibbles_to_bf16x2(p89 >> 4));
        } else {
          mma_16816(acc[i], a[0], int8_to_bf16x2(p01), int8_to_bf16x2(p89));
        }
      }
    }
    if constexpr (INT4) {
      // this thread's columns wn*32 + 8t + 4(e & 1) + i of both scale rows
      const uint32_t ss = sb + C::kWBytes + 2 * C::kXBytes + 4 * (wn * 32 + 8 * t);
      const float4 lo0 = ld_shared_f32x4(ss), lo1 = ld_shared_f32x4(ss + 16);
      const float4 hi0 = ld_shared_f32x4(ss + TN * 4), hi1 = ld_shared_f32x4(ss + TN * 4 + 16);
      const float slo[2][4] = {{lo0.x, lo0.y, lo0.z, lo0.w}, {lo1.x, lo1.y, lo1.z, lo1.w}};
      const float shi[2][4] = {{hi0.x, hi0.y, hi0.z, hi0.w}, {hi1.x, hi1.y, hi1.z, hi1.w}};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] += c[0][i][e] * slo[e & 1][i] + c[1][i][e] * shi[e & 1][i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + st));
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sink.put(cluster, wm * 16 + g + (e >> 1) * 8, wn * 32 + 8 * t + 4 * (e & 1),
             make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]));
}

template <bool INT4, int MT, int TN>
__global__ void __launch_bounds__(WqCfg<INT4, MT, TN>::kThreads)
    wq_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_x, const WqArgs p) {
  using C = WqCfg<INT4, MT, TN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t recv = base + C::kStages * C::kStageBytes;
  const uint32_t bars = recv + C::kRecvBytes;  // full[kStages], then empty[kStages]

  // this CTA's k steps: a balanced share, the first n_steps % S ranks one more
  const int rank = blockIdx.x, S = gridDim.x;
  const int per = p.n_steps / S, extra = p.n_steps % S;
  const int step0 = rank * per + min(rank, extra);
  const int n_my = per + (rank < extra ? 1 : 0);
  const int n0 = blockIdx.y * TN, m0 = blockIdx.z * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (C::kStages + st), C::kConsumerWarps);  // lane 0 of each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();  // waited for before the first remote write

  const int rows = min(MT, p.M - m0);
  const int n4 = rows * (TN / 4);
  const SplitSink sink{reinterpret_cast<float4*>(smem_raw + (recv - raw)), rank, S, n4,
                       (n4 + S - 1) / S, TN / 4};
  if (warp == C::kConsumerWarps) {
    // producer: one thread issues every copy of this CTA's steps
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      const int group = INT4 ? p.K / p.n_groups : 1;
      for (int j = 0; j < n_my; ++j) {
        const int st = j % C::kStages;
        const uint32_t full = bars + 8 * st, sb = base + st * C::kStageBytes;
        mbar_wait(bars + 8 * (C::kStages + st), ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full, C::kTx);
        const int r = (step0 + j) * kStepRows;  // weight row of the step
        tma_load_2d(sb, &tm_w, full, n0, r);
        tma_load_2d(sb + C::kWBytes, &tm_x, full, r, m0);
        if constexpr (INT4) {
          tma_load_2d(sb + C::kWBytes + C::kXBytes, &tm_x, full, p.K / 2 + r, m0);
          const float* s_lo = p.s + (long long)(r / group) * p.N + n0;
          const uint32_t ss = sb + C::kWBytes + 2 * C::kXBytes;
          bulk_load(ss, s_lo, TN * 4, full);
          bulk_load(ss + TN * 4, s_lo + (long long)(p.n_groups / 2) * p.N, TN * 4, full);
        }
      }
    }
    cluster_wait();
  } else if constexpr (C::kDecode) {
    consume_decode<INT4, MT, TN>(base, bars, sink, n_my, warp, lane);
  } else {
    consume_rows<INT4, MT, TN>(base, bars, sink, n_my, warp, lane);
  }

  // split sum: rank r adds its share of the tile over the source ranks in
  // order, from its own slots, and stores bf16
  cluster_arrive();
  cluster_wait();
  const int u0 = rank * n4 / S, u_end = (rank + 1) * n4 / S;
  for (int u = u0 + (int)threadIdx.x; u < u_end; u += (int)blockDim.x) {
    const int row = u / (TN / 4), col = (u % (TN / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 pv = sink.recv[q * sink.span + u - u0];
      v.x += pv.x;
      v.y += pv.y;
      v.z += pv.z;
      v.w += pv.w;
    }
    if constexpr (!INT4) {
      const float4 s = *reinterpret_cast<const float4*>(p.s + n0 + col);
      v.x *= s.x;
      v.y *= s.y;
      v.z *= s.z;
      v.w *= s.w;
    }
    *reinterpret_cast<uint2*>(p.y + (long long)(m0 + row) * p.N + n0 + col) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

template <bool INT4, int MT, int TN>
cudaError_t launch_wq_tile(const void* x, const void* w, const WqArgs& a, int splits,
                           cudaStream_t stream) {
  using C = WqCfg<INT4, MT, TN>;
  CUtensorMap tw, tx;
  const int w_rows = INT4 ? a.K / 2 : a.K;
  if (!encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, a.N, w_rows, a.N, TN, kStepRows,
                 TN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, a.K, a.M, 2ll * a.K, kStepRows,
                 MT, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = wq_matmul_kernel<INT4, MT, TN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.N / TN, (a.M + MT - 1) / MT);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tw, tx, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of `splits` blocks of an instance that the card holds at once.
template <bool INT4, int MT, int TN>
int max_clusters(int splits) {
  using C = WqCfg<INT4, MT, TN>;
  auto kern = wq_matmul_kernel<INT4, MT, TN>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1024, 1);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
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

template <bool INT4, int MT>
cudaError_t launch_wq_rows(const void* x, const void* w, const WqArgs& a, int tile_n,
                           int splits, cudaStream_t st) {
  return tile_n == 128 ? launch_wq_tile<INT4, MT, 128>(x, w, a, splits, st)
                       : launch_wq_tile<INT4, MT, 64>(x, w, a, splits, st);
}

template <bool INT4>
int launch_wq(const void* x, const void* w, const void* s, void* y, int M, int N, int K,
              int n_groups, int tile_n, int splits, void* stream) {
  const int k_rows = INT4 ? K / 2 : K;
  if (M < 1 || M > 65535 * 64 || (tile_n != 128 && tile_n != 64) || N < tile_n ||
      N % tile_n || K < 1 || k_rows % kStepRows || (INT4 && K % 2) || splits < 1 ||
      splits > kMaxSplits || splits > k_rows / kStepRows ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(s)) % 16)
    return (int)cudaErrorInvalidValue;
  if (INT4 && (n_groups < 2 || n_groups % 2 || K % n_groups || (K / n_groups) % kStepRows ||
               (K / 2) % (K / n_groups)))
    return (int)cudaErrorInvalidValue;
  WqArgs a;
  a.s = static_cast<const float*>(s);
  a.y = static_cast<bf16*>(y);
  a.M = M;
  a.N = N;
  a.K = K;
  a.n_groups = n_groups;
  a.n_steps = k_rows / kStepRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(M <= 8    ? launch_wq_rows<INT4, 8>(x, w, a, tile_n, splits, st)
                : M <= 16 ? launch_wq_rows<INT4, 16>(x, w, a, tile_n, splits, st)
                          : launch_wq_rows<INT4, 64>(x, w, a, tile_n, splits, st));
}

}  // namespace
}  // namespace iclk

// x (M, K) bf16, packed (K/2, N) uint8, scales (n_groups, N) f32, y (M, N)
// bf16, all contiguous on the device and 16-byte aligned; tile_n (128 or 64)
// columns a block and splits (1-8) blocks of a cluster along K, as
// ops/int4_matmul.py:partition chooses them. Returns the launch's CUDA error.
extern "C" int iclk_int4_matmul(const void* x, const void* packed, const void* scales, void* y,
                                int M, int N, int K, int n_groups, int tile_n, int splits,
                                void* stream) {
  return iclk::launch_wq<true>(x, packed, scales, y, M, N, K, n_groups, tile_n, splits, stream);
}

// x (M, K) bf16, q (K, N) int8, s (N,) f32, y (M, N) bf16, the rest as
// above; n_groups is ignored.
extern "C" int iclk_int8_matmul(const void* x, const void* q, const void* s, void* y, int M,
                                int N, int K, int n_groups, int tile_n, int splits,
                                void* stream) {
  return iclk::launch_wq<false>(x, q, s, y, M, N, K, n_groups, tile_n, splits, stream);
}

// Dynamic shared memory of a block of the int4 (1) or int8 (0) instance with
// MT rows (8, 16 or 64) and TN columns (128 or 64), for the build report; 0
// for an instance that does not exist.
extern "C" int iclk_wq_smem_bytes(int int4, int mt, int tn) {
  using namespace iclk;
  if (tn != 128 && tn != 64) return 0;
#define ICLK_WQ_SMEM(B, MT) \
  (tn == 128 ? WqCfg<B, MT, 128>::kSmem : WqCfg<B, MT, 64>::kSmem)
  if (mt == 8) return int4 ? ICLK_WQ_SMEM(true, 8) : ICLK_WQ_SMEM(false, 8);
  if (mt == 16) return int4 ? ICLK_WQ_SMEM(true, 16) : ICLK_WQ_SMEM(false, 16);
  if (mt == 64) return int4 ? ICLK_WQ_SMEM(true, 64) : ICLK_WQ_SMEM(false, 64);
#undef ICLK_WQ_SMEM
  return 0;
}

// Clusters of `splits` (1-8) blocks the card holds at once for the int4 (1)
// or int8 (0) instance with MT rows and TN columns; -1 on error.
extern "C" int iclk_wq_max_clusters(int int4, int mt, int tn, int splits) {
  using namespace iclk;
  if (splits < 1 || splits > kMaxSplits || (tn != 128 && tn != 64)) return -1;
#define ICLK_WQ_FIT(B, MT) (tn == 128 ? max_clusters<B, MT, 128>(splits) \
                                      : max_clusters<B, MT, 64>(splits))
  if (mt == 8) return int4 ? ICLK_WQ_FIT(true, 8) : ICLK_WQ_FIT(false, 8);
  if (mt == 16) return int4 ? ICLK_WQ_FIT(true, 16) : ICLK_WQ_FIT(false, 16);
  if (mt == 64) return int4 ? ICLK_WQ_FIT(true, 64) : ICLK_WQ_FIT(false, 64);
#undef ICLK_WQ_FIT
  return -1;
}
