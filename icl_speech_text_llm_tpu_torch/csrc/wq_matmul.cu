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
// rows by every weight of the model once, ~1 flop per weight byte read, far
// below the ~295 flop/byte at which the tensor cores become the limit. The
// design therefore spends its effort on keeping enough weight bytes in
// flight and on a cheap unpack, not on the products:
// - one block owns 128 columns and 16 rows (64 for M > 16) and walks K in
//   128-row steps (one int4 scale group, or a part of one): the packed
//   tile (128 x 128 bytes) and the matching x rows go to shared memory with
//   16-byte loads, coalesced along N;
// - K is split over blocks (grid.z) so that two waves of blocks cover the
//   SMs even where N gives only 32-40 column tiles; each split writes f32
//   partials and a second launch sums them in order (deterministic);
// - products are mma.sync m16n8k16 bf16 -> f32. A lane reads one 32-bit
//   word = 4 neighbouring columns of a weight row and serves 4 n8 tiles
//   with it (tile i's column j is physical column 4j + i), so one shared
//   load feeds four fragments;
// - unpack without conversions: a nibble n becomes the bf16 bit pattern
//   0x4300 | n = 128 + n, and one bf16x2 subtract of 128 leaves n exactly;
//   int8 bytes convert through f32 (exact, |v| <= 127);
// - int4 zero point folded out of the element path exactly as the Pallas
//   kernel does: per step, acc += (x_lo.lo - 8 sum(x_lo)) s_lo
//   + (x_hi.hi - 8 sum(x_hi)) s_hi with f32 row sums and f32 scales.
// M up to 1024 (the gate of ops/int4_matmul.py); rows past M are zeros in
// shared memory and are not stored.
#include <stdint.h>

#include "common.cuh"

namespace iclk {

constexpr int kTileN = 128;       // columns per block: 4 warps x 32
constexpr int kChunk = 128;       // weight rows per k step
constexpr int kLdw = kTileN + 16; // shared row stride of the weight tile, bytes
constexpr int kLdx = kChunk + 8;  // shared row stride of an x tile, bf16

struct WqArgs {
  const bf16* x;        // (M, K)
  const uint8_t* w;     // int4 (K/2, N) packed; int8 (K, N)
  const float* s;       // int4 (n_groups, N); int8 (N,)
  bf16* y;              // (M, N)
  float* ws;            // (splits, M, N) f32 partials; null when splits == 1
  int M, N, K, n_groups;
  int n_chunks, chunks_per_split;
};

template <bool INT4, int WM>
constexpr size_t wq_smem_bytes() {
  return (size_t)kChunk * kLdw + (size_t)(INT4 ? 2 : 1) * 16 * WM * kLdx * sizeof(bf16) +
         (INT4 ? (2 * kTileN + 2 * 16 * WM) * sizeof(float) : 0);
}

__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  // v holds two nibbles in bits 0-3 and 16-19 -> the two bf16 values exactly
  const uint32_t biased = v | 0x43004300u;  // 128 + n in each half
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

template <bool INT4, int WM>
__global__ void __launch_bounds__(128 * WM) wq_matmul_kernel(const WqArgs p) {
  constexpr int kThreads = 128 * WM;
  constexpr int BM = 16 * WM;
  constexpr int HALVES = INT4 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* Ws = smem_raw;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw + kChunk * kLdw);
  float* Ss = reinterpret_cast<float*>(Xs + HALVES * BM * kLdx);  // int4: [2][kTileN]
  float* Rs = Ss + 2 * kTileN;                                     // int4: [2][BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * BM;
  const int c_begin = blockIdx.z * p.chunks_per_split;
  const int c_end = min(p.n_chunks, c_begin + p.chunks_per_split);
  const int group = INT4 ? p.K / p.n_groups : 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[4][4], c_lo[4][4], c_hi[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = c_lo[i][e] = c_hi[i][e] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();  // every warp is done with the previous step's tiles
    const uint8_t* wsrc = p.w + (long long)c * kChunk * p.N + n0;
    for (int i = tid; i < kChunk * (kTileN / 16); i += kThreads) {
      const int r = i / (kTileN / 16), cc = (i % (kTileN / 16)) * 16;
      *reinterpret_cast<uint4*>(Ws + r * kLdw + cc) =
          *reinterpret_cast<const uint4*>(wsrc + (long long)r * p.N + cc);
    }
    constexpr int XCH = kChunk / 8;
    for (int i = tid; i < HALVES * BM * XCH; i += kThreads) {
      const int hf = i / (BM * XCH), rem = i % (BM * XCH);
      const int r = rem / XCH, cc = (rem % XCH) * 8;
      uint4 v = zero;
      if (m0 + r < p.M)
        v = *reinterpret_cast<const uint4*>(p.x + (long long)(m0 + r) * p.K +
                                            hf * (p.K / 2) + c * kChunk + cc);
      *reinterpret_cast<uint4*>(Xs + (hf * BM + r) * kLdx + cc) = v;
    }
    if constexpr (INT4) {
      const int gi = c * kChunk / group;
      for (int i = tid; i < 2 * kTileN; i += kThreads) {
        const int hf = i / kTileN, j = i % kTileN;
        Ss[i] = p.s[(long long)(gi + hf * (p.n_groups / 2)) * p.N + n0 + j];
      }
    }
    __syncthreads();
    if constexpr (INT4) {
      // f32 row sums of this step's x_lo and x_hi rows: 4 threads per sum
      const int sid = tid >> 2, part = tid & 3;
      const bf16* xr = Xs + sid * kLdx + part * (kChunk / 4);
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < kChunk / 4; ++j) sum += __bfloat162float(xr[j]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) Rs[sid] = sum;
      __syncthreads();
    }

    const int r0 = wm * 16 + g;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[HALVES][4];
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        const bf16* xa = Xs + (hf * BM + r0) * kLdx + kk * 16 + 2 * t;
        a[hf][0] = ld_u32(xa);
        a[hf][1] = ld_u32(xa + 8 * kLdx);
        a[hf][2] = ld_u32(xa + 8);
        a[hf][3] = ld_u32(xa + 8 * kLdx + 8);
      }
      const uint8_t* wb = Ws + (kk * 16 + 2 * t) * kLdw + wn * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wb);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wb + kLdw);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wb + 8 * kLdw);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wb + 9 * kLdw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // byte i of the first word -> byte 0, byte i of the second -> byte 2
        const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
        const uint32_t p01 = __byte_perm(w0, w1, sel);
        const uint32_t p89 = __byte_perm(w2, w3, sel);
        if constexpr (INT4) {
          mma_16816(c_lo[i], a[0], nibbles_to_bf16x2(p01 & 0x000F000Fu),
                    nibbles_to_bf16x2(p89 & 0x000F000Fu));
          mma_16816(c_hi[i], a[HALVES - 1], nibbles_to_bf16x2((p01 >> 4) & 0x000F000Fu),
                    nibbles_to_bf16x2((p89 >> 4) & 0x000F000Fu));
        } else {
          const uint32_t b0 = pack_bf16((float)(int8_t)(p01 & 0xFFu),
                                        (float)(int8_t)((p01 >> 16) & 0xFFu));
          const uint32_t b1 = pack_bf16((float)(int8_t)(p89 & 0xFFu),
                                        (float)(int8_t)((p89 >> 16) & 0xFFu));
          mma_16816(acc[i], a[0], b0, b1);
        }
      }
    }
    if constexpr (INT4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wm * 16 + g + (e >> 1) * 8;
          const int col = wn * 32 + 4 * (2 * t + (e & 1)) + i;
          acc[i][e] += (c_lo[i][e] - 8.f * Rs[row]) * Ss[col];
          acc[i][e] += (c_hi[i][e] - 8.f * Rs[BM + row]) * Ss[kTileN + col];
          c_lo[i][e] = c_hi[i][e] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm * 16 + g + (e >> 1) * 8;
      const int col = n0 + wn * 32 + 4 * (2 * t + (e & 1)) + i;
      if (row >= p.M) continue;
      float v = acc[i][e];
      if constexpr (!INT4) v *= p.s[col];
      if (p.ws != nullptr)
        p.ws[((long long)blockIdx.z * p.M + row) * p.N + col] = v;
      else
        p.y[(long long)row * p.N + col] = __float2bfloat16(v);
    }
}

// y = bf16(sum of the splits' partials), summed in split order.
__global__ void wq_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ y,
                                 int splits, long long mn) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[s * mn + i];
    y[i] = __float2bfloat16(v);
  }
}

template <bool INT4, int WM>
cudaError_t launch_wq_tile(const WqArgs& a, int splits, cudaStream_t stream) {
  auto kern = wq_matmul_kernel<INT4, WM>;
  const size_t smem = wq_smem_bytes<INT4, WM>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.N / kTileN, (a.M + 16 * WM - 1) / (16 * WM), splits);
  kern<<<grid, 128 * WM, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool INT4>
int launch_wq(const void* x, const void* w, const void* s, void* y, void* ws, int M, int N,
              int K, int n_groups, int splits, void* stream) {
  const int k_rows = INT4 ? K / 2 : K;
  if (M < 1 || M > 65535 * 64 || N < kTileN || N % kTileN || K < 1 || k_rows % kChunk ||
      (INT4 && K % 2) || splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (INT4 && (n_groups < 2 || n_groups % 2 || K % n_groups || (K / n_groups) % kChunk))
    return (int)cudaErrorInvalidValue;
  WqArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.y = static_cast<bf16*>(y);
  a.ws = splits > 1 ? static_cast<float*>(ws) : nullptr;
  a.M = M; a.N = N; a.K = K; a.n_groups = n_groups;
  a.n_chunks = k_rows / kChunk;
  a.chunks_per_split = (a.n_chunks + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = M <= 16 ? launch_wq_tile<INT4, 1>(a, splits, st)
                          : launch_wq_tile<INT4, 4>(a, splits, st);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)M * N;
  const long long blocks = (mn + 255) / 256;
  wq_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      a.ws, a.y, splits, mn);
  return (int)cudaGetLastError();
}

}  // namespace iclk

// x (M, K) bf16, packed (K/2, N) uint8, scales (n_groups, N) f32, y (M, N)
// bf16, ws (splits, M, N) f32 when splits > 1; all contiguous on the device.
extern "C" int iclk_int4_matmul(const void* x, const void* packed, const void* scales, void* y,
                                void* ws, int M, int N, int K, int n_groups, int splits,
                                void* stream) {
  return iclk::launch_wq<true>(x, packed, scales, y, ws, M, N, K, n_groups, splits, stream);
}

// x (M, K) bf16, q (K, N) int8, s (N,) f32, y (M, N) bf16, ws as above;
// n_groups is ignored.
extern "C" int iclk_int8_matmul(const void* x, const void* q, const void* s, void* y, void* ws,
                                int M, int N, int K, int n_groups, int splits, void* stream) {
  return iclk::launch_wq<false>(x, q, s, y, ws, M, N, K, n_groups, splits, stream);
}
