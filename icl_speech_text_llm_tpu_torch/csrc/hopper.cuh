// Hopper building blocks shared by the wgmma/TMA attention kernels
// (flash_fwd.cu: K1/K2; gated_bias.cu: K3/K8/K9; flash_bwd.cu: K5/K6), the
// TMA weight ring of the quantized matmuls (wq_matmul.cu: K10/K12) and the
// int8-cache flash decode (flash_decode.cu: K7 q8), for sm_90a.
//
// - PTX wrappers: mbarriers (init, expect_tx, arrive, parity wait), TMA tile
//   loads (cp.async.bulk.tensor, rank 2, 3 and 4, completing on an mbarrier)
//   and plain bulk copies of contiguous bytes (cp.async.bulk),
//   named barriers, one-LOP3 (a & b) | c, a byte-pair permute, thread-block
//   cluster barriers, wgmma (fence, commit, wait, the m64n128k16 and m64n64k16
//   products with both operands in shared memory and the m64n64k16 /
//   m64n128k16 products with A from registers), the shared-memory matrix
//   descriptor with the 128-byte swizzle, and exp2 on the special-function
//   unit.
// - The online softmax of one 64×128 score tile held as a wgmma accumulator,
//   in the exp2 domain with the row max in raw-score units, and the
//   conversion of the probabilities to bf16 A fragments for P·V.
// - Host: cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (no
//   link against libcuda), the rank-4 tensor map {D, S, H, B} of a bf16
//   operand with strided batch, head and sequence axes, and the rank-2 map of
//   a row-major matrix of any element type (the matmuls' uint8 / int8
//   weights and bf16 activations).
#pragma once

#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace iclk {

constexpr int kRowsWG = 64;           // query rows of a consumer warpgroup
constexpr int kBlockN = 128;          // keys of a tile
constexpr int kBoxBytes = 128 * 128;  // one K/V box: 128 rows of 64 bf16, swizzled
constexpr int kWGBoxBytes = kRowsWG * 128;  // a consumer warpgroup's rows of a Q box
constexpr float kLog2eF = 1.4426950408889634f;

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// (a & b) | c in one LOP3 (the compiler splits it in two when b and c are
// both immediates).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// byte i of the first word -> byte 0, byte i of the second -> byte 2
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b, int i) {
  return __byte_perm(a, b, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
}

// Thread-block cluster barrier: arrive (relaxed, or releasing this thread's
// writes), then wait (acquiring the cluster's).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

// d (64×64 f32) (+)= A·B, A (64×16) and B (64×16) K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" ICLK_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ICLK_F32
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

// The k-th item of this block: zig-zag over the grid (k even: k·G + i, k
// odd: (k + 1)·G − 1 − i), so that a block that takes a heavy work item in
// one round takes a light one in the next (persistent grids).
__device__ __forceinline__ int item_of(int k) {
  return (k & 1) ? (k + 1) * (int)gridDim.x - 1 - (int)blockIdx.x
                 : k * (int)gridDim.x + (int)blockIdx.x;
}

// ---------------------------------------------------------- softmax ----

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

// ------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
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
inline bool encode_operand(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
                           long long sb, long long sh, long long ss, int rows) {
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

// Rank-2 map of a row-major (rows, cols) matrix of `elem_bytes`-byte
// elements with `row_bytes` between rows; boxes of box_cols × box_rows,
// zero fill out of bounds (rows past the last read as zeros).
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      const void* ptr, long long cols, long long rows, long long row_bytes,
                      int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || cols <= 0 || rows <= 0 || row_bytes < cols * elem_bytes) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace iclk
