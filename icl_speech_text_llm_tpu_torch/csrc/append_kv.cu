// In-place KV-cache append for one decode step, all layers at once, for
// Hopper (sm_90a): K4 and its quantizing instance K4 q8.
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   append_kv / _append_kernel, and for the int8 cache also the caller's
//   quantize_kv of the new rows and the per-sample update of the two scale
//   planes (icl_speech_text_llm_tpu/models/llama.py, the decode scan body
//   and the scale DUS after it).
// cache (L, B, Hkv, S, D) gets new (L, B, Hkv, 1, D) written at row
// positions[b], for k and v, in place. Positions outside [0, S) are not
// written.
//
// What bounds it on the H100: nothing but the launch. At the Vicuna-7B
// cache shape (32, 4, 32, S, 128) bf16 a step moves 2 × 1 MB in and out,
// and at the salmonn-13b int8 shape (40, 4, 40, S, 128) 3.3 MB of bf16
// rows in and 1.7 MB of int8 rows and scales out: about a microsecond of
// device-memory time either way, under the cost of a launch. What costs is
// the launches around it: an int8 cache quantized by torch takes nine small
// kernels and two staging copies a row set and a layer, and two scale
// writes a step.
//
// What the design does about it: one launch writes every layer.
// - append_kv_kernel (bf16 rows, or int8 rows the caller quantized) moves
//   16 bytes a thread in a grid-stride loop over a grid of at most one
//   wave; each thread issues its k and v loads before it reads its
//   sample's position, whose address they do not need.
// - append_kv_q8_kernel takes the new rows in the activation dtype (bf16 or
//   f32), a group of D/8 lanes a row (16 at D = 128), 8 values a lane: it
//   loads k and v, reduces both row maxima across the group with
//   __shfl_xor_sync, quantizes, and stores 8 int8 a lane and the scale from
//   the group's first lane. The arithmetic is quantize_kv's, bit for bit:
//   amax in f32, scale = amax / 127 by IEEE division, q = round half to
//   even of x / (scale or 1 where scale is 0), no clamp. This file must not
//   be built with --use_fast_math.
#include "common.cuh"

namespace iclk {
namespace {

constexpr int kAppendThreads = 256;

// Blocks of ``kernel`` an SM holds at once (asked once per kernel).
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kAppendThreads, 0) !=
          cudaSuccess || n < 1)
    n = 1;
  return n;
}

// One uint4 (16 bytes) a thread; vpr: uint4 a row.
__global__ void __launch_bounds__(kAppendThreads)
    append_kv_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv,
                     const uint4* __restrict__ nk, const uint4* __restrict__ nv,
                     const int* __restrict__ positions, int n, int B, int Hkv, int S,
                     int vpr) {
  for (int i = blockIdx.x * kAppendThreads + threadIdx.x; i < n;
       i += gridDim.x * kAppendThreads) {
    const uint4 k = __ldcs(nk + i);
    const uint4 v = __ldcs(nv + i);
    const int row = i / vpr;  // ((l * B) + b) * Hkv + hk
    const int pos = positions[(row / Hkv) % B];
    if (pos >= 0 && pos < S) {
      const long long dst = ((long long)row * S + pos) * vpr + (i - row * vpr);
      ck[dst] = k;
      cv[dst] = v;
    }
  }
}

__device__ __forceinline__ void load8(const bf16* p, float x[8]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ float amax8(const float x[8]) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(x[i]));
  return m;
}

// 8 values → 8 int8, round(x / safe) half to even, in one uint2.
__device__ __forceinline__ uint2 quantize8(const float x[8], float safe) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t q = (uint32_t)__float2int_rn(__fdiv_rn(x[i], safe)) & 0xffu;
    w[i / 4] |= q << (8 * (i % 4));
  }
  return make_uint2(w[0], w[1]);
}

// T: the new rows' type (bf16 or float). A row is G = D / 8 lanes of a
// group of P lanes (the power of two ≥ G, at most 32); a warp takes 32 / P
// rows at a time. Every lane of a warp runs every shuffle: the loop's row
// base is the same across the warp.
template <typename T>
__global__ void __launch_bounds__(kAppendThreads)
    append_kv_q8_kernel(int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                        float* __restrict__ ks, float* __restrict__ vs,
                        const T* __restrict__ nk, const T* __restrict__ nv,
                        const int* __restrict__ positions, int rows, int B, int Hkv, int S,
                        int D, int P) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (P - 1);
  const int warp = (blockIdx.x * kAppendThreads + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * kAppendThreads) >> 5;
  const int per_warp = 32 / P;
  for (int base = warp * per_warp; base < rows; base += n_warps * per_warp) {
    const int row = base + lane / P;
    const bool live = row < rows && sub * 8 < D;
    float xk[8], xv[8];
    if (live) {
      load8(nk + (long long)row * D + sub * 8, xk);
      load8(nv + (long long)row * D + sub * 8, xv);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) xk[i] = xv[i] = 0.f;
    }
    const int pos = row < rows ? positions[(row / Hkv) % B] : -1;
    float ak = amax8(xk), av = amax8(xv);
    for (int off = P / 2; off > 0; off >>= 1) {
      ak = fmaxf(ak, __shfl_xor_sync(0xffffffffu, ak, off));
      av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, off));
    }
    if (live && pos >= 0 && pos < S) {
      const float sk = __fdiv_rn(ak, 127.f), sv = __fdiv_rn(av, 127.f);
      const long long dst = (long long)row * S + pos;
      *reinterpret_cast<uint2*>(ck + dst * D + sub * 8) = quantize8(xk, sk == 0.f ? 1.f : sk);
      *reinterpret_cast<uint2*>(cv + dst * D + sub * 8) = quantize8(xv, sv == 0.f ? 1.f : sv);
      if (sub == 0) {
        ks[dst] = sk;
        vs[dst] = sv;
      }
    }
  }
}

template <typename T>
int launch_q8(void* ck, void* cv, void* ks, void* vs, const void* nk, const void* nv,
              const int* positions, int rows, int B, int Hkv, int S, int D, int sms,
              cudaStream_t stream) {
  int P = 1;
  while (P * 8 < D) P *= 2;
  static const int per_sm = blocks_per_sm(append_kv_q8_kernel<T>);
  const long long need = ((long long)rows * P + kAppendThreads - 1) / kAppendThreads;
  const int grid = (int)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  append_kv_q8_kernel<T><<<grid, kAppendThreads, 0, stream>>>(
      static_cast<int8_t*>(ck), static_cast<int8_t*>(cv), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const T*>(nk), static_cast<const T*>(nv),
      positions, rows, B, Hkv, S, D, P);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace iclk

// cache_k/cache_v (L, B, Hkv, S, D) and new_k/new_v (L, B, Hkv, 1, D) of
// one dtype, contiguous, elem_bytes an element, rows and pointers 16-byte
// aligned; positions (B,) int32 on the device; sms: the card's SMs (the
// grid is at most one wave).
extern "C" int iclk_append_kv(void* cache_k, void* cache_v, const void* new_k,
                              const void* new_v, const void* positions, int L, int B,
                              int Hkv, int S, int D, int elem_bytes, int sms, void* stream) {
  using namespace iclk;
  const int row_bytes = D * elem_bytes;
  const long long n = (long long)L * B * Hkv * (row_bytes / 16);
  if (n <= 0 || n > 2147483647LL - (long long)kAppendThreads * 65536 || S <= 0 || sms <= 0 ||
      ((uintptr_t)row_bytes | (uintptr_t)cache_k | (uintptr_t)cache_v | (uintptr_t)new_k |
       (uintptr_t)new_v) % 16)
    return (int)cudaErrorInvalidValue;
  static const int per_sm = blocks_per_sm(append_kv_kernel);
  const long long need = (n + kAppendThreads - 1) / kAppendThreads;
  const int grid = (int)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  append_kv_kernel<<<grid, kAppendThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache_k), static_cast<uint4*>(cache_v),
      static_cast<const uint4*>(new_k), static_cast<const uint4*>(new_v),
      static_cast<const int*>(positions), (int)n, B, Hkv, S, row_bytes / 16);
  return (int)cudaGetLastError();
}

// The int8 cache: cache_k/cache_v (L, B, Hkv, S, D) int8 and scale_k/scale_v
// (L, B, Hkv, S) f32, contiguous; new_k/new_v (L, B, Hkv, 1, D) contiguous,
// f32 when rows_f32 else bf16, 16-byte aligned; D a multiple of 8, at most
// 256; positions (B,) int32 on the device; sms: the card's SMs.
extern "C" int iclk_append_kv_q8(void* cache_k, void* cache_v, void* scale_k, void* scale_v,
                                 const void* new_k, const void* new_v, const void* positions,
                                 int L, int B, int Hkv, int S, int D, int rows_f32, int sms,
                                 void* stream) {
  using namespace iclk;
  const long long rows = (long long)L * B * Hkv;
  if (rows <= 0 || rows * 32 > 2147483647LL || S <= 0 || D <= 0 || D % 8 || D > 256 ||
      sms <= 0 || ((uintptr_t)new_k | (uintptr_t)new_v) % 16 ||
      ((uintptr_t)cache_k | (uintptr_t)cache_v) % 8 || ((uintptr_t)scale_k | (uintptr_t)scale_v) % 4)
    return (int)cudaErrorInvalidValue;
  const int* pos = static_cast<const int*>(positions);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows_f32)
    return launch_q8<float>(cache_k, cache_v, scale_k, scale_v, new_k, new_v, pos, (int)rows, B,
                            Hkv, S, D, sms, s);
  return launch_q8<bf16>(cache_k, cache_v, scale_k, scale_v, new_k, new_v, pos, (int)rows, B,
                         Hkv, S, D, sms, s);
}
