// In-place KV-cache append for one decode step, all layers at once, for
// Hopper (sm_90a).
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   append_kv / _append_kernel
// cache (L, B, Hkv, S, D) gets new (L, B, Hkv, 1, D) written at row
// positions[b], for k and v, in place.
//
// What bounds it on the H100: nothing but the launch. At the Vicuna-7B
// cache shape (32, 4, 32, S, 128) bf16 a step writes 2 × 1 MB: well under a
// microsecond of HBM time, so one launch for all layers (instead of one
// copy per layer) is the whole design.
//
// What the design does about it: one block per (layer, batch, kv head)
// moves both rows with 16-byte loads and stores; positions are read on the
// device, so the host never synchronises. The kernel copies bytes, so an
// int8 cache (with the caller quantizing the new rows) takes the same path
// with elem_bytes = 1. Positions outside [0, S) are not written.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void append_kv_kernel(char* __restrict__ ck, char* __restrict__ cv,
                                 const char* __restrict__ nk,
                                 const char* __restrict__ nv,
                                 const int* __restrict__ positions, int B, int Hkv,
                                 int S, int row_bytes) {
  const long long idx = blockIdx.x;  // ((l * B) + b) * Hkv + hk
  const int b = (int)((idx / Hkv) % B);
  const int pos = positions[b];
  if (pos < 0 || pos >= S) return;
  const long long dst = (idx * S + pos) * row_bytes;
  const long long src = idx * row_bytes;
  if ((row_bytes & 15) == 0) {
    const int n = row_bytes / 16;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      reinterpret_cast<uint4*>(ck + dst)[i] = reinterpret_cast<const uint4*>(nk + src)[i];
      reinterpret_cast<uint4*>(cv + dst)[i] = reinterpret_cast<const uint4*>(nv + src)[i];
    }
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += blockDim.x) {
      ck[dst + i] = nk[src + i];
      cv[dst + i] = nv[src + i];
    }
  }
}

// cache_k/cache_v (L, B, Hkv, S, D) and new_k/new_v (L, B, Hkv, 1, D),
// contiguous, elem_bytes per element; positions (B,) int32 on the device.
extern "C" int iclk_append_kv(void* cache_k, void* cache_v, const void* new_k,
                              const void* new_v, const void* positions, int L, int B,
                              int Hkv, int S, int D, int elem_bytes, void* stream) {
  const long long blocks = (long long)L * B * Hkv;
  if (blocks <= 0 || blocks > 2147483647LL || S <= 0) return (int)cudaErrorInvalidValue;
  const int row_bytes = D * elem_bytes;
  const int threads = (row_bytes & 15) == 0 ? (row_bytes / 16 < 32 ? 32 : 64) : 128;
  append_kv_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(cache_k), static_cast<char*>(cache_v),
      static_cast<const char*>(new_k), static_cast<const char*>(new_v),
      static_cast<const int*>(positions), B, Hkv, S, row_bytes);
  return (int)cudaGetLastError();
}
