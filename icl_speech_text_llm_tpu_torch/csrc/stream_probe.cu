// Device-memory streaming probe (K11) for Hopper (sm_90a).
//
// Replaces: scripts/probe_stream_matrix.py run_2d / stream2d_kernel and
//   scripts/probe_kernel_variants.py launch / k_stream, the Pallas probes
//   that read a buffer tile by tile to measure the streaming rate.
//
// What bounds it on the H100: bytes. It reads every byte of a bf16 buffer
// once and writes one f32 per block, so its bound is the buffer over
// 3.35 TB/s. The rate it reaches is the yardstick that the bytes-bound
// kernels (K7, K10) are read against.
//
// What the design does about it: each block owns one contiguous chunk of
// 16-byte vectors; every thread keeps four 16-byte streaming loads in
// flight (ld.global.cs) and adds the eight bf16 of each in f32, so no
// load can be dropped as dead; the block's sum goes out as one partial.
#include "common.cuh"

namespace iclk {
namespace {

constexpr int kProbeThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float sum8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += __uint_as_float(w[i] << 16) + __uint_as_float(w[i] & 0xffff0000u);
  return s;
}

__global__ void __launch_bounds__(kProbeThreads)
    stream_read_kernel(const uint4* __restrict__ x, long long n_vec, long long chunk,
                       float* __restrict__ partial) {
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(begin + chunk, n_vec);
  float acc = 0.f;
  long long i = begin + threadIdx.x;
  for (; i + (kUnroll - 1) * kProbeThreads < end; i += kUnroll * kProbeThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(x + i + u * kProbeThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += sum8(v[u]);
  }
  for (; i < end; i += kProbeThreads) acc += sum8(__ldcs(x + i));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kProbeThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kProbeThreads / 32; ++w) s += warp_sums[w];
    partial[blockIdx.x] = s;
  }
}

}  // namespace
}  // namespace iclk

// x: n_vec 16-byte vectors (8 bf16 each), 16-byte aligned; partial: (blocks,)
// f32, block i the sum of vectors [i·chunk, (i + 1)·chunk) with chunk =
// ceil(n_vec / blocks). Returns the CUDA error of the launch.
extern "C" int iclk_stream_read(const void* x, void* partial, long long n_vec, int blocks,
                                void* stream) {
  if (n_vec <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const long long chunk = (n_vec + blocks - 1) / blocks;
  iclk::stream_read_kernel<<<blocks, iclk::kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), n_vec, chunk, static_cast<float*>(partial));
  return (int)cudaGetLastError();
}
