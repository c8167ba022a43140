// Single-token decode attention over the KV cache (flash decode) for Hopper
// (sm_90a), bf16 cache and int8 cache with per-position scales.
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
// the position for an int8 cache; an e-domain online softmax; v's scale
// multiplies p after p is summed into l; p is rounded to bf16 for the P·V
// product (f32 accumulate); the self column is the f32 Σ q·k_new·sm_scale
// and p_self·v_new is added in f32, unquantized; l == 0 gives o = 0.
//
// What bounds it on the H100: the cache bytes. One decode step of Vicuna-7B
// at batch 4 and ~900 cached positions reads 59 MB a layer (~18 µs at
// 3.35 TB/s) for ~0.03 GFLOP; an int8 cache reads half the bytes plus
// 1/64 of them in scales. The arithmetic is ~1 FLOP a byte.
//
// What the design does about it: one block of 8 warps per (sample, kv head)
// streams that head's rows [0, length) once for all H / Hkv query heads of
// its group (GQA without a repeated copy), in one launch per layer. Each
// half-warp owns a row at a time, a 16-byte load per lane (8 bf16 or 8 int8
// values, converted in registers), and keeps several rows in flight; the
// dot product is a 4-step shuffle reduction inside the half-warp, and each
// half-warp keeps its own f32 (m, l, acc) per query head. The halves of a
// warp merge by shuffles, the 8 warps through shared memory, and the last
// step folds in the self column and writes o. Rows past the length are never
// read, so a short sample in a long cache costs only its own rows.
#include <math.h>

#include "common.cuh"

using namespace iclk;

namespace {

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

// 8 cache values at this lane's columns → f32 (int8 converts exactly).
template <bool Q8>
struct Row8 {
  uint4 raw;
  __device__ __forceinline__ void load(const void* base, long long off) {
    if constexpr (Q8) {
      const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(base) + off);
      raw = make_uint4(r.x, r.y, 0u, 0u);
    } else {
      raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + off);
    }
  }
  __device__ __forceinline__ void to_float(float (&f)[8]) const {
    if constexpr (Q8) {
      const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = (float)(int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
    } else {
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

__device__ __forceinline__ void bf16x8(const bf16* src, float (&f)[8]) {
  Row8<false> r;
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

template <int NREP, bool Q8>
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
    Row8<Q8> kr[U], vr[U];
    float ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + half * U + u;
      if (row < len) {
        kr[u].load(p.k, k_off + (long long)row * p.k_ss);
        vr[u].load(p.v, v_off + (long long)row * p.v_ss);
        if constexpr (Q8) {
          ks[u] = p.k_s[(long long)b * p.ks_sb + (long long)hk * p.ks_sh + (long long)row * p.ks_ss];
          vs[u] = p.v_s[(long long)b * p.vs_sb + (long long)hk * p.vs_sh + (long long)row * p.vs_ss];
        }
      } else {
        kr[u].raw = make_uint4(0u, 0u, 0u, 0u);
        vr[u].raw = make_uint4(0u, 0u, 0u, 0u);
        ks[u] = vs[u] = 0.f;
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
        if constexpr (Q8) s[j] *= ks[u];
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
        if constexpr (Q8) pr *= vs[u];
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

template <int NREP>
cudaError_t launch_nrep(const DecodeArgs& a, int B, bool q8, cudaStream_t stream) {
  dim3 grid(a.Hkv, B);
  if (q8)
    flash_decode_kernel<NREP, true><<<grid, kDecodeThreads, 0, stream>>>(a);
  else
    flash_decode_kernel<NREP, false><<<grid, kDecodeThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, 1, D) bf16 contiguous; k/v a (B, Hkv, S, D) view (bf16, or int8
// with k_s/v_s (B, Hkv, S) f32 scales) with head_dim contiguous; strides: 12
// int64, k (b, h, s), v (b, h, s), k_s (b, h, s), v_s (b, h, s); k_new/v_new
// (B, Hkv, D) bf16 or null; o (B, H, 1, D) bf16; lengths (B,) int32.
extern "C" int iclk_flash_decode(const void* q, const void* k, const void* v,
                                 const void* k_s, const void* v_s, const void* k_new,
                                 const void* v_new, void* o, const void* lengths, int B,
                                 int H, int Hkv, int S, int D, const long long* strides,
                                 float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || D != kD || H % Hkv != 0 || B > 65535 ||
      (k_s == nullptr) != (v_s == nullptr) || (k_new == nullptr) != (v_new == nullptr))
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
  const bool q8 = k_s != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / Hkv) {
    case 1: return (int)launch_nrep<1>(a, B, q8, st);
    case 2: return (int)launch_nrep<2>(a, B, q8, st);
    case 3: return (int)launch_nrep<3>(a, B, q8, st);
    case 4: return (int)launch_nrep<4>(a, B, q8, st);
    case 5: return (int)launch_nrep<5>(a, B, q8, st);
    case 6: return (int)launch_nrep<6>(a, B, q8, st);
    case 7: return (int)launch_nrep<7>(a, B, q8, st);
    case 8: return (int)launch_nrep<8>(a, B, q8, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
