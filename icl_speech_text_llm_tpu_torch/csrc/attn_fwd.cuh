// The mma.sync flash-forward skeleton of K9 (gated_bias.cu,
// iclk_gated_bias_rows): BEATs' gated relative-position bias attention with
// the per-row gate precomputed as (B, H, S) f32 rows, non-causal, head dim
// 64. (K3 and K8, whose gate comes from xh inside the kernel, are the
// wgmma/TMA kernel of gated_bias.cu; K1/K2 that of flash_fwd.cu.)
//
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// owns 16 rows. The block walks the key/value sequence in 64-row tiles
// staged in shared memory. Scores, the online-softmax state (running max m,
// running sum l) and the output accumulator stay in registers; the softmax
// runs in f32 in the exp2 domain (scores pre-multiplied by log2 e), and the
// probabilities are rounded to bf16 for the P·V product, as the reference
// kernels do. Ragged edges are masked here: query rows past S are not
// stored, key columns at or past the sample's length get probability 0, and
// key tiles wholly past it are never loaded. A row that sees no valid key
// has l == 0 and writes 0. The batch is the fastest grid axis, so the
// blocks of one (q-tile, head) are scheduled back to back and the bias rows
// they share come from L2 after the first read.
#pragma once

#include <math.h>

#include "common.cuh"

namespace iclk {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* lengths;      // (B,) valid key count; null = all S keys
  const bf16* bias;        // (H, S, S) contiguous
  const float* gate_rows;  // (B, H, S) contiguous
  int H, S;
  // element strides of the batch, head and sequence axes (the head_dim axis
  // is contiguous)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float sm_scale;
};

constexpr size_t kAttnSmemBytes = (size_t)(kBlockQ + 2 * kBlockK) * (64 + 8) * sizeof(bf16) +
                                  kBlockQ * sizeof(float);

// rows [r_begin, r_begin + 64) of a (rows, 64) operand → smem rows of
// stride 72; rows at or past `limit` are zero-filled. Each thread issues its
// four 16-byte loads before it stores any, so that they are in flight
// together (a plain loop was compiled to one load-store pair at a time,
// which left K9 markedly slower on the H100).
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride,
                                          int r_begin, int limit, int tid) {
  constexpr int CH = 64 / 8;                  // 16-byte chunks per row
  constexpr int PER = kBlockK * CH / kThreads;  // chunks per thread
  static_assert(kBlockQ == kBlockK, "Q and K/V tiles have the same rows");
  uint4 val[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * kThreads, r = i / CH, c = (i % CH) * 8;
    val[k] = r_begin + r < limit
                 ? *reinterpret_cast<const uint4*>(src + (long long)(r_begin + r) * stride + c)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * kThreads;
    *reinterpret_cast<uint4*>(dst + (i / CH) * 72 + (i % CH) * 8) = val[k];
  }
}

__global__ void __launch_bounds__(kThreads) gated_bias_rows_kernel(const AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem_rows[];
  constexpr int D = 64;
  constexpr int LD = D + 8;  // padded row: fragment reads hit 32 distinct banks
  constexpr int NT = kBlockK / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_rows);
  bf16* Ks = Qs + kBlockQ * LD;
  bf16* Vs = Ks + kBlockK * LD;
  float* gate_s = reinterpret_cast<float*>(Vs + kBlockK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, q0 = blockIdx.y * kBlockQ, h = blockIdx.z;
  const int len = p.lengths == nullptr ? p.S : min(max(p.lengths[b], 0), p.S);

  const bf16* qb = p.q + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const bf16* kb = p.k + (long long)b * p.k_sb + (long long)h * p.k_sh;
  const bf16* vb = p.v + (long long)b * p.v_sb + (long long)h * p.v_sh;

  load_rows(Qs, qb, p.q_ss, q0, p.S, tid);
  if (tid < kBlockQ)
    gate_s[tid] =
        q0 + tid < p.S ? p.gate_rows[((long long)b * p.H + h) * p.S + q0 + tid] : 0.f;
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld_u32(Qs + r0 * LD + kk * 16 + 2 * t);
    qf[kk][1] = ld_u32(Qs + (r0 + 8) * LD + kk * 16 + 2 * t);
    qf[kk][2] = ld_u32(Qs + r0 * LD + kk * 16 + 2 * t + 8);
    qf[kk][3] = ld_u32(Qs + (r0 + 8) * LD + kk * 16 + 2 * t + 8);
  }
  const float gate_r[2] = {gate_s[r0], gate_s[r0 + 8]};
  const int row_abs[2] = {q0 + r0, q0 + r0 + 8};

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // per-thread partial sums; reduced at the end

  const int n_tiles = (len + kBlockK - 1) / kBlockK;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_rows(Ks, kb, p.k_ss, kv0, len, tid);
    load_rows(Vs, vb, p.v_ss, kv0, len, tid);
    __syncthreads();

    // raw scores q·kᵀ of this warp's 16 rows against the 64 keys of the tile
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* kr = Ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s[nt], qf[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
    }
    // + gate · bias, key mask, to the exp2 domain
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        float bv = 0.f;
        if (row_abs[ri] < p.S && col < len)
          bv = __bfloat162float(p.bias[((long long)h * p.S + row_abs[ri]) * p.S + col]);
        const float x = fmaf(gate_r[ri], bv, s[nt][e] * p.sm_scale);
        s[nt][e] = col < len ? x * kLog2e : -INFINITY;
      }
    }
    // online-softmax update, then acc += P·V with P rounded to bf16
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float msub[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m_i[ri], mx[ri]);
      const float alpha = (m_i[ri] == -INFINITY) ? 0.f : exp2f(m_i[ri] - m_new);
      m_i[ri] = m_new;
      msub[ri] = (m_new == -INFINITY) ? 0.f : m_new;
      l_i[ri] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * ri] *= alpha;
        acc[dt][2 * ri + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - msub[e >> 1]);
        s[nt][e] = pe;
        l_i[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* vc = vr + dt * 8;
        mma_16816(acc[dt], a, pack_bf16_raw(vc, vc + LD),
                  pack_bf16_raw(vc + 8 * LD, vc + 9 * LD));
      }
    }
  }
  // normalise and store this thread's two rows
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_i[ri];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_abs[ri];
    if (row >= p.S) continue;
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    bf16* orow = p.o + (long long)b * p.o_sb + (long long)h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * ri] * inv, acc[dt][2 * ri + 1] * inv);
  }
}

inline cudaError_t launch_gated_bias_rows(const AttnArgs& a, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gated_bias_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAttnSmemBytes);
  if (e != cudaSuccess) return e;
  const unsigned n_q = (a.S + kBlockQ - 1) / kBlockQ;
  gated_bias_rows_kernel<<<dim3(B, n_q, a.H), kThreads, kAttnSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace iclk
