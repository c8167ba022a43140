// Flash-attention forward skeleton shared by flash_fwd.cu (causal and
// non-causal attention) and gated_bias.cu (BEATs gated relative-position
// bias attention).
//
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// owns 16 rows. The block walks the key/value sequence in 64-row tiles
// staged in shared memory. Scores, the online-softmax state (running max m,
// running sum l) and the output accumulator stay in registers; the softmax
// runs in f32 in the exp2 domain (scores pre-multiplied by log2 e), and the
// probabilities are rounded to bf16 for the P·V product, as the reference
// kernels do. Ragged edges are masked here: query rows past S are not
// stored, key columns at or past the sample's length (and past the
// diagonal when causal) get probability 0, and key tiles wholly past
// either bound are never loaded. A row that sees no valid key has l == 0
// and writes 0.
#pragma once

#include <math.h>

#include "common.cuh"

namespace iclk {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* m_out;          // (B, H, S) row max, e-domain; may be null
  float* l_out;          // (B, H, S) row sum; may be null
  const int* lengths;    // (B,) valid key count; null = all S_kv keys
  // gated relative-position bias (GATED only)
  const bf16* xh;        // (B, H, S, D) strided like q: the gate input
  const bf16* bias;      // (H, S, S_kv) contiguous
  const float* grep_w;   // (D, 8)
  const float* grep_b;   // (8,)
  const float* grep_a;   // (H,)
  int H, Hkv, S, S_kv;
  // element strides of the batch, head and sequence axes (the head_dim axis
  // is contiguous)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long x_sb, x_sh, x_ss;
  float sm_scale;
};

template <int D, bool GATED>
constexpr size_t attn_smem_bytes() {
  return (size_t)(kBlockQ + 2 * kBlockK) * (D + 8) * sizeof(bf16) +
         (GATED ? kBlockQ * sizeof(float) : 0);
}

template <int D, bool CAUSAL, bool GATED>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;  // padded row: fragment reads hit 32 distinct banks
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int NT = kBlockK / 8;
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr float LN2 = 0.6931471805599453f;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBlockQ * LD;
  bf16* Vs = Ks + kBlockK * LD;
  float* gate_s = reinterpret_cast<float*>(Vs + kBlockK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  int len = p.S_kv;
  if (p.lengths != nullptr) len = min(max(p.lengths[b], 0), p.S_kv);

  const bf16* qb = p.q + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const bf16* kb = p.k + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const bf16* vb = p.v + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBlockQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < p.S)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  if constexpr (GATED) {
    // prologue: the per-row gate g = σ(Σproj[:4])·(σ(Σproj[4:])·grep_a[h] − 1) + 2
    // with proj = xh_row · grep_w + grep_b, in f32
    if (tid < kBlockQ) {
      float gate = 0.f;
      const int row = q0 + tid;
      if (row < p.S) {
        const bf16* xr = p.xh + (long long)b * p.x_sb + (long long)h * p.x_sh +
                         (long long)row * p.x_ss;
        float proj[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) proj[j] = p.grep_b[j];
        for (int d = 0; d < D; ++d) {
          const float x = __bfloat162float(xr[d]);
#pragma unroll
          for (int j = 0; j < 8; ++j) proj[j] = fmaf(x, p.grep_w[d * 8 + j], proj[j]);
        }
        const float ga = 1.f / (1.f + expf(-(proj[0] + proj[1] + proj[2] + proj[3])));
        const float gb = 1.f / (1.f + expf(-(proj[4] + proj[5] + proj[6] + proj[7])));
        gate = ga * (gb * p.grep_a[h] - 1.f) + 2.f;
      }
      gate_s[tid] = gate;
    }
  }
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
  float gate_r[2] = {0.f, 0.f};
  if constexpr (GATED) {
    gate_r[0] = gate_s[r0];
    gate_r[1] = gate_s[r0 + 8];
  }
  const int row_abs[2] = {q0 + r0, q0 + r0 + 8};

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // per-thread partial sums; reduced at the end

  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + kBlockQ);
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kval = zero, vval = zero;
      if (kv0 + r < len) {
        kval = *reinterpret_cast<const uint4*>(kb + (long long)(kv0 + r) * p.k_ss + c);
        vval = *reinterpret_cast<const uint4*>(vb + (long long)(kv0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kval;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vval;
    }
    __syncthreads();

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

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * p.sm_scale;
        if constexpr (GATED) {
          float bv = 0.f;
          if (row_abs[ri] < p.S && col < len)
            bv = __bfloat162float(
                p.bias[((long long)h * p.S + row_abs[ri]) * p.S_kv + col]);
          x = fmaf(gate_r[ri], bv, x);
        }
        bool ok = col < len;
        if (CAUSAL) ok = ok && col <= row_abs[ri];
        x = ok ? x * LOG2E : -INFINITY;
        s[nt][e] = x;
        mx[ri] = fmaxf(mx[ri], x);
      }
    }
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

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_i[ri];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_abs[ri];
    if (row >= p.S) continue;
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    bf16* orow = p.o + (long long)b * p.o_sb + (long long)h * p.o_sh +
                 (long long)row * p.o_ss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * ri] * inv, acc[dt][2 * ri + 1] * inv);
    if (p.m_out != nullptr && t == 0) {
      const long long idx = ((long long)b * p.H + h) * p.S + row;
      p.m_out[idx] = m_i[ri] * LN2;
      p.l_out[idx] = l;
    }
  }
}

template <int D, bool CAUSAL, bool GATED>
cudaError_t launch_attn_fwd(const AttnArgs& a, int B, cudaStream_t stream) {
  auto kern = attn_fwd_kernel<D, CAUSAL, GATED>;
  const size_t smem = attn_smem_bytes<D, GATED>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Fill AttnArgs strides from a host array of 15 int64:
// q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s), xh (b, h, s).
inline void set_strides(AttnArgs& a, const long long* st) {
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.x_sb = st[12]; a.x_sh = st[13]; a.x_ss = st[14];
}

}  // namespace iclk
