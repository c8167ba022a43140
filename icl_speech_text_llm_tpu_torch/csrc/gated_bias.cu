// Gated relative-position-bias attention (BEATs / WavLM) for Hopper (sm_90a),
// in three schedules over the attn_fwd.cuh skeleton.
//
// s = q·kᵀ·D^-½ + gate·bias[h] + key mask, per query row
// gate = σ(Σproj[:4])·(σ(Σproj[4:])·grep_a[h] − 1) + 2, proj = xh·grep_w + grep_b.
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   K3  flash_attention_gated_bias / _flash_bias_kernel       (default)
//   K8  _gated_bias_batched_call / _flash_bias_batch_kernel   (batch_block=True)
//   K9  flash_attention_gated_bias_rows / _flash_bias_rows_kernel
//       (BeatsConfig.lean_bias_flash: the gate rows arrive precomputed)
//
// What bounds them on the H100: the bias and the tensor cores. At the BEATs
// shape (24, 12, 1496, 64) the (H, S, S) bf16 table is 54 MB and the work is
// ~165 GFLOP (~0.17 ms of bf16 peak) and 0.64e9 exps. K3 runs one block per
// (batch, head, q-tile), so every sample reads its head's bias rows again:
// ~1.3 GB per call; the table about fills the 50 MB L2, so most of those
// reads reach HBM (~0.4 ms at 3.35 TB/s).
//
// What the designs do about it:
// - K3: the register-resident flash skeleton (no (B, H, S, S) logits or
//   gated bias in memory), the gate computed once per query row in a
//   prologue, the bias read as bf16 and only inside the valid region.
// - K8: one block per (chunk of kChunk samples, q-tile, head). For each key
//   tile the block stages the 64×64 bias tile in shared memory once and
//   runs the flash step of every sample of the chunk against it; each
//   sample's (m, l, acc) stays in registers, so the chunk is what the
//   registers hold (kChunk × 32 accumulators a thread). The bias is read
//   B / kChunk times instead of B times; the chunk index is the fastest grid
//   axis, so the chunks of one (q-tile, head) run together and share the
//   tiles in L2.
// - K9: K3's skeleton with the gate read from the precomputed (B, H, S) rows
//   instead of the prologue, and the batch as the fastest grid axis, so the
//   blocks of one (q-tile, head) run back to back and read its bias rows
//   from L2 after the first.
#include "attn_fwd.cuh"

using namespace iclk;

namespace {

constexpr int kChunk = 4;  // K8: samples per block

template <int C>
constexpr size_t batched_smem_bytes() {
  constexpr int LD = 64 + 8;
  return (size_t)(C * kBlockQ + 2 * kBlockK) * LD * sizeof(bf16) +  // Q×C, K, V
         (size_t)kBlockQ * (kBlockK + 8) * sizeof(bf16) +          // bias tile
         (size_t)C * kBlockQ * sizeof(float);                       // gates
}

template <int C>
__global__ void __launch_bounds__(kThreads) gated_bias_batched_kernel(const AttnArgs p,
                                                                       int B) {
  constexpr int D = 64;
  constexpr int LD = D + 8;
  constexpr int LDB = kBlockK + 8;
  constexpr int NT = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + C * kBlockQ * LD;
  bf16* Vs = Ks + kBlockK * LD;
  bf16* Bs = Vs + kBlockK * LD;
  float* gate_s = reinterpret_cast<float*>(Bs + kBlockQ * LDB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * C;
  const int q0 = blockIdx.y * kBlockQ;
  const int h = blockIdx.z;

  int len[C];
  int max_len = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = b0 + c;
    len[c] = b < B ? sample_length(p, b) : 0;
    max_len = max(max_len, len[c]);
    if (b < B) {
      load_rows<D>(Qs + c * kBlockQ * LD,
                   p.q + (long long)b * p.q_sb + (long long)h * p.q_sh, p.q_ss, q0,
                   kBlockQ, p.S, tid);
      if (tid < kBlockQ) gate_s[c * kBlockQ + tid] = gate_of_row<D>(p, b, h, q0 + tid);
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  const int row_abs[2] = {q0 + r0, q0 + r0 + 8};
  float gate_r[C][2];
  float acc[C][D / 8][4];
  float m_i[C][2], l_i[C][2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gate_r[c][0] = gate_s[c * kBlockQ + r0];
    gate_r[c][1] = gate_s[c * kBlockQ + r0 + 8];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      m_i[c][ri] = -INFINITY;
      l_i[c][ri] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][dt][e] = 0.f;
  }

  const bf16* bias_h = p.bias + (long long)h * p.S * p.S_kv;
  const bool vec_bias = (p.S_kv & 7) == 0;
  const int n_tiles = (max_len + kBlockK - 1) / kBlockK;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous bias tile
    for (int i = tid; i < kBlockQ * (kBlockK / 8); i += kThreads) {
      const int r = i / (kBlockK / 8), c8 = (i % (kBlockK / 8)) * 8;
      const int row = q0 + r, col = kv0 + c8;
      const bf16* src = bias_h + (long long)row * p.S_kv + col;
      bf16* dst = Bs + r * LDB + c8;
      if (row < p.S && vec_bias && col + 8 <= p.S_kv) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (row < p.S && col + e < p.S_kv) ? src[e] : __float2bfloat16(0.f);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (kv0 >= len[c]) continue;  // uniform over the block
      const int b = b0 + c;
      __syncthreads();  // the bias tile is stored; the previous K/V tile is used
      load_rows<D>(Ks, p.k + (long long)b * p.k_sb + (long long)h * p.k_sh, p.k_ss, kv0,
                   kBlockK, len[c], tid);
      load_rows<D>(Vs, p.v + (long long)b * p.v_sb + (long long)h * p.v_sh, p.v_ss, kv0,
                   kBlockK, len[c], tid);
      __syncthreads();
      uint32_t qf[D / 16][4];
      q_fragments<D>(qf, Qs + c * kBlockQ * LD, r0, t);
      float s[NT][4];
      tile_scores<D>(s, qf, Ks, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          const int cc = nt * 8 + 2 * t + (e & 1);
          const float bv = __bfloat162float(Bs[(r0 + 8 * ri) * LDB + cc]);
          const float x = fmaf(gate_r[c][ri], bv, s[nt][e] * p.sm_scale);
          s[nt][e] = kv0 + cc < len[c] ? x * kLog2e : -INFINITY;
        }
      }
      tile_update<D>(s, m_i[c], l_i[c], acc[c], Vs, g, t);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (b0 + c < B) store_rows<D>(p, b0 + c, h, row_abs, m_i[c], l_i[c], acc[c], t);
}

AttnArgs gated_args(const void* q, const void* k, const void* v, const void* bias, void* o,
                    const void* lengths, int H, int S, const long long* strides,
                    float sm_scale) {
  AttnArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.bias = static_cast<const bf16*>(bias);
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.Hkv = H;
  a.S = S;
  a.S_kv = S;
  a.sm_scale = sm_scale;
  set_strides(a, strides);
  return a;
}

}  // namespace

// K3. q/k/v/xh (B, H, S, 64) bf16 with strided batch/head/seq axes (15 int64
// strides on the host: q, k, v, o, xh); bias (H, S, S) bf16 contiguous;
// grep_w (64, 8), grep_b (8,), grep_a (H,) f32; lengths (B,) int32 or null.
extern "C" int iclk_gated_bias_fwd(const void* q, const void* k, const void* v,
                                   const void* xh, const void* bias,
                                   const void* grep_w, const void* grep_b,
                                   const void* grep_a, void* o, const void* lengths,
                                   int B, int H, int S, int D,
                                   const long long* strides, float sm_scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  AttnArgs a = gated_args(q, k, v, bias, o, lengths, H, S, strides, sm_scale);
  a.xh = static_cast<const bf16*>(xh);
  a.grep_w = static_cast<const float*>(grep_w);
  a.grep_b = static_cast<const float*>(grep_b);
  a.grep_a = static_cast<const float*>(grep_a);
  return (int)launch_attn_fwd<64, false, kGateProj>(a, B, static_cast<cudaStream_t>(stream));
}

// K8: the arguments of iclk_gated_bias_fwd, the batched schedule.
extern "C" int iclk_gated_bias_batched(const void* q, const void* k, const void* v,
                                       const void* xh, const void* bias,
                                       const void* grep_w, const void* grep_b,
                                       const void* grep_a, void* o, const void* lengths,
                                       int B, int H, int S, int D,
                                       const long long* strides, float sm_scale,
                                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  AttnArgs a = gated_args(q, k, v, bias, o, lengths, H, S, strides, sm_scale);
  a.xh = static_cast<const bf16*>(xh);
  a.grep_w = static_cast<const float*>(grep_w);
  a.grep_b = static_cast<const float*>(grep_b);
  a.grep_a = static_cast<const float*>(grep_a);
  auto kern = gated_bias_batched_kernel<kChunk>;
  const size_t smem = batched_smem_bytes<kChunk>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + kChunk - 1) / kChunk, (S + kBlockQ - 1) / kBlockQ, H);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, B);
  return (int)cudaGetLastError();
}

// K9. q/k/v (B, H, S, 64) bf16 strided (15 int64 strides: q, k, v, o, then
// three unused); scale_rows (B, H, S) f32 contiguous (the gate, not
// log2e-scaled); bias (H, S, S) bf16 contiguous; lengths (B,) int32 or null.
extern "C" int iclk_gated_bias_rows(const void* q, const void* k, const void* v,
                                    const void* scale_rows, const void* bias, void* o,
                                    const void* lengths, int B, int H, int S, int D,
                                    const long long* strides, float sm_scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != 64 || B > 2147483647 || H > 65535)
    return (int)cudaErrorInvalidValue;
  AttnArgs a = gated_args(q, k, v, bias, o, lengths, H, S, strides, sm_scale);
  a.gate_rows = static_cast<const float*>(scale_rows);
  return (int)launch_attn_fwd<64, false, kGateRows>(a, B, static_cast<cudaStream_t>(stream));
}
