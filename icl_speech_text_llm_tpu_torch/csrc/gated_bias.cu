// Gated relative-position-bias attention (BEATs / WavLM) for Hopper (sm_90a).
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   flash_attention_gated_bias / _flash_bias_kernel
// s = q·kᵀ·D^-½ + gate·bias[h] + key mask, per query row
// gate = σ(Σproj[:4])·(σ(Σproj[4:])·grep_a[h] − 1) + 2, proj = xh·grep_w + grep_b.
//
// What bounds it on the H100: the bias. At the BEATs shape (24, 12, 1496, 64)
// the (H, S, S) bf16 table is 54 MB and every (batch, query tile) reads its
// head's rows again: ~1.3 GB per call, against ~165 GFLOP and 0.64e9 exps.
// The table about fills the 50 MB L2, so the reads mostly hit HBM (~0.4 ms
// at 3.35 TB/s) and bound the kernel ahead of the tensor cores.
//
// What the design does about it: the same register-resident flash skeleton
// as flash_fwd.cu, so neither the (B, H, S, S) logits nor a gated bias ever
// reach memory; the gate is computed once per query row in a prologue (f32,
// from the xh row, grep_w, grep_b and grep_a[h]) and kept in registers; the
// bias is read as bf16 (half the bytes of f32) and only inside the valid
// (row < S, col < length) region. Reusing one bias tile across the batch is
// the opt-in batched schedule, still to be ported.
#include "attn_fwd.cuh"

using namespace iclk;

// q/k/v/xh (B, H, S, 64) bf16 with strided batch/head/seq axes (15 int64
// strides on the host: q, k, v, o, xh); bias (H, S, S) bf16 contiguous;
// grep_w (64, 8), grep_b (8,), grep_a (H,) f32; lengths (B,) int32 or null.
extern "C" int iclk_gated_bias_fwd(const void* q, const void* k, const void* v,
                                   const void* xh, const void* bias,
                                   const void* grep_w, const void* grep_b,
                                   const void* grep_a, void* o, const void* lengths,
                                   int B, int H, int S, int D,
                                   const long long* strides, float sm_scale,
                                   void* stream) {
  AttnArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.xh = static_cast<const bf16*>(xh);
  a.bias = static_cast<const bf16*>(bias);
  a.grep_w = static_cast<const float*>(grep_w);
  a.grep_b = static_cast<const float*>(grep_b);
  a.grep_a = static_cast<const float*>(grep_a);
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.Hkv = H;
  a.S = S;
  a.S_kv = S;
  a.sm_scale = sm_scale;
  set_strides(a, strides);
  if (B <= 0 || S <= 0 || H <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_fwd<64, false, true>(a, B, static_cast<cudaStream_t>(stream));
}
