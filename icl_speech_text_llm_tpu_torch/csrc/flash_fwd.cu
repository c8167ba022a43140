// Flash-attention forward, causal and non-causal, for Hopper (sm_90a).
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   _flash_forward / _flash_kernel            (causal, LLM prefill)
//   _flash_forward_noncausal / _flash_inf_kernel (non-causal, Whisper encoder)
//
// What bounds it on the H100: tensor-core FLOPs and the exponentials. At the
// LLM prefill shape (4, 32, 1024, 128) causal it does ~34 GFLOP against
// ~134 MB of q/k/v/o traffic, about 35 µs of bf16 peak either way; at the
// Whisper shape (24, 20, 1500, 64) it does ~276 GFLOP and 1.1e9 exps for
// 0.37 GB, so the FLOPs and the special-function unit bound it (head_dim 64
// halves the FLOPs per exponential).
//
// What the design does about it: scores, softmax state and the output
// accumulator live in registers (mma.sync m16n8k16, f32 accumulate), so the
// (S, S) score matrix never reaches memory; probabilities go from the score
// registers straight into the P·V product; key tiles past the sample's
// length or above the causal diagonal are never loaded; GQA reads key/value
// head h / (H / Hkv) directly instead of a repeated copy. Tiles are loaded
// synchronously without double buffering: this first kernel is right and
// simple, and wgmma/TMA pipelining is later work.
#include "attn_fwd.cuh"

using namespace iclk;

// q (B, H, S, D), k/v (B, Hkv, S_kv, D), o like q: bf16, head_dim contiguous,
// other axes strided (strides: 15 int64 on the host, see set_strides).
// m/l: (B, H, S) f32 row statistics or null. lengths: (B,) int32 or null.
// Returns the CUDA error of the launch (0 on success).
extern "C" int iclk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* m, void* l, const void* lengths, int B, int H,
                              int Hkv, int S, int S_kv, int D, int causal,
                              const long long* strides, float sm_scale,
                              void* stream) {
  AttnArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.S_kv = S_kv;
  a.sm_scale = sm_scale;
  set_strides(a, strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)(causal ? launch_attn_fwd<64, true, kGateNone>(a, B, st)
                        : launch_attn_fwd<64, false, kGateNone>(a, B, st));
  if (D == 128)
    return (int)(causal ? launch_attn_fwd<128, true, kGateNone>(a, B, st)
                        : launch_attn_fwd<128, false, kGateNone>(a, B, st));
  return (int)cudaErrorInvalidValue;
}

// Text of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* iclk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
