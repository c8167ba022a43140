// Flash-attention backward for Hopper (sm_90a): K5 (dq, with the delta
// pre-pass) and K6 (dk, dv).
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   _flash_backward / _flash_bwd_dq_kernel   (K5, dq)
//   _flash_backward / _flash_bwd_dkv_kernel  (K6, dk and dv)
// Given the forward's saved q, k, v, o and row statistics (m, l) and the
// upstream gradient dO, with delta = rowsum(dO ∘ O):
//   P  = exp(q·kᵀ·scale − m) / l   (0 at masked keys and on rows with l == 0)
//   dS = P ∘ (dO·vᵀ − delta) · scale
//   dq = dS·k,  dk = dSᵀ·q,  dv = Pᵀ·dO
// With grouped-query attention (H query heads over Hkv < H key/value heads)
// dk and dv of a kv head are the sums over the H / Hkv query heads that read
// it, which is what repeat_kv followed by autodiff gives.
//
// What bounds it on the H100: tensor-core FLOPs and the exponentials. The
// backward does ~2.5× the forward's matmul FLOPs (five products of a tile
// instead of two: S and dP recomputed in both kernels, then dq, or dk and
// dv) and recomputes P, so at the LLM training shape (4, 32, 1024, 128)
// causal it does ~86 GFLOP and 2 × 67M exponentials against ~200 MB of
// traffic; it is compute-bound like the forward.
//
// What the design does about it: the conventions of attn_fwd.cuh — bf16
// mma.sync m16n8k16 with f32 accumulators, 64-row tiles in padded shared
// memory, four warps of 16 rows each. Neither the (S, S) probabilities nor
// dS ever reach memory: each warp recomputes a 16×16 chunk of S and dP in
// registers, turns it into P and dS, and feeds it straight into the
// accumulating product as an A fragment (the accumulator layout of two
// neighbouring 16×8 score tiles is the A layout). K5 owns 64 query rows and
// walks the key tiles on or below the diagonal and below the sample's
// length, accumulating dq in registers. K6 owns 64 key rows, walks the
// query heads of its kv group and the query tiles that can see it, and
// accumulates dk and dv in registers: no atomics, and dk/dv come out at
// (B, Hkv, S_kv, D) directly. K5's prologue computes delta for its rows and
// writes it for K6. A key tile wholly past the length writes dk = dv = 0.
// Fragments are re-read from shared memory rather than held in registers,
// which keeps the two D = 128 accumulators of K6 in registers without
// spilling. Tiles are loaded synchronously without double buffering;
// wgmma, TMA and warp specialisation are later work.
#include <math.h>

#include "common.cuh"

using namespace iclk;

namespace {

constexpr int kRows = 64;      // rows a block owns and rows of a streamed tile
constexpr int kWarps = 4;
constexpr int kBwdThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;         // K5 only
  const bf16* dout;
  const float* m;        // (B, H, S) row max, e-domain
  const float* l;        // (B, H, S) row sum
  float* delta;          // (B, H, S): written by K5, read by K6
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* lengths;    // (B,) valid key count; null = all S_kv keys
  int H, Hkv, S, S_kv;
  // element strides of the batch, head and sequence axes (head_dim is
  // contiguous): q, k, v, o, dout, dq, dk, dv
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  float sm_scale;
};

template <int D>
constexpr size_t bwd_smem_bytes() {
  return (size_t)4 * kRows * (D + 8) * sizeof(bf16) + 3 * kRows * sizeof(float);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + 64) of a (rows, D) strided matrix into a padded
// shared-memory tile; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int limit, int tid) {
  constexpr int LD = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kRows * CH; i += kBwdThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// c[j] (16×8, j = 0, 1) = X[r0 .. r0+16) · Y[n0 + 8j .. n0 + 8j + 8)ᵀ over
// the D columns of both shared-memory tiles: a 16×16 chunk of X·Yᵀ.
template <int D>
__device__ __forceinline__ void chunk_xyt(float c[2][4], const bf16* X, const bf16* Y,
                                          int r0, int n0, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const bf16* xr = X + (r0 + g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a[0] = ld_u32(xr + kk * 16);
    a[1] = ld_u32(xr + 8 * LD + kk * 16);
    a[2] = ld_u32(xr + kk * 16 + 8);
    a[3] = ld_u32(xr + 8 * LD + kk * 16 + 8);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* yr = Y + (n0 + 8 * j + g) * LD + kk * 16 + 2 * t;
      mma_16816(c[j], a, ld_u32(yr), ld_u32(yr + 8));
    }
  }
}

// acc (16×D) += A · Z[n0 .. n0+16), A the 16×16 chunk held in the
// accumulator layout of two 16×8 tiles c[0], c[1] (rounded to bf16).
template <int D>
__device__ __forceinline__ void chunk_accumulate(float acc[D / 8][4], float c[2][4],
                                                 const bf16* Z, int n0, int g, int t) {
  constexpr int LD = D + 8;
  uint32_t a[4];
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
  const bf16* zr = Z + (n0 + 2 * t) * LD + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const bf16* zc = zr + dt * 8;
    mma_16816(acc[dt], a, pack_bf16_raw(zc, zc + LD),
              pack_bf16_raw(zc + 8 * LD, zc + 9 * LD));
  }
}

// One warp's 16 rows of a (rows, D) accumulator → bf16 rows of `out`
// (rows at or past `limit` are not written).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride, int row0,
                                           int limit, float acc[D / 8][4], int g,
                                           int t) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + g + 8 * ri;
    if (row >= limit) continue;
    bf16* orow = out + (long long)row * row_stride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * ri], acc[dt][2 * ri + 1]);
  }
}

// K5: one block per (64 query rows, head, batch).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kRows * LD;
  bf16* Ks = dOs + kRows * LD;
  bf16* Vs = Ks + kRows * LD;
  float* delta_s = reinterpret_cast<float*>(Vs + kRows * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  int len = p.S_kv;
  if (p.lengths != nullptr) len = min(max(p.lengths[b], 0), p.S_kv);

  const bf16* qb = p.q + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const bf16* kb = p.k + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const bf16* vb = p.v + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  const bf16* ob = p.o + (long long)b * p.o_sb + (long long)h * p.o_sh;
  const bf16* dob = p.dout + (long long)b * p.do_sb + (long long)h * p.do_sh;
  const long long stat0 = ((long long)b * p.H + h) * p.S;

  load_tile<D>(Qs, qb, p.q_ss, q0, p.S, tid);
  load_tile<D>(dOs, dob, p.do_ss, q0, p.S, tid);
  __syncthreads();

  // prologue: delta = rowsum(dO ∘ O) in f32; warp w reduces rows 16w..16w+15
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i, row = q0 + r;
    float s = 0.f;
    if (row < p.S) {
      const bf16* orow = ob + (long long)row * p.o_ss;
      for (int d = lane; d < D; d += 32)
        s += __bfloat162float(dOs[r * LD + d]) * __bfloat162float(orow[d]);
    }
    s = warp_sum(s);
    if (lane == 0) {
      delta_s[r] = s;
      if (row < p.S) p.delta[stat0 + row] = s;
    }
  }
  __syncthreads();

  // this thread's two rows: m in the exp2 domain, 1/l, delta (0, 0 for a row
  // without a valid key or past S, whose probabilities are all 0)
  float m2[2], linv[2], drow[2];
  int row_abs[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = warp * 16 + g + 8 * ri;
    row_abs[ri] = q0 + r;
    m2[ri] = 0.f;
    linv[ri] = 0.f;
    if (row_abs[ri] < p.S) {
      const float l = p.l[stat0 + row_abs[ri]];
      if (l > 0.f) {
        m2[ri] = p.m[stat0 + row_abs[ri]] * kLog2e;
        linv[ri] = 1.f / l;
      }
    }
    drow[ri] = delta_s[r];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int kv_end = len;
  if (CAUSAL) kv_end = min(kv_end, q0 + kRows);
  const int n_tiles = (kv_end + kRows - 1) / kRows;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int kv0 = jt * kRows;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(Ks, kb, p.k_ss, kv0, len, tid);
    load_tile<D>(Vs, vb, p.v_ss, kv0, len, tid);
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kRows / 16; ++c) {
      float s[2][4], dp[2][4];
      chunk_xyt<D>(s, Qs, Ks, warp * 16, c * 16, g, t);
      chunk_xyt<D>(dp, dOs, Vs, warp * 16, c * 16, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          const int col = kv0 + c * 16 + 8 * j + 2 * t + (e & 1);
          bool ok = col < len;
          if (CAUSAL) ok = ok && col <= row_abs[ri];
          const float pe =
              ok ? exp2f((s[j][e] * p.sm_scale) * kLog2e - m2[ri]) * linv[ri] : 0.f;
          s[j][e] = pe * (dp[j][e] - drow[ri]) * p.sm_scale;  // dS
        }
      }
      chunk_accumulate<D>(acc, s, Ks, c * 16, g, t);
    }
  }
  store_rows<D>(p.dq + (long long)b * p.dq_sb + (long long)h * p.dq_sh, p.dq_ss,
                q0 + warp * 16, p.S, acc, g, t);
}

// K6: one block per (64 key rows, kv head, batch).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kRows * LD;
  bf16* Qs = Vs + kRows * LD;
  bf16* dOs = Qs + kRows * LD;
  float* m_s = reinterpret_cast<float*>(dOs + kRows * LD);
  float* linv_s = m_s + kRows;
  float* delta_s = linv_s + kRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = p.H / p.Hkv;
  int len = p.S_kv;
  if (p.lengths != nullptr) len = min(max(p.lengths[b], 0), p.S_kv);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[dt][e] = 0.f;
      dv[dt][e] = 0.f;
    }

  if (k0 < len) {
    load_tile<D>(Ks, p.k + (long long)b * p.k_sb + (long long)hk * p.k_sh, p.k_ss, k0,
                 len, tid);
    load_tile<D>(Vs, p.v + (long long)b * p.v_sb + (long long)hk * p.v_sh, p.v_ss, k0,
                 len, tid);
    const int key_abs[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    // causal: query tiles starting below this key tile see none of it
    const int q_first = CAUSAL ? k0 : 0;
    for (int jh = 0; jh < n_rep; ++jh) {
      const int h = hk * n_rep + jh;
      const bf16* qb = p.q + (long long)b * p.q_sb + (long long)h * p.q_sh;
      const bf16* dob = p.dout + (long long)b * p.do_sb + (long long)h * p.do_sh;
      const long long stat0 = ((long long)b * p.H + h) * p.S;
      for (int q0 = q_first; q0 < p.S; q0 += kRows) {
        __syncthreads();  // every warp is done with the previous query tile
        load_tile<D>(Qs, qb, p.q_ss, q0, p.S, tid);
        load_tile<D>(dOs, dob, p.do_ss, q0, p.S, tid);
        if (tid < kRows) {
          const int row = q0 + tid;
          float m2 = 0.f, li = 0.f, dl = 0.f;
          if (row < p.S) {
            const float l = p.l[stat0 + row];
            if (l > 0.f) {
              m2 = p.m[stat0 + row] * kLog2e;
              li = 1.f / l;
            }
            dl = p.delta[stat0 + row];
          }
          m_s[tid] = m2;
          linv_s[tid] = li;
          delta_s[tid] = dl;
        }
        __syncthreads();
#pragma unroll 1
        for (int c = 0; c < kRows / 16; ++c) {
          float s[2][4], dp[2][4], ds[2][4];
          chunk_xyt<D>(s, Ks, Qs, warp * 16, c * 16, g, t);   // (k·qᵀ) chunk
          chunk_xyt<D>(dp, Vs, dOs, warp * 16, c * 16, g, t); // (v·dOᵀ) chunk
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key_abs[e >> 1];
              const int qc = c * 16 + 8 * j + 2 * t + (e & 1);
              const int qrow = q0 + qc;
              bool ok = key < len && qrow < p.S;
              if (CAUSAL) ok = ok && key <= qrow;
              const float pe =
                  ok ? exp2f((s[j][e] * p.sm_scale) * kLog2e - m_s[qc]) * linv_s[qc] : 0.f;
              ds[j][e] = pe * (dp[j][e] - delta_s[qc]) * p.sm_scale;
              s[j][e] = pe;
            }
          }
          chunk_accumulate<D>(dv, s, dOs, c * 16, g, t);
          chunk_accumulate<D>(dk, ds, Qs, c * 16, g, t);
        }
      }
    }
  }
  store_rows<D>(p.dk + (long long)b * p.dk_sb + (long long)hk * p.dk_sh, p.dk_ss,
                k0 + warp * 16, p.S_kv, dk, g, t);
  store_rows<D>(p.dv + (long long)b * p.dv_sb + (long long)hk * p.dv_sh, p.dv_ss,
                k0 + warp * 16, p.S_kv, dv, g, t);
}

template <typename Kernel>
cudaError_t launch(Kernel kern, size_t smem, dim3 grid, const BwdArgs& a,
                   cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int B, bool causal, cudaStream_t st) {
  const dim3 grid((a.S + kRows - 1) / kRows, a.H, B);
  return causal ? launch(flash_bwd_dq_kernel<D, true>, bwd_smem_bytes<D>(), grid, a, st)
                : launch(flash_bwd_dq_kernel<D, false>, bwd_smem_bytes<D>(), grid, a, st);
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, bool causal, cudaStream_t st) {
  const dim3 grid((a.S_kv + kRows - 1) / kRows, a.Hkv, B);
  return causal ? launch(flash_bwd_dkv_kernel<D, true>, bwd_smem_bytes<D>(), grid, a, st)
                : launch(flash_bwd_dkv_kernel<D, false>, bwd_smem_bytes<D>(), grid, a, st);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* m, const void* l, void* delta, void* dq,
                  void* dk, void* dv, const void* lengths, int H, int Hkv, int S, int S_kv,
                  const long long* st, float sm_scale) {
  BwdArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lengths = static_cast<const int*>(lengths);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.S_kv = S_kv;
  a.sm_scale = sm_scale;
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.do_sb = st[12]; a.do_sh = st[13]; a.do_ss = st[14];
  a.dq_sb = st[15]; a.dq_sh = st[16]; a.dq_ss = st[17];
  a.dk_sb = st[18]; a.dk_sh = st[19]; a.dk_ss = st[20];
  a.dv_sb = st[21]; a.dv_sh = st[22]; a.dv_ss = st[23];
  return a;
}

bool bad_shape(int B, int H, int Hkv, int S, int S_kv, int causal) {
  return B <= 0 || S <= 0 || S_kv <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         (causal && S != S_kv);
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, S_kv, D), o/dout/dq like q: bf16, head_dim
// contiguous, other axes strided (strides: 24 int64 on the host, the
// (b, h, s) strides of q, k, v, o, dout, dq, dk, dv in that order).
// m/l/delta: (B, H, S) f32, contiguous. lengths: (B,) int32 or null.
// K5: writes dq and delta. Returns the CUDA error of the launch.
extern "C" int iclk_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* m, const void* l,
                                 void* delta, void* dq, const void* lengths, int B, int H,
                                 int Hkv, int S, int S_kv, int D, int causal,
                                 const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, Hkv, S, S_kv, causal)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, o, dout, m, l, delta, dq, nullptr, nullptr, lengths,
                              H, Hkv, S, S_kv, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dq<64>(a, B, causal != 0, st);
  if (D == 128) return (int)launch_dq<128>(a, B, causal != 0, st);
  return (int)cudaErrorInvalidValue;
}

// K6: reads delta (from K5), writes dk and dv (B, Hkv, S_kv, D), strided
// like k and v. The o stride slots are unused.
extern "C" int iclk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* m, const void* l,
                                  const void* delta, void* dk, void* dv, const void* lengths,
                                  int B, int H, int Hkv, int S, int S_kv, int D, int causal,
                                  const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, Hkv, S, S_kv, causal)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, nullptr, dout, m, l, const_cast<void*>(delta),
                              nullptr, dk, dv, lengths, H, Hkv, S, S_kv, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dkv<64>(a, B, causal != 0, st);
  if (D == 128) return (int)launch_dkv<128>(a, B, causal != 0, st);
  return (int)cudaErrorInvalidValue;
}
