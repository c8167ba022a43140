// Gated relative-position-bias attention (BEATs / WavLM) for Hopper (sm_90a).
//
// s = q·kᵀ·D^-½ + g·bias[h] + key mask, per query row
// g = σ(Σproj[:4])·(σ(Σproj[4:])·grep_a[h] − 1) + 2, proj = xh·grep_w + grep_b.
//
// Replaces: icl_speech_text_llm_tpu/ops/flash_attention.py
//   K3  flash_attention_gated_bias / _flash_bias_kernel       (default)
//   K8  _gated_bias_batched_call / _flash_bias_batch_kernel   (batch_block=True)
//   K9  flash_attention_gated_bias_rows / _flash_bias_rows_kernel
//       (BeatsConfig.lean_bias_flash: the gate rows arrive precomputed)
//
// The three are instances of one warp-specialised wgmma/TMA kernel
// (gated_bias_wgmma_kernel, below), built from hopper.cuh like the flash
// forward (flash_fwd.cu): K3 (three consumer warpgroups, one sample a work
// item, the gate computed from xh), K8 (two consumers, two samples an item,
// the gate from xh) and K9 (K3's shape, the gate read from precomputed
// (B, H, S) f32 rows, `scale_rows`, one f32 a row in place of xh's 64 bf16).
//
// What bounds them on the H100. At the BEATs shape (24, 12, 1496, 64) the
// work is 165 GFLOP of Q·Kᵀ and P·V (0.167 ms at the bf16 peak) and 0.64e9
// exp2 (about as long on MUFU), so like K2 the exponentials of one tile must
// run under the products of another. On top of K2's work comes the bias:
// every (sample, head, query row, key) score reads one bf16 of the (H, S, S)
// table, 1.29 GB per call, though the table is 54 MB. The design keeps those
// reads in L2 and shared memory instead of HBM, and adds the bias with one
// FMA a score.
//
// The design (the pieces shared with flash_fwd.cu are in hopper.cuh):
// - Block: NC consumer warpgroups of 64 query rows and one producer warp
//   group. A work item is one (head, query block) and a chunk of C samples;
//   the consumers walk the key tiles (128 keys) of each sample of the chunk,
//   tile-major, with each sample's (m, l, o) in registers. K3: NC = 3
//   (192 rows), C = 1. K8: NC = 2 (128 rows), C = 2: two samples' o
//   accumulators (2 × 32 registers) do not fit beside the scores with three
//   consumer warpgroups (160 registers a thread), but do with two (232).
// - Loads: one producer thread issues every TMA copy (128-byte swizzle): the
//   chunk's Q tiles (rank-4 maps {D, S, H, B} over the model's strided
//   views), then for each key tile first the bias tile, then each sample's K
//   and V tiles. The bias is a third stream: a rank-3 map {S_kv, S, H} over
//   the (H, S, S) table (row stride in elements a multiple of 8: TMA needs
//   16-byte strides; the wrapper pads a copy when S is not), in two boxes
//   of 64 keys × the block's rows, into its own ring. K/V and bias rings
//   have full (transaction bytes) and empty (one arrival per consumer warp)
//   mbarriers; a bias stage is released after the last sample of the chunk
//   has read it, so each bias tile lands in shared memory once per chunk.
// - Shared memory is what limits the depth (227 KB a block; + 1 KB for the
//   1024-byte swizzle alignment, the barriers and the gate weights):
//     K3: Q 24 KB + 3 K/V stages × 32 KB + 2 bias stages × 48 KB = 216 KB;
//     K8: Q 2 × 16 KB + 4 K/V stages × 32 KB + 2 bias stages × 32 KB
//         = 224 KB.
//   With three consumers and 128-key tiles a stage pairing K, V and the
//   bias would be 80 KB, so only two would fit beside Q: the rings are kept
//   apart instead, the K/V ring deeper than the bias ring (K8 takes two K/V
//   stages per bias stage).
// - Products as in flash_fwd.cu: S = Q·Kᵀ by wgmma m64n128k16 from shared
//   memory, O += P·V by m64n64k16 with P from registers; a step's Q·Kᵀ is
//   issued with the previous step's P·V, the consumers take turns to issue
//   (named barriers), setmaxnreg gives the producer's registers to them.
// - The bias: each thread reads its scores' bias values from the swizzled
//   tile in the accumulator's fragment layout (rows r, r + 8, keys
//   8i + 2t, +1: one 32-bit load a pair, conflict-free under the swizzle)
//   and adds bias · g/D^-½ to the raw score with one FMA, so the softmax is
//   flash_fwd.cu's: p = exp2(s·D^-½·log2 e − m·D^-½·log2 e).
// - The gate, once per work item, in f32. From xh (K3, K8): the consumers
//   read their rows of xh from global memory (16-byte loads, issued before Q
//   is waited for); the four threads of a row each take 16 of its 64 dims
//   against the sums of grep_w's first and last four columns (staged in
//   shared memory when the block starts) and add their parts with two
//   shuffles. From the rows (K9): each thread loads the gate of its two rows
//   from `scale_rows`; the weights are not staged.
// - Schedule: a persistent grid, one block per SM, walking items in
//   zig-zag order, numbered with the sample chunk fastest, then the query
//   block, then the head: the items of one (head, query block) run together
//   for every sample, so its bias rows (192 × 1496 × 2 bytes) are read from
//   HBM once and from L2 by the other chunks, and a head's K/V (9 MB for 24
//   samples) stays in L2 over its query blocks.
//   Bias bytes a call at (24, 12, 1496, 64), full lengths: K3 and K9 read
//   1.29 GB from L2 into shared memory (one tile per sample) and ~54 MB
//   from HBM; K8 reads 0.64 GB from L2 (one tile per two samples) and
//   ~54 MB from HBM.
// - Masks and edges: per-sample lengths; key tiles wholly past a sample's
//   length are never loaded, a straddling tile is masked by index; TMA
//   zero-fills rows past S (and keys past S_kv), which are not stored; a row
//   with no valid key writes o = 0; a chunk past the batch's end takes only
//   its samples that exist.
#include <algorithm>

#include "hopper.cuh"

using namespace iclk;

namespace {

// NC consumer warpgroups of 64 query rows, plus the producer; C samples a
// work item.
template <int NC, int C>
struct GCfg {
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBlockM = NC * kRowsWG;          // query rows of a block
  static constexpr int kQBytes = kBlockM * 128;         // one sample's Q tile
  static constexpr int kKVBytes = 2 * kBoxBytes;        // a K and a V tile of 128 keys
  static constexpr int kBiasBoxBytes = kBlockM * 128;   // 64 keys of the block's rows
  static constexpr int kBiasBytes = 2 * kBiasBoxBytes;  // a bias tile of 128 keys
  static constexpr int kKVStages = C == 1 ? 3 : 4;
  static constexpr int kBiasStages = 2;
  static constexpr int kBars = 2 * kKVStages + 2 * kBiasStages + 2;
  static constexpr int kWeightBytes = 4 * (2 * 64 + 4);  // wa[64], wb[64], ba, bb
  static constexpr int kSmem = C * kQBytes + kKVStages * kKVBytes + kBiasStages * kBiasBytes +
                               8 * kBars + kWeightBytes + 1024;
  static constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
  static constexpr int kProducerRegs = NC == 2 ? 40 : 32;
  static constexpr int kConsumerRegs =
      ((kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * NC)) / 8 * 8;
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(C == 1 || C == 2, "the step dispatch takes one or two samples an item");
};

struct GArgs {
  const bf16* xh;          // the gate from xh (K3, K8) ...
  const float* gate_rows;  // ... or from (B, H, S) f32 rows (K9)
  bf16* o;
  const int* lengths;  // (B,) valid key count; null = all S keys
  const float* grep_w;  // (64, 8)
  const float* grep_b;  // (8,)
  const float* grep_a;  // (H,)
  int B, H, S;
  long long o_sb, o_sh, o_ss;  // element strides of o and xh (head dim contiguous)
  long long x_sb, x_sh, x_ss;
  float sm_scale;
};

// Shared-memory layout from the 1024-aligned base: Q tiles [C], K/V stages
// (K tile, V tile), bias stages (two boxes of 64 keys), the barriers
// kv_full, kv_empty, b_full, b_empty, q_full, q_empty, then the gate
// weights. `ptr` is the generic address of `base`.
template <int NC, int C>
struct GSmem {
  using G = GCfg<NC, C>;
  uint32_t base;
  unsigned char* ptr;
  __device__ uint32_t q(int c) const { return base + c * G::kQBytes; }
  __device__ uint32_t k(int st) const { return base + C * G::kQBytes + st * G::kKVBytes; }
  __device__ uint32_t v(int st) const { return k(st) + kBoxBytes; }
  __device__ uint32_t bias(int st) const { return k(G::kKVStages) + st * G::kBiasBytes; }
  __device__ uint32_t bar(int i) const { return bias(G::kBiasStages) + 8 * i; }
  __device__ uint32_t kv_full(int st) const { return bar(st); }
  __device__ uint32_t kv_empty(int st) const { return bar(G::kKVStages + st); }
  __device__ uint32_t b_full(int st) const { return bar(2 * G::kKVStages + st); }
  __device__ uint32_t b_empty(int st) const {
    return bar(2 * G::kKVStages + G::kBiasStages + st);
  }
  __device__ uint32_t q_full() const { return bar(G::kBars - 2); }
  __device__ uint32_t q_empty() const { return bar(G::kBars - 1); }
  __device__ float* weights() const {
    return reinterpret_cast<float*>(ptr + (bar(G::kBars) - base));
  }
  __device__ const unsigned char* at(uint32_t addr) const { return ptr + (addr - base); }
};

// One work item: query rows q0.. of head h for samples b0..b0 + C − 1; a
// sample past the batch has no key tile.
template <int C>
struct GWork {
  int q0, h, b0;
  int len[C], nt[C];
  int nt_max, n_steps;
};

template <int C, int BLOCK_M>
__device__ __forceinline__ GWork<C> gwork_of(const GArgs& p, int item, int n_q, int n_chunks) {
  GWork<C> w;
  w.b0 = (item % n_chunks) * C;
  const int r = item / n_chunks;
  w.q0 = (r % n_q) * BLOCK_M;
  w.h = r / n_q;
  w.nt_max = 0;
  w.n_steps = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = w.b0 + c;
    w.len[c] = b >= p.B ? 0 : p.lengths == nullptr ? p.S : min(max(p.lengths[b], 0), p.S);
    w.nt[c] = (w.len[c] + kBlockN - 1) / kBlockN;
    w.nt_max = max(w.nt_max, w.nt[c]);
    w.n_steps += w.nt[c];
  }
  return w;
}

// s = Q_wg · K_tileᵀ (D = 64: one box, four k-steps of 32 bytes).
__device__ __forceinline__ void gb_issue_scores(float (&s)[64], uint32_t q_wg, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n128(s, smem_desc(q_wg + kk * 32, 16, 1024), smem_desc(k + kk * 32, 16, 1024),
                  kk > 0);
}

// o += P · V_tile: k-step kk covers keys 16kk..16kk+15.
__device__ __forceinline__ void gb_issue_pv(float (&o)[32], const uint32_t (&pr)[32],
                                            uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_rs_n64(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3],
                 smem_desc(v + kk * 2048, kBoxBytes, 1024));
}

// A sample index of the chunk as a type: the step that issues the
// previous step's P·V is instantiated for each accumulator it may go to.
template <int N>
struct SampleIdx {
  static constexpr int value = N;
};

// s += bias · gr, gr the gate over D^-½ (raw-score units), for this
// thread's rows lr0, lr0 + 8 (local to the block; lr0 % 8 == g) and keys
// 8i + 2t, +1 of the tile: box i / 8, 16-byte chunk (i % 8) ^ g under the
// 128-byte swizzle.
template <int BLOCK_M>
__device__ __forceinline__ void add_bias(float (&s)[64], const unsigned char* tile, int lr0,
                                         int g, int t, const float (&gr)[2]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const unsigned char* cell = tile + (i >> 3) * (BLOCK_M * 128) + (((i & 7) ^ g) << 4) + 4 * t;
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(cell + (lr0 + 8 * ri) * 128);
      s[4 * i + 2 * ri] = fmaf(__uint_as_float(u << 16), gr[ri], s[4 * i + 2 * ri]);
      s[4 * i + 2 * ri + 1] =
          fmaf(__uint_as_float(u & 0xffff0000u), gr[ri], s[4 * i + 2 * ri + 1]);
    }
  }
}

// The gate of rows row0 and row0 + 8 of sample b over D^-½: this thread
// (t of the row's four) takes dims 16t..16t+15 of xh against wa / wb (the
// sums of grep_w's first and last four columns), the four add their parts.
// 0 for a row past S. Every lane of the warp calls it (the shuffles).
__device__ __forceinline__ void gate_pair(const GArgs& p, const float* wts, int b, int h,
                                          int row0, int t, float (&gr)[2]) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + 8 * ri;
    float pa = 0.f, pb = 0.f;
    if (row < p.S) {
      const uint4* x = reinterpret_cast<const uint4*>(
          p.xh + (long long)b * p.x_sb + (long long)h * p.x_sh + (long long)row * p.x_ss +
          16 * t);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 u = x[half];
        const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t bits = e & 1 ? wd[e >> 1] & 0xffff0000u : wd[e >> 1] << 16;
          const float xv = __uint_as_float(bits);
          const int d = 16 * t + 8 * half + e;
          pa = fmaf(xv, wts[d], pa);
          pb = fmaf(xv, wts[64 + d], pb);
        }
      }
    }
    pa += __shfl_xor_sync(0xffffffffu, pa, 1);
    pa += __shfl_xor_sync(0xffffffffu, pa, 2);
    pb += __shfl_xor_sync(0xffffffffu, pb, 1);
    pb += __shfl_xor_sync(0xffffffffu, pb, 2);
    const float ga = 1.f / (1.f + expf(-(pa + wts[128])));
    const float gb = 1.f / (1.f + expf(-(pb + wts[129])));
    gr[ri] = row < p.S ? (ga * (gb * p.grep_a[h] - 1.f) + 2.f) / p.sm_scale : 0.f;
  }
}

// One consumer warpgroup's share of a work item: rows q0 + 64·cw.. of each
// sample of the chunk. `q_phase` is the parity of the item's Q load; the
// item's K/V steps start at ring index kv0, its bias tiles at bt0. ROWS: the
// gate is read from p.gate_rows, else computed from xh.
template <int NC, int C, bool ROWS>
__device__ __forceinline__ void gb_consumer_item(const GArgs& p, const GSmem<NC, C>& sm, int cw,
                                                 const GWork<C>& w, uint32_t q_phase, int kv0,
                                                 int bt0) {
  using G = GCfg<NC, C>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = cw * kRowsWG + warp * 16 + g;  // this thread's first row in the block
  const int row0 = w.q0 + lr0;
  const float scale2 = p.sm_scale * kLog2eF;

  float gr[C][2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (w.nt[c] == 0) {
      gr[c][0] = gr[c][1] = 0.f;
    } else if constexpr (ROWS) {
      const long long r0 = ((long long)(w.b0 + c) * p.H + w.h) * p.S;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int row = row0 + 8 * ri;
        gr[c][ri] = row < p.S ? p.gate_rows[r0 + row] / p.sm_scale : 0.f;
      }
    } else {
      gate_pair(p, sm.weights(), w.b0 + c, w.h, row0, t, gr[c]);
    }
  }
  float o[C][32];
  float m[C][2], l[C][2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    m[c][0] = m[c][1] = -INFINITY;
    l[c][0] = l[c][1] = 0.f;  // per-thread partial sums, reduced at the end
  }

  if (w.n_steps > 0) {
    // turns between the consumer warpgroups, as in flash_fwd.cu
    const int next = cw + 1 == NC ? 0 : cw + 1;
    const bool last_wg = cw == NC - 1;
    if (last_wg) named_bar_arrive(1, 2 * 128);
    float s[64];
    uint32_t pr[32];
    float alpha[2];
    int step = 0, prev_c = -1, prev_st = 0;
    mbar_wait(sm.q_full(), q_phase);
    for (int j = 0; j < w.nt_max; ++j) {
      const int bs = (bt0 + j) % G::kBiasStages;
      mbar_wait(sm.b_full(bs), (uint32_t)((bt0 + j) / G::kBiasStages) & 1u);
      const unsigned char* bias_tile = sm.at(sm.bias(bs));
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (j >= w.nt[c]) continue;
        const int st = (kv0 + step) % G::kKVStages;
        named_bar_sync(1 + cw, 2 * 128);
        mbar_wait(sm.kv_full(st), (uint32_t)((kv0 + step) / G::kKVStages) & 1u);
        const bool release = !last_wg || step < w.n_steps - 1;
        // The step, given the sample PC of the previous step (−1: the
        // item's first step) as a constant: the accumulator that P·V goes
        // to is then fixed on every path, so ptxas pairs each wgmma with
        // its wait and does not serialise them (C7514, C7515).
        auto body = [&](auto prev) {
          constexpr int PC = decltype(prev)::value;
          wgmma_fence();
          gb_issue_scores(s, sm.q(c) + cw * kWGBoxBytes, sm.k(st));
          wgmma_commit();
          if constexpr (PC >= 0) {
            gb_issue_pv(o[PC], pr, sm.v(prev_st));
            wgmma_commit();
          }
          if (release) named_bar_arrive(1 + next, 2 * 128);
          if constexpr (PC >= 0)
            wgmma_wait<1>();  // the scores of this step; the previous P·V runs on
          else
            wgmma_wait<0>();
          fence_regs(s);
          if (step == w.n_steps - 1 && lane == 0) mbar_arrive(sm.q_empty());
          add_bias<G::kBlockM>(s, bias_tile, lr0, g, t, gr[c]);
          const int kv_first = j * kBlockN;
          softmax_tile<false>(s, m[c], l[c], alpha, kv_first + kBlockN > w.len[c], kv_first,
                              w.len[c], row0, t, scale2);
          if constexpr (PC >= 0) {
            wgmma_wait<0>();
            fence_regs(o[PC]);
            fence_regs(pr);
            if (lane == 0) mbar_arrive(sm.kv_empty(prev_st));
          }
        };
        if (prev_c < 0)
          body(SampleIdx<-1>{});
        else if (C == 1 || prev_c == 0)
          body(SampleIdx<0>{});
        else
          body(SampleIdx<C - 1>{});
        rescale<64>(o[c], alpha);
        scores_to_a(pr, s);
        prev_c = c;
        prev_st = st;
        ++step;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.b_empty(bs));  // every sample of the chunk has read it
    }
    auto last_pv = [&](auto prev) {
      constexpr int PC = decltype(prev)::value;
      wgmma_fence();
      gb_issue_pv(o[PC], pr, sm.v(prev_st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o[PC]);
      fence_regs(pr);
    };
    if (C == 1 || prev_c == 0)
      last_pv(SampleIdx<0>{});
    else
      last_pv(SampleIdx<C - 1>{});
    if (lane == 0) mbar_arrive(sm.kv_empty(prev_st));
  }

  // Epilogue: normalise by l, store rows < S of the samples that exist.
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = w.b0 + c;
    if (b >= p.B) continue;
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float lr = l[c][ri];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row0 + 8 * ri;
      if (row >= p.S) continue;
      const float inv = lr == 0.f ? 1.f : 1.f / lr;
      bf16* orow =
          p.o + (long long)b * p.o_sb + (long long)w.h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * t) =
            pack_bf16(o[c][4 * i + 2 * ri] * inv, o[c][4 * i + 2 * ri + 1] * inv);
    }
  }
}

template <int NC, int C, bool ROWS>
__global__ void __launch_bounds__(GCfg<NC, C>::kThreads, 1)
    gated_bias_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_b, const GArgs p) {
  using G = GCfg<NC, C>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const GSmem<NC, C> sm{base, smem_raw + (base - raw)};
  const int n_q = (p.S + G::kBlockM - 1) / G::kBlockM;
  const int n_chunks = (p.B + C - 1) / C;
  const int n_items = n_q * n_chunks * p.H;

  if (threadIdx.x == 0) {
    for (int st = 0; st < G::kKVStages; ++st) {
      mbar_init(sm.kv_full(st), 1);
      mbar_init(sm.kv_empty(st), 4 * NC);  // lane 0 of each consumer warp
    }
    for (int st = 0; st < G::kBiasStages; ++st) {
      mbar_init(sm.b_full(st), 1);
      mbar_init(sm.b_empty(st), 4 * NC);
    }
    mbar_init(sm.q_full(), 1);
    mbar_init(sm.q_empty(), 4 * NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the gate weights of the gate from xh: wa[d] = Σ grep_w[d, :4], wb[d] =
  // Σ grep_w[d, 4:], ba = Σ grep_b[:4], bb = Σ grep_b[4:]
  float* wts = sm.weights();
  if constexpr (!ROWS) {
    if (threadIdx.x < 64) {
      const float* wr = p.grep_w + 8 * threadIdx.x;
      wts[threadIdx.x] = (wr[0] + wr[1]) + (wr[2] + wr[3]);
      wts[64 + threadIdx.x] = (wr[4] + wr[5]) + (wr[6] + wr[7]);
    } else if (threadIdx.x == 64) {
      wts[128] = (p.grep_b[0] + p.grep_b[1]) + (p.grep_b[2] + p.grep_b[3]);
      wts[129] = (p.grep_b[4] + p.grep_b[5]) + (p.grep_b[6] + p.grep_b[7]);
    }
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      int n_q_loads = 0, tkv = 0, tb = 0;
      for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
        const int item = item_of(k);
        if (item >= n_items) continue;
        const GWork<C> w = gwork_of<C, G::kBlockM>(p, item, n_q, n_chunks);
        if (w.nt_max == 0) continue;
        mbar_wait(sm.q_empty(), (n_q_loads & 1) ^ 1);
        ++n_q_loads;
        int n_loaded = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) n_loaded += w.nt[c] > 0;
        mbar_expect_tx(sm.q_full(), n_loaded * G::kQBytes);
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (w.nt[c] > 0) tma_load_4d(sm.q(c), &tm_q, sm.q_full(), 0, w.q0, w.h, w.b0 + c);
        for (int j = 0; j < w.nt_max; ++j, ++tb) {
          const int bs = tb % G::kBiasStages;
          mbar_wait(sm.b_empty(bs), ((tb / G::kBiasStages) & 1) ^ 1);
          mbar_expect_tx(sm.b_full(bs), G::kBiasBytes);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_3d(sm.bias(bs) + bx * G::kBiasBoxBytes, &tm_b, sm.b_full(bs),
                        j * kBlockN + 64 * bx, w.q0, w.h);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (j >= w.nt[c]) continue;
            const int st = tkv % G::kKVStages;
            mbar_wait(sm.kv_empty(st), ((tkv / G::kKVStages) & 1) ^ 1);
            mbar_expect_tx(sm.kv_full(st), G::kKVBytes);
            tma_load_4d(sm.k(st), &tm_k, sm.kv_full(st), 0, j * kBlockN, w.h, w.b0 + c);
            tma_load_4d(sm.v(st), &tm_v, sm.kv_full(st), 0, j * kBlockN, w.h, w.b0 + c);
            ++tkv;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs) : "memory");
    int n_q_loads = 0, tkv = 0, tb = 0;
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int item = item_of(k);
      if (item >= n_items) continue;
      const GWork<C> w = gwork_of<C, G::kBlockM>(p, item, n_q, n_chunks);
      gb_consumer_item<NC, C, ROWS>(p, sm, wg - 1, w, n_q_loads & 1, tkv, tb);
      if (w.nt_max > 0) ++n_q_loads;
      tkv += w.n_steps;
      tb += w.nt_max;
    }
  }
}

// Rank-3 map {S_kv, S, H} of the (H, S, S_kv) bf16 bias table with `row`
// elements between rows (a multiple of 8); boxes of 64 keys × `rows` rows,
// 128-byte swizzle, zero fill out of bounds.
bool encode_bias(CUtensorMap* map, const void* ptr, int S, int H, long long row, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || row < S || row % 8 != 0) return false;
  cuuint64_t dims[3] = {(cuuint64_t)S, (cuuint64_t)S, (cuuint64_t)H};
  cuuint64_t strides[2] = {(cuuint64_t)row * sizeof(bf16), (cuuint64_t)row * S * sizeof(bf16)};
  cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The arguments every instance takes: o, lengths and the shape; st holds
// q, k, v, o as (b, h, s) element strides first.
GArgs common_args(void* o, const void* lengths, int B, int H, int S, const long long* st,
                  float sm_scale) {
  GArgs a = {};
  a.o = static_cast<bf16*>(o);
  a.lengths = static_cast<const int*>(lengths);
  a.B = B;
  a.H = H;
  a.S = S;
  a.o_sb = st[9];
  a.o_sh = st[10];
  a.o_ss = st[11];
  a.sm_scale = sm_scale;
  return a;
}

// K3 (NC = 3, C = 1), K8 (NC = 2, C = 2) and K9 (NC = 3, C = 1, ROWS): the
// tensor maps of q, k, v (strides st[0..8]) and of the bias table (rows
// `bias_row` elements apart), then the persistent grid.
template <int NC, int C, bool ROWS>
int launch_gated(const void* q, const void* k, const void* v, const void* bias,
                 long long bias_row, const GArgs& a, int D, const long long* st, void* stream) {
  using G = GCfg<NC, C>;
  const int B = a.B, H = a.H, S = a.S;
  if (B <= 0 || S <= 0 || H <= 0 || D != 64) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tb;
  if (!encode_operand(&tq, q, 64, S, H, B, st[0], st[1], st[2], G::kBlockM) ||
      !encode_operand(&tk, k, 64, S, H, B, st[3], st[4], st[5], kBlockN) ||
      !encode_operand(&tv, v, 64, S, H, B, st[6], st[7], st[8], kBlockN) ||
      !encode_bias(&tb, bias, S, H, bias_row, G::kBlockM))
    return (int)cudaErrorInvalidValue;
  auto kern = gated_bias_wgmma_kernel<NC, C, ROWS>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long n_items =
      (long long)((S + G::kBlockM - 1) / G::kBlockM) * ((B + C - 1) / C) * H;
  if (n_items > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min<long long>(n_items, sms);
  kern<<<grid, G::kThreads, G::kSmem, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, tb, a);
  return (int)cudaGetLastError();
}

// K3 and K8 (the gate from xh): the arguments past `a` filled in.
template <int NC, int C>
int launch_gated_xh(const void* q, const void* k, const void* v, const void* xh,
                    const void* bias, const void* grep_w, const void* grep_b,
                    const void* grep_a, void* o, const void* lengths, int B, int H, int S,
                    int D, const long long* st, float sm_scale, void* stream) {
  GArgs a = common_args(o, lengths, B, H, S, st, sm_scale);
  a.xh = static_cast<const bf16*>(xh);
  a.grep_w = static_cast<const float*>(grep_w);
  a.grep_b = static_cast<const float*>(grep_b);
  a.grep_a = static_cast<const float*>(grep_a);
  a.x_sb = st[12];
  a.x_sh = st[13];
  a.x_ss = st[14];
  return launch_gated<NC, C, false>(q, k, v, bias, st[15], a, D, st, stream);
}

}  // namespace

// K3. q/k/v/xh (B, H, S, 64) bf16 with strided batch/head/seq axes; bias
// (H, S, S) bf16 with rows `strides[15]` elements apart (a multiple of 8 ≥
// S), heads S rows apart; grep_w (64, 8), grep_b (8,), grep_a (H,) f32;
// lengths (B,) int32 or null. strides: 16 int64 on the host, q, k, v, o, xh
// as (b, h, s), then the bias row stride.
extern "C" int iclk_gated_bias_fwd(const void* q, const void* k, const void* v,
                                   const void* xh, const void* bias,
                                   const void* grep_w, const void* grep_b,
                                   const void* grep_a, void* o, const void* lengths,
                                   int B, int H, int S, int D,
                                   const long long* strides, float sm_scale,
                                   void* stream) {
  return launch_gated_xh<3, 1>(q, k, v, xh, bias, grep_w, grep_b, grep_a, o, lengths, B, H, S,
                               D, strides, sm_scale, stream);
}

// K8: the arguments of iclk_gated_bias_fwd, two samples a work item.
extern "C" int iclk_gated_bias_batched(const void* q, const void* k, const void* v,
                                       const void* xh, const void* bias,
                                       const void* grep_w, const void* grep_b,
                                       const void* grep_a, void* o, const void* lengths,
                                       int B, int H, int S, int D,
                                       const long long* strides, float sm_scale,
                                       void* stream) {
  return launch_gated_xh<2, 2>(q, k, v, xh, bias, grep_w, grep_b, grep_a, o, lengths, B, H, S,
                               D, strides, sm_scale, stream);
}

// Dynamic shared memory of a K3/K9 (batched = 0) or K8 (1) block, for the
// build report.
extern "C" int iclk_gated_bias_smem_bytes(int batched) {
  return batched ? GCfg<2, 2>::kSmem : GCfg<3, 1>::kSmem;
}

// K9: K3 with the gate precomputed. q/k/v (B, H, S, 64) bf16 strided;
// scale_rows (B, H, S) f32 contiguous (the gate, not log2e-scaled); bias as
// K3's; lengths (B,) int32 or null. strides: 13 int64, q, k, v, o as
// (b, h, s), then the bias row stride.
extern "C" int iclk_gated_bias_rows(const void* q, const void* k, const void* v,
                                    const void* scale_rows, const void* bias, void* o,
                                    const void* lengths, int B, int H, int S, int D,
                                    const long long* strides, float sm_scale,
                                    void* stream) {
  GArgs a = common_args(o, lengths, B, H, S, strides, sm_scale);
  a.gate_rows = static_cast<const float*>(scale_rows);
  return launch_gated<3, 1, true>(q, k, v, bias, strides[12], a, D, strides, stream);
}
