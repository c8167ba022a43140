// Flash-attention backward for Hopper (sm_90a): K5 (dq, with delta) and K6
// (dk, dv), warp-specialised wgmma/TMA kernels.
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
// What bounds it on the H100: the tensor cores. At the LLM training shape
// (4, 32, 1024, 128), causal with lengths [1024, 901, 640, 333], the pair
// does seven tile products over 57M (query, key) pairs, 102 GFLOP (K5: S, dP
// and dq; K6: S and dP again, then dv and dk), 0.10 ms at the bf16 peak,
// against ~0.06 ms of traffic for either kernel at 3.35 TB/s. Keeping the
// JAX function's two kernels (one per pallas_call) costs the two recomputed
// products but needs no atomics: each output is summed in registers by the
// block that owns it, so the results are deterministic and each kernel is
// checked on its own against its plain version.
//
// The design (the building blocks are hopper.cuh's, as in flash_fwd.cu):
// - Block: one producer warpgroup and NC consumer warpgroups of 64 rows each.
//   K5 owns query rows (NC = 2 at D = 128, 3 at D = 64); K6 owns key rows
//   (NC = 2: its dk and dv accumulators, 2 × D/2 f32 a thread, beside the
//   two score tiles leave no room for a third). setmaxnreg moves registers
//   from the producer to the consumers (K6: 24 → 240 a thread).
// - Loads: one producer thread issues every TMA copy (128-byte swizzle,
//   rank-4 maps {D, S, H, B} over the strided views, encoded per call): the
//   work item's own tiles once (K5: Q and dO; K6: K and V), then a ring of
//   streamed tile pairs of 64 rows (K5: K and V of each key tile on or below
//   the diagonal and below the sample's length; K6: Q and dO of each query
//   head of the kv group and each query tile that can see the key block),
//   guarded by mbarriers: "full" (transaction bytes) and "empty" (one
//   arrival per consumer warp). Rows past S are zero-filled by TMA.
// - K5, per key tile, in each consumer warpgroup: S = Q·Kᵀ and dP = dO·Vᵀ by
//   wgmma m64n64k16 with both operands K-major in shared memory; then in
//   registers P = exp2(S·scale·log2e − m·log2e)/l and dS = P∘(dP − delta)·
//   scale, rounded to bf16 A fragments (the accumulator layout is the A
//   layout, as the forward's P); then dq += dS·K by wgmma with A from
//   registers and K read MN-major through the descriptor's transpose flag.
//   The prologue computes delta for the thread's two rows in f32 from dO and
//   O (four threads a row, D/4 dims each) and writes it for K6.
// - K6 works in the transposed frame of the JAX kernel (_bwd_tile_grads):
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ from shared memory, Pᵀ and dSᵀ in registers,
//   then dv += Pᵀ·dO and dk += dSᵀ·Q with dO and Q read MN-major. No P or dS
//   tile goes through shared memory. The per-query-row statistics now run
//   along the accumulator's columns, so a second producer warp stages them
//   into each ring stage (m·log2e, 1/l and delta of the tile's 64 rows; +inf,
//   0, 0 for a row with l == 0 or past S, whose P is then 0) and arrives on
//   the stage's full barrier beside the TMA bytes.
// - Overlap: in K5 the consumer warpgroups take turns to issue each key
//   tile's first products (named barriers, round robin, as flash_fwd.cu),
//   and inside a warpgroup tile j's S and dP are issued together with tile
//   j − 1's dq product, tile j's dS being computed while that runs. K6's
//   warpgroups overlap only each other: its 128 dk/dv accumulators leave no
//   room for a second tile's scores, and neither turns nor issuing dv before
//   dSᵀ is computed moved it on the card (`PERF.md`, section 6).
// - Edges: per-sample lengths; key tiles wholly past a length are never
//   loaded and a straddling tile is masked by index; under the causal mask a
//   consumer skips the streamed tiles wholly above its rows' diagonal (it
//   still releases them); a key block wholly past the length writes dk =
//   dv = 0 at once, and a sample of length 0 gets dq = 0. Causal needs S ==
//   S_kv; non-causal takes S ≠ S_kv.
// - Grid: persistent, one block per SM, items in hopper.cuh's zig-zag order
//   (item_of), heaviest first under the causal mask: K5 numbers its query
//   blocks from the last, K6 its key blocks from the first.
#include <algorithm>

#include "hopper.cuh"

using namespace iclk;

namespace {

constexpr int kTile = 64;                    // rows of a streamed tile
constexpr int kTileBoxBytes = kTile * 128;   // one 64-wide box of a streamed tile

// NC consumer warpgroups of 64 rows; a ring of STAGES streamed tile pairs
// with STAT_BYTES of row statistics each; the producer keeps PRODUCER_REGS.
template <int D, int NC, int STAGES, int STAT_BYTES, int PRODUCER_REGS>
struct BCfg {
  static constexpr int kNC = NC;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBlock = NC * kRowsWG;               // rows a work item owns
  static constexpr int kBoxes = D / 64;
  static constexpr int kStages = STAGES;
  static constexpr int kOwnBoxBytes = kBlock * 128;
  static constexpr int kOwnBytes = kBoxes * kOwnBoxBytes;   // one own tile
  static constexpr int kTileBytes = kBoxes * kTileBoxBytes; // one streamed tile
  static constexpr int kStageBytes = 2 * kTileBytes + STAT_BYTES;
  static constexpr int kBarBytes = 8 * (2 * STAGES + 2);
  // + 1024: the base is rounded up to the 1024-byte swizzle atom
  static constexpr int kSmem = 2 * kOwnBytes + STAGES * kStageBytes + kBarBytes + 1024;
  static constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
  static constexpr int kProducerRegs = PRODUCER_REGS;
  static constexpr int kConsumerRegs =
      ((kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * NC)) / 8 * 8;
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle atom's alignment");
};

// K5: query rows, two consumers at D = 128 (dq 64 + S 32 + dP 32 f32 a
// thread), three at D = 64.
template <int D>
using DqCfg = BCfg<D, D == 64 ? 3 : 2, D == 64 ? 6 : 4, 0, D == 64 ? 32 : 56>;
// K6: key rows, two consumers (dk and dv 2 × D/2 + Sᵀ 32 + dPᵀ 32 f32), the
// stage carrying the 64 query rows' m·log2e, 1/l and delta (768 bytes, 1024
// with the padding that keeps the next stage aligned).
template <int D>
using DkvCfg = BCfg<D, 2, D == 64 ? 6 : 4, 1024, 24>;

struct BwdArgs {
  const bf16* o;         // K5: delta's O rows
  const bf16* dout;      // K5: delta's dO rows
  const float* m;        // (B, H, S) row max, e-domain
  const float* l;        // (B, H, S) row sum
  float* delta;          // (B, H, S): written by K5, read by K6
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* lengths;    // (B,) valid key count; null = all S_kv keys
  int B, H, Hkv, S, S_kv;
  // element strides of the batch, head and sequence axes (head_dim is
  // contiguous) of o, dout, dq, dk, dv
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  float sm_scale;
};

// Shared memory from the 1024-aligned base: the item's two own tiles
// (kBoxes boxes of kBlock rows × 128 bytes each), the stages (two streamed
// tiles of kBoxes boxes of 64 rows, then the statistics), then the barriers
// full[stages], empty[stages], own_full, own_empty. `ptr` is the generic
// address of `base`.
template <class C>
struct BSmem {
  uint32_t base;
  unsigned char* ptr;
  __device__ uint32_t own(int i) const { return base + i * C::kOwnBytes; }
  __device__ uint32_t tile(int st, int i) const {
    return base + 2 * C::kOwnBytes + st * C::kStageBytes + i * C::kTileBytes;
  }
  __device__ float* stats(int st) const {
    return reinterpret_cast<float*>(ptr + (tile(st, 2) - base));
  }
  __device__ uint32_t full(int st) const {
    return base + 2 * C::kOwnBytes + C::kStages * C::kStageBytes + 8 * st;
  }
  __device__ uint32_t empty(int st) const { return full(C::kStages + st); }
  __device__ uint32_t own_full() const { return full(2 * C::kStages); }
  __device__ uint32_t own_empty() const { return full(2 * C::kStages + 1); }
};

// d (64 × 64) = X_wg · Y_tileᵀ over D: X the warpgroup's 64 rows of an own
// tile (box offset `x_off` inside each box of kOwnBoxBytes), Y a streamed
// tile; k-step kk reads 32 bytes into box kk / 4 of each row.
template <class C, int D>
__device__ __forceinline__ void issue_xyt(float (&d)[32], uint32_t x, uint32_t x_off,
                                          uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t xo = (kk / 4) * C::kOwnBoxBytes + x_off + (kk % 4) * 32;
    const uint32_t yo = (kk / 4) * kTileBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64(d, smem_desc(x + xo, 16, 1024), smem_desc(y + yo, 16, 1024), kk > 0);
  }
}

// acc (64 × D) += A · Z_tile: A the 64 × 64 bf16 fragments `a`, Z a
// streamed tile of 64 rows read MN-major; k-step kk covers rows
// 16kk..16kk+15 (two 8-row swizzle atoms), D runs across the boxes.
template <int D>
__device__ __forceinline__ void issue_az(float (&acc)[D / 2], const uint32_t (&a)[16],
                                         uint32_t z) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint64_t db = smem_desc(z + kk * 2048, kTileBoxBytes, 1024);
    if constexpr (D == 64)
      wgmma_rs_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db);
    else
      wgmma_rs_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db);
  }
}

// A 64 × 64 accumulator tile as bf16 A fragments: k-step kk takes
// a[4kk..4kk+3], as the forward's P (hopper.cuh:scores_to_a).
__device__ __forceinline__ void scores_to_a32(uint32_t (&a)[16], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Turns of K5's consumer warpgroups at issuing their key tile's first
// products, round robin on named barriers 1..NC as in flash_fwd.cu, so that
// one warpgroup's elementwise pass runs under another's products: take()
// waits for warpgroup c's turn, pass(j) hands it on after tile j (the last
// warpgroup skips its last hand-on, which no one waits for, so every item
// starts from the same state). Every warpgroup takes a turn at every tile of
// the item, also at one it skips.
struct Turns {
  int c, next, n;
  bool last;
  __device__ Turns(int c_, int nc, int n_) : c(c_), next(c_ + 1 == nc ? 0 : c_ + 1), n(n_),
                                             last(c_ == nc - 1) {
    if (last) named_bar_arrive(1, 2 * 128);
  }
  __device__ void take() const { named_bar_sync(1 + c, 2 * 128); }
  __device__ void pass(int j) const {
    if (!last || j < n - 1) named_bar_arrive(1 + next, 2 * 128);
  }
};

// Σ a·b over eight bf16 pairs, in f32.
__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b, float acc) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(wa[i] << 16), __uint_as_float(wb[i] << 16), acc);
    acc = fmaf(__uint_as_float(wa[i] & 0xffff0000u), __uint_as_float(wb[i] & 0xffff0000u), acc);
  }
  return acc;
}

__device__ __forceinline__ int length_of(const BwdArgs& p, int b) {
  return p.lengths == nullptr ? p.S_kv : min(max(p.lengths[b], 0), p.S_kv);
}

// One (B, H, S/S_kv, D) accumulator of a consumer warpgroup → bf16 rows
// row0, row0 + 8 of `out` below `limit`.
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, long long row_stride, int row0, int limit,
                                          const float (&acc)[D / 2], int t) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + 8 * ri;
    if (row >= limit) continue;
    bf16* orow = out + (long long)row * row_stride;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * t) =
          pack_bf16(acc[4 * i + 2 * ri], acc[4 * i + 2 * ri + 1]);
  }
}

// ================================================================ K5 ====

// A K5 work item: query rows q0.. of head h of sample b, and its key tiles.
struct DqWork {
  int q0, h, hk, b, len, n_tiles;
};

// Numbered (b, h, query block) with the query block fastest; under the
// causal mask the blocks of a head run from the heaviest (the last rows).
template <bool CAUSAL, int BLOCK>
__device__ __forceinline__ DqWork dq_work(const BwdArgs& p, int item, int n_q) {
  DqWork w;
  const int r = item % n_q, bh = item / n_q;
  w.q0 = (CAUSAL ? n_q - 1 - r : r) * BLOCK;
  w.h = bh % p.H;
  w.b = bh / p.H;
  w.hk = w.h / (p.H / p.Hkv);
  w.len = length_of(p, w.b);
  const int kv_end = CAUSAL ? min(w.len, w.q0 + BLOCK) : w.len;
  w.n_tiles = (kv_end + kTile - 1) / kTile;
  return w;
}

// One consumer warpgroup's share of a K5 item: query rows r_wg..r_wg + 63.
// `own_phase` is the parity of the item's Q/dO load, `t0` the ring index of
// its first key tile.
template <int D, bool CAUSAL>
__device__ __forceinline__ void dq_consumer_item(const BwdArgs& p, const BSmem<DqCfg<D>>& sm,
                                                 int c, const DqWork& w, uint32_t own_phase,
                                                 int t0) {
  using C = DqCfg<D>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r_wg = w.q0 + c * kRowsWG;
  const int row0 = r_wg + warp * 16 + g;
  const float scale2 = p.sm_scale * kLog2eF;
  const long long stat0 = ((long long)w.b * p.H + w.h) * p.S;

  // delta = rowsum(dO ∘ O) of rows row0, row0 + 8 in f32 (the four threads
  // of a row take D/4 dims each), written for K6; m in the exp2 domain and
  // 1/l (+inf and 0 for a row with l == 0 or past S: its P is 0).
  float m2[2], linv[2], dl[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + 8 * ri;
    float s = 0.f;
    m2[ri] = INFINITY;
    linv[ri] = 0.f;
    if (row < p.S) {
      const uint4* dor = reinterpret_cast<const uint4*>(
          p.dout + (long long)w.b * p.do_sb + (long long)w.h * p.do_sh +
          (long long)row * p.do_ss + t * (D / 4));
      const uint4* orow = reinterpret_cast<const uint4*>(
          p.o + (long long)w.b * p.o_sb + (long long)w.h * p.o_sh + (long long)row * p.o_ss +
          t * (D / 4));
#pragma unroll
      for (int i = 0; i < D / 32; ++i) s = dot_bf16x8(dor[i], orow[i], s);
      const float l = p.l[stat0 + row];
      if (l > 0.f) {
        m2[ri] = p.m[stat0 + row] * kLog2eF;
        linv[ri] = 1.f / l;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dl[ri] = s;
    if (t == 0 && row < p.S) p.delta[stat0 + row] = s;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (w.n_tiles > 0) {
    // key tiles this warpgroup computes: under the causal mask those on or
    // below its rows' diagonal; none when its rows are all past S
    int n_wg = CAUSAL ? min(w.n_tiles, (r_wg + kRowsWG) / kTile) : w.n_tiles;
    if (r_wg >= p.S) n_wg = 0;
    const Turns turns(c, C::kNC, w.n_tiles);
    auto stage = [&](int j) { return (t0 + j) % C::kStages; };
    auto phase = [&](int j) { return (uint32_t)((t0 + j) / C::kStages) & 1u; };
    // dS of key tile j in place of its scores s (dp: dO·Vᵀ)
    auto ds_tile = [&](float (&s)[32], const float (&dp)[32], int j) {
      const int kv0 = j * kTile;
      const bool mask = kv0 + kTile > w.len || (CAUSAL && kv0 + kTile - 1 > r_wg);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          float pe = exp2_mufu(fmaf(s[4 * i + e], scale2, -m2[ri])) * linv[ri];
          if (mask) {
            const int col = kv0 + 8 * i + 2 * t + (e & 1);
            bool ok = col < w.len;
            if (CAUSAL) ok = ok && col <= row0 + 8 * ri;
            if (!ok) pe = 0.f;
          }
          s[4 * i + e] = pe * (dp[4 * i + e] - dl[ri]) * p.sm_scale;
        }
    };
    mbar_wait(sm.own_full(), own_phase);
    float s[32], dp[32];
    uint32_t ds[16];
    // Tile j's Q·Kᵀ and dO·Vᵀ are issued with tile j − 1's dq product, and
    // tile j's dS is computed while that product runs.
    if (n_wg > 0) {
      turns.take();
      mbar_wait(sm.full(stage(0)), phase(0));
      wgmma_fence();
      issue_xyt<C, D>(s, sm.own(0), c * kWGBoxBytes, sm.tile(stage(0), 0));   // Q·Kᵀ
      issue_xyt<C, D>(dp, sm.own(1), c * kWGBoxBytes, sm.tile(stage(0), 1));  // dO·Vᵀ
      wgmma_commit();
      turns.pass(0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (n_wg == 1 && lane == 0) mbar_arrive(sm.own_empty());  // Q, dO read for the last time
      ds_tile(s, dp, 0);
      scores_to_a32(ds, s);
      for (int j = 1; j < n_wg; ++j) {
        turns.take();
        mbar_wait(sm.full(stage(j)), phase(j));
        wgmma_fence();
        issue_xyt<C, D>(s, sm.own(0), c * kWGBoxBytes, sm.tile(stage(j), 0));
        issue_xyt<C, D>(dp, sm.own(1), c * kWGBoxBytes, sm.tile(stage(j), 1));
        wgmma_commit();
        issue_az<D>(dq, ds, sm.tile(stage(j - 1), 0));  // dq += dS·K of tile j − 1
        wgmma_commit();
        turns.pass(j);
        wgmma_wait<1>();  // the products of tile j; dq runs on
        fence_regs(s);
        fence_regs(dp);
        if (j == n_wg - 1 && lane == 0) mbar_arrive(sm.own_empty());
        ds_tile(s, dp, j);
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(ds);
        if (lane == 0) mbar_arrive(sm.empty(stage(j - 1)));
        scores_to_a32(ds, s);
      }
      wgmma_fence();
      issue_az<D>(dq, ds, sm.tile(stage(n_wg - 1), 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(sm.empty(stage(n_wg - 1)));
    } else if (lane == 0) {
      mbar_arrive(sm.own_empty());
    }
    // tiles above this warpgroup's diagonal: its turn and the release only
    for (int j = n_wg; j < w.n_tiles; ++j) {
      turns.take();
      turns.pass(j);
      mbar_wait(sm.full(stage(j)), phase(j));
      if (lane == 0) mbar_arrive(sm.empty(stage(j)));
    }
  }
  store_acc<D>(p.dq + (long long)w.b * p.dq_sb + (long long)w.h * p.dq_sh, p.dq_ss, row0, p.S,
               dq, t);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const BwdArgs p) {
  using C = DqCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const BSmem<C> sm{base, smem_raw + (base - raw)};
  const int n_q = (p.S + C::kBlock - 1) / C::kBlock;
  const int n_items = n_q * p.H * p.B;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 4 * C::kNC);  // lane 0 of each consumer warp
    }
    mbar_init(sm.own_full(), 1);
    mbar_init(sm.own_empty(), 4 * C::kNC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      int n_own = 0, t = 0;
      for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
        const int item = item_of(k);
        if (item >= n_items) continue;
        const DqWork w = dq_work<CAUSAL, C::kBlock>(p, item, n_q);
        if (w.n_tiles == 0) continue;
        mbar_wait(sm.own_empty(), (n_own & 1) ^ 1);
        ++n_own;
        mbar_expect_tx(sm.own_full(), 2 * C::kOwnBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          tma_load_4d(sm.own(0) + bx * C::kOwnBoxBytes, &tm_q, sm.own_full(), 64 * bx, w.q0, w.h,
                      w.b);
          tma_load_4d(sm.own(1) + bx * C::kOwnBoxBytes, &tm_do, sm.own_full(), 64 * bx, w.q0,
                      w.h, w.b);
        }
        for (int j = 0; j < w.n_tiles; ++j, ++t) {
          const int st = t % C::kStages;
          mbar_wait(sm.empty(st), ((t / C::kStages) & 1) ^ 1);
          mbar_expect_tx(sm.full(st), 2 * C::kTileBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx) {
            tma_load_4d(sm.tile(st, 0) + bx * kTileBoxBytes, &tm_k, sm.full(st), 64 * bx,
                        j * kTile, w.hk, w.b);
            tma_load_4d(sm.tile(st, 1) + bx * kTileBoxBytes, &tm_v, sm.full(st), 64 * bx,
                        j * kTile, w.hk, w.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    int n_own = 0, t = 0;
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int item = item_of(k);
      if (item >= n_items) continue;
      const DqWork w = dq_work<CAUSAL, C::kBlock>(p, item, n_q);
      dq_consumer_item<D, CAUSAL>(p, sm, wg - 1, w, n_own & 1, t);
      if (w.n_tiles > 0) ++n_own;
      t += w.n_tiles;
    }
  }
}

// ================================================================ K6 ====

// A K6 work item: key rows k0.. of kv head hk of sample b; its streamed
// tiles are query tiles q_first..n_qt − 1 of each query head of the group.
struct DkvWork {
  int k0, hk, b, len, q_first, per_head, n_tiles;
};

// Numbered (b, hk, key block) with the key block fastest, from the first
// (under the causal mask the heaviest: every query tile sees it).
template <bool CAUSAL, int BLOCK>
__device__ __forceinline__ DkvWork dkv_work(const BwdArgs& p, int item, int n_kb) {
  DkvWork w;
  const int r = item / n_kb;
  w.k0 = (item % n_kb) * BLOCK;
  w.hk = r % p.Hkv;
  w.b = r / p.Hkv;
  w.len = length_of(p, w.b);
  w.q_first = CAUSAL ? w.k0 / kTile : 0;
  const int n_qt = (p.S + kTile - 1) / kTile;
  w.per_head = w.k0 < w.len ? max(n_qt - w.q_first, 0) : 0;
  w.n_tiles = w.per_head * (p.H / p.Hkv);
  return w;
}

// One consumer warpgroup's share of a K6 item: key rows kw..kw + 63.
template <int D, bool CAUSAL>
__device__ __forceinline__ void dkv_consumer_item(const BwdArgs& p, const BSmem<DkvCfg<D>>& sm,
                                                  int c, const DkvWork& w, uint32_t own_phase,
                                                  int t0) {
  using C = DkvCfg<D>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw = w.k0 + c * kRowsWG;
  const int key0 = kw + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float scale2 = p.sm_scale * kLog2eF;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  if (w.n_tiles > 0) {
    const bool live = kw < w.len;  // some key of this warpgroup is below the length
    mbar_wait(sm.own_full(), own_phase);
    float s[32], dp[32];
    uint32_t pa[16], da[16];
    for (int j = 0; j < w.n_tiles; ++j) {
      const int st = (t0 + j) % C::kStages;
      const int q0 = (w.q_first + j % w.per_head) * kTile;
      mbar_wait(sm.full(st), (uint32_t)((t0 + j) / C::kStages) & 1u);
      if (live && !(CAUSAL && q0 + kTile - 1 < kw)) {
        wgmma_fence();
        issue_xyt<C, D>(s, sm.own(0), c * kWGBoxBytes, sm.tile(st, 0));   // K·Qᵀ
        issue_xyt<C, D>(dp, sm.own(1), c * kWGBoxBytes, sm.tile(st, 1));  // V·dOᵀ
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const float* stats = sm.stats(st);  // m·log2e [64], 1/l [64], delta [64]
        const bool mask = kw + kRowsWG > w.len || (CAUSAL && q0 < kw + kRowsWG - 1);
        // Pᵀ and dSᵀ, packed column group by column group
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int qc = 8 * i + 2 * t;
          const float2 m2 = *reinterpret_cast<const float2*>(stats + qc);
          const float2 li = *reinterpret_cast<const float2*>(stats + 64 + qc);
          const float2 de = *reinterpret_cast<const float2*>(stats + 128 + qc);
          float p4[4], d4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = e & 1;
            float pe = exp2_mufu(fmaf(s[4 * i + e], scale2, -(x ? m2.y : m2.x))) *
                       (x ? li.y : li.x);
            if (mask) {
              const int key = key0 + 8 * (e >> 1);
              bool ok = key < w.len;
              if (CAUSAL) ok = ok && key <= q0 + qc + x;
              if (!ok) pe = 0.f;
            }
            p4[e] = pe;
            d4[e] = pe * (dp[4 * i + e] - (x ? de.y : de.x)) * p.sm_scale;
          }
          pa[2 * i] = pack_bf16(p4[0], p4[1]);
          pa[2 * i + 1] = pack_bf16(p4[2], p4[3]);
          da[2 * i] = pack_bf16(d4[0], d4[1]);
          da[2 * i + 1] = pack_bf16(d4[2], d4[3]);
        }
        wgmma_fence();
        issue_az<D>(dv, pa, sm.tile(st, 1));  // dv += Pᵀ·dO
        issue_az<D>(dk, da, sm.tile(st, 0));  // dk += dSᵀ·Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
      }
      if (lane == 0) mbar_arrive(sm.empty(st));
    }
    if (lane == 0) mbar_arrive(sm.own_empty());
  }
  store_acc<D>(p.dk + (long long)w.b * p.dk_sb + (long long)w.hk * p.dk_sh, p.dk_ss, key0,
               p.S_kv, dk, t);
  store_acc<D>(p.dv + (long long)w.b * p.dv_sb + (long long)w.hk * p.dv_sh, p.dv_ss, key0,
               p.S_kv, dv, t);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const BwdArgs p) {
  using C = DkvCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const BSmem<C> sm{base, smem_raw + (base - raw)};
  const int n_kb = (p.S_kv + C::kBlock - 1) / C::kBlock;
  const int n_items = n_kb * p.Hkv * p.B;
  const int n_rep = p.H / p.Hkv;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(sm.full(st), 1 + 32);  // the TMA thread and the statistics warp
      mbar_init(sm.empty(st), 4 * C::kNC);
    }
    mbar_init(sm.own_full(), 1);
    mbar_init(sm.own_empty(), 4 * C::kNC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs) : "memory");
    const int pw = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      // every TMA copy: the item's K and V, then each stage's Q and dO tiles
      int n_own = 0, t = 0;
      for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
        const int item = item_of(k);
        if (item >= n_items) continue;
        const DkvWork w = dkv_work<CAUSAL, C::kBlock>(p, item, n_kb);
        if (w.n_tiles == 0) continue;
        mbar_wait(sm.own_empty(), (n_own & 1) ^ 1);
        ++n_own;
        mbar_expect_tx(sm.own_full(), 2 * C::kOwnBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          tma_load_4d(sm.own(0) + bx * C::kOwnBoxBytes, &tm_k, sm.own_full(), 64 * bx, w.k0,
                      w.hk, w.b);
          tma_load_4d(sm.own(1) + bx * C::kOwnBoxBytes, &tm_v, sm.own_full(), 64 * bx, w.k0,
                      w.hk, w.b);
        }
        for (int j = 0; j < w.n_tiles; ++j, ++t) {
          const int h = w.hk * n_rep + j / w.per_head;
          const int q0 = (w.q_first + j % w.per_head) * kTile;
          const int st = t % C::kStages;
          mbar_wait(sm.empty(st), ((t / C::kStages) & 1) ^ 1);
          mbar_expect_tx(sm.full(st), 2 * C::kTileBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx) {
            tma_load_4d(sm.tile(st, 0) + bx * kTileBoxBytes, &tm_q, sm.full(st), 64 * bx, q0, h,
                        w.b);
            tma_load_4d(sm.tile(st, 1) + bx * kTileBoxBytes, &tm_do, sm.full(st), 64 * bx, q0, h,
                        w.b);
          }
        }
      }
    } else if (pw == 1) {
      // the statistics of each stage's 64 query rows: m·log2e, 1/l, delta
      const int lane = threadIdx.x & 31;
      int t = 0;
      for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
        const int item = item_of(k);
        if (item >= n_items) continue;
        const DkvWork w = dkv_work<CAUSAL, C::kBlock>(p, item, n_kb);
        for (int j = 0; j < w.n_tiles; ++j, ++t) {
          const int h = w.hk * n_rep + j / w.per_head;
          const int q0 = (w.q_first + j % w.per_head) * kTile;
          const long long stat0 = ((long long)w.b * p.H + h) * p.S;
          const int st = t % C::kStages;
          mbar_wait(sm.empty(st), ((t / C::kStages) & 1) ^ 1);
          float* out = sm.stats(st);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = lane + 32 * half, row = q0 + r;
            float m2 = INFINITY, li = 0.f, de = 0.f;
            if (row < p.S) {
              const float l = p.l[stat0 + row];
              de = p.delta[stat0 + row];
              if (l > 0.f) {
                m2 = p.m[stat0 + row] * kLog2eF;
                li = 1.f / l;
              }
            }
            out[r] = m2;
            out[64 + r] = li;
            out[128 + r] = de;
          }
          mbar_arrive(sm.full(st));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    int n_own = 0, t = 0;
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int item = item_of(k);
      if (item >= n_items) continue;
      const DkvWork w = dkv_work<CAUSAL, C::kBlock>(p, item, n_kb);
      dkv_consumer_item<D, CAUSAL>(p, sm, wg - 1, w, n_own & 1, t);
      if (w.n_tiles > 0) ++n_own;
      t += w.n_tiles;
    }
  }
}

// ------------------------------------------------------------- host ----

// Launch one of the two kernels at head dim D: tensor maps of q and do with
// boxes of q_rows rows, of k and v with kv_rows; the persistent grid.
template <class C, class Kernel>
cudaError_t launch_bwd(Kernel kern, const void* q, const void* k, const void* v,
                       const void* dout, const BwdArgs& a, const long long* st, int D,
                       int q_rows, int kv_rows, long long n_items, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_operand(&tq, q, D, a.S, a.H, a.B, st[0], st[1], st[2], q_rows) ||
      !encode_operand(&tdo, dout, D, a.S, a.H, a.B, st[12], st[13], st[14], q_rows) ||
      !encode_operand(&tk, k, D, a.S_kv, a.Hkv, a.B, st[3], st[4], st[5], kv_rows) ||
      !encode_operand(&tv, v, D, a.S_kv, a.Hkv, a.B, st[6], st[7], st[8], kv_rows))
    return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (n_items > (1ll << 30)) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min<long long>(n_items, sms);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tdo, tk, tv, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const BwdArgs& a, const long long* st, bool causal, cudaStream_t s) {
  using C = DqCfg<D>;
  const long long n_items = (long long)((a.S + C::kBlock - 1) / C::kBlock) * a.H * a.B;
  return causal ? launch_bwd<C>(flash_bwd_dq_wgmma_kernel<D, true>, q, k, v, dout, a, st, D,
                                C::kBlock, kTile, n_items, s)
                : launch_bwd<C>(flash_bwd_dq_wgmma_kernel<D, false>, q, k, v, dout, a, st, D,
                                C::kBlock, kTile, n_items, s);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const BwdArgs& a, const long long* st, bool causal, cudaStream_t s) {
  using C = DkvCfg<D>;
  const long long n_items = (long long)((a.S_kv + C::kBlock - 1) / C::kBlock) * a.Hkv * a.B;
  return causal ? launch_bwd<C>(flash_bwd_dkv_wgmma_kernel<D, true>, q, k, v, dout, a, st, D,
                                kTile, C::kBlock, n_items, s)
                : launch_bwd<C>(flash_bwd_dkv_wgmma_kernel<D, false>, q, k, v, dout, a, st, D,
                                kTile, C::kBlock, n_items, s);
}

BwdArgs make_args(const void* o, const void* dout, const void* m, const void* l, void* delta,
                  void* dq, void* dk, void* dv, const void* lengths, int B, int H, int Hkv,
                  int S, int S_kv, const long long* st, float sm_scale) {
  BwdArgs a = {};
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lengths = static_cast<const int*>(lengths);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.S_kv = S_kv;
  a.sm_scale = sm_scale;
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.do_sb = st[12]; a.do_sh = st[13]; a.do_ss = st[14];
  a.dq_sb = st[15]; a.dq_sh = st[16]; a.dq_ss = st[17];
  a.dk_sb = st[18]; a.dk_sh = st[19]; a.dk_ss = st[20];
  a.dv_sb = st[21]; a.dv_sh = st[22]; a.dv_ss = st[23];
  return a;
}

bool bad_shape(int B, int H, int Hkv, int S, int S_kv, int D, int causal) {
  return B <= 0 || S <= 0 || S_kv <= 0 || Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) ||
         (causal && S != S_kv);
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, S_kv, D), o/dout/dq like q: bf16, head_dim
// contiguous, other axes strided with 16-byte row strides (strides: 24 int64
// on the host, the (b, h, s) strides of q, k, v, o, dout, dq, dk, dv in that
// order). m/l/delta: (B, H, S) f32, contiguous. lengths: (B,) int32 or null.
// K5: writes dq and delta. Returns the CUDA error of the launch.
extern "C" int iclk_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* m, const void* l,
                                 void* delta, void* dq, const void* lengths, int B, int H,
                                 int Hkv, int S, int S_kv, int D, int causal,
                                 const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, Hkv, S, S_kv, D, causal)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(o, dout, m, l, delta, dq, nullptr, nullptr, lengths, B, H, Hkv, S,
                              S_kv, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? launch_dq<64>(q, k, v, dout, a, strides, causal != 0, st)
                       : launch_dq<128>(q, k, v, dout, a, strides, causal != 0, st));
}

// K6: reads delta (from K5), writes dk and dv (B, Hkv, S_kv, D), strided
// like k and v. The o stride slots are unused.
extern "C" int iclk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* m, const void* l,
                                  const void* delta, void* dk, void* dv, const void* lengths,
                                  int B, int H, int Hkv, int S, int S_kv, int D, int causal,
                                  const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, Hkv, S, S_kv, D, causal)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(nullptr, dout, m, l, const_cast<void*>(delta), nullptr, dk, dv,
                              lengths, B, H, Hkv, S, S_kv, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? launch_dkv<64>(q, k, v, dout, a, strides, causal != 0, st)
                       : launch_dkv<128>(q, k, v, dout, a, strides, causal != 0, st));
}

// Dynamic shared memory of a K5 (dkv = 0) or K6 (1) block at head dim D (0
// for a D they do not take), for the build report.
extern "C" int iclk_flash_bwd_smem_bytes(int D, int dkv) {
  if (D == 64) return dkv ? DkvCfg<64>::kSmem : DqCfg<64>::kSmem;
  if (D == 128) return dkv ? DkvCfg<128>::kSmem : DqCfg<128>::kSmem;
  return 0;
}
