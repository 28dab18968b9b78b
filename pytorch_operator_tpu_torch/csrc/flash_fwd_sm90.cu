// Flash-attention forward for Hopper: bf16, fp16 or f32 (as TF32) in at
// head dim 16, 32, 64, 128 or 256, f32 accumulate, causal or not, GQA,
// either layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _fwd_kernel (pallas_call in _flash_fwd) at every dtype and D; the WMMA
// kernel flash_fwd.cu is on no route.  It computes what that kernel
// computes: per (batch, q head) o = softmax(q k^T * scale) v with an
// online softmax, and lse = m + log(l) as a natural log, reading kv head
// h / (H / Hk).
//
// Bound on the H100: tensor-core operations (at B2 T2048 H16 D128 causal,
// 34.4 GFLOP against 67 MB in bf16; in TF32 at half the rate against
// twice the bytes).  Design, FlashAttention-3 style:
//  - one CTA per (128-row q tile, q head), longest causal rows first;
//    three warpgroups.  Warp 0 of the last one is the producer: it loads
//    Q once, then streams BK-row K and V tiles through a ring of
//    STAGES slots by TMA, each slot guarded by a "full" and an "empty"
//    mbarrier.  The two consumer warpgroups own 64 q rows each;
//    setmaxnreg moves registers from the producer to them.
//  - BK = 128 keys at D 64 and 128.  At D 256 a 128-key K + V stage is
//    128 KB, and two of them beside the 64 KB Q tile pass the 227 KB a
//    block may have: BK = 64 there (64 KB a stage, 192 KB in all), and
//    on the causal walk warpgroup 0 skips the last key tile, which lies
//    wholly after its rows.  The O accumulator (64 x 256 f32, 128
//    registers a thread) takes two m64n128k16 products per k16 step of
//    P V, one per half of D.
//  - S = Q K^T by wgmma m64nBKk16 from shared memory; the online softmax
//    runs in the accumulator registers (each row's max and sum over its
//    quad of lanes, exp2 with scale * log2(e) folded in, the mask only on
//    the diagonal tiles and the ragged tail);
//  - P stays in registers: converted to E it is the A operand of
//    O += P V (V from shared memory, MN-major).  Nothing goes through a
//    shared-memory scratch.
//  - o / l is written in E and lse in f32, rows at or past T skipped;
//    TMA zero-fills the tiles past T, so the host pads nothing.
//
// At 16-bit D 32 and 16 (FwdSmem::NARROW) a row of Q, K and V is 64 or 32
// bytes: each tile is one narrow slab (sm90.cuh: TMA and the descriptors
// swizzle at the row's width; nothing is stored by hand).  The products
// are a quarter or an eighth of D 128's per score element while the
// exponential stays, so the bound is ex2, 16 a clock a multiprocessor
// (one a score element).  The narrow body is a branch of its own:
//  - S_j = Q K_j^T is issued before O += P_{j-1} V_{j-1}, each its own
//    commit group, and P_j's online softmax runs while that product is
//    in flight (FlashAttention-3's intra-warpgroup overlap); the slot of
//    tile j - 1 is released once it completes.
//  - 64-key tiles and two CTAs a multiprocessor (80 registers a thread
//    at launch; setmaxnreg gives the consumers 104): four consumer
//    warpgroups keep the exponential unit busy and one CTA's start
//    overlaps another's walk.  Timed in turns on the H100 (PERF.md §6),
//    this took 18-24 % off one CTA of 128-key tiles, which took 1-5 %
//    off the same without the overlap; four partial row maxima instead
//    of one chain gave nothing.
//
// f32 (flash_fwd_sm90_tf32_kernel) runs the same walk on TF32 wgmma
// (m64nNk8), which has no transpose bit: both shared-memory operands
// must be K-major, and V in O += P V is MN-major.  Of the two ways round
// (V^T written in shared memory, or O^T = V^T P^T with V^T loaded into
// A fragments by plain loads and P stored to shared memory), the kernel
// writes V^T: one pass a tile, shared by both consumer warpgroups, where
// the other way would have each warpgroup load all of V into registers
// and spill P through shared memory every tile.  The producer warpgroup's
// warps 1-3 write it into a V^T buffer with its own
// full / empty mbarriers, while warp 0 keeps the TMA ring going.  Its
// keys go in the order [0, 2, 4, 6, 1, 3, 5, 7] of each 8: the k8 A
// fragment a thread gives wgmma holds columns (t, t + 4) of each 8, its
// S accumulator columns (2t, 2t + 1), so P's registers, rounded to TF32
// (cvt.rna), are the A operand as they are once the B rows come in that
// order.  TMA rounds Q, K and V to TF32 as it loads them (a TFLOAT32
// tensor map, sm90.cuh make_map), as the WMMA kernel rounds its
// operands.  Shared memory doubles at f32, so
// the tiles shrink per D (within 227 KB):
//  - D 64: 128-row Q (32 KB), 128-key K + V stages (2 x 64 KB), two
//    V^T buffers (2 x 32 KB);
//  - D 128: 128-row Q (64 KB), 64-key stages (2 x 64 KB), one V^T (32
//    KB);
//  - D 256: 64-row Q (64 KB), 32-key stages (2 x 64 KB), one V^T (32
//    KB); both consumer warpgroups form S for the same 64 rows and each
//    owns half of D's columns of O (64 registers);
//  - D 32 and 16 (FwdTf32Smem::NARROW): a row of Q, K or V is 128 or 64
//    bytes, one slab a tile (at D 16 swizzled at 64 bytes and read by
//    descriptors of desc_hi(64), as the f32 walk reads it; a k8 step
//    moves 32 bytes along the row), and the exponentials and the TF32
//    products set the bound together: 128-row Q (16 KB at D 32), 64-key
//    stages (4 x 16 KB), two V^T buffers (2 x 8 KB; the D 16 transpose
//    reads the narrow slab), O m64nDk8, and two CTAs a multiprocessor
//    (97 KB each; 80 registers a thread at launch, 48 for the producer
//    and 96 for the consumers by setmaxnreg), whose four consumer
//    warpgroups keep the exponential unit busy while one waits on its
//    products.  They run the same tile body as D 64-256, each tile's S,
//    softmax and O += P V in turn.  The 16-bit narrow body's overlap
//    (S_{j+1} issued before P_j's product) holds P_j's TF32 fragments,
//    one register a value, beside S_{j+1}'s accumulator, and spilled at
//    96 registers (152 bytes at D 32): timed in turns on the H100
//    (PERF.md §6) it took 0.32 / 0.47 ms at D 32 / 16, and 0.30 / 0.52
//    at one CTA a multiprocessor, against 0.22 / 0.36 for this design.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt::sm90;

constexpr int BQ = 128, SLAB = 128;  // rows; bytes per slab row
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D> struct FwdSmem {
  // NARROW (16-bit D 16 / 32): one slab of 2 D-byte rows, 64-key tiles,
  // SM_CTAS blocks a multiprocessor (see the header)
  static constexpr bool NARROW = D < 64;
  static constexpr int SM_CTAS = NARROW ? 2 : 1;
  static constexpr int RB = NARROW ? 2 * D : SLAB;  // bytes a slab row
  static constexpr int SLABS = NARROW ? 1 : D / 64;
  static constexpr int BK = D == 256 || NARROW ? 64 : 128;  // key rows a tile
  static constexpr int STAGES = D <= 64 ? 4 : 2;
  static constexpr int Q_SLAB = BQ * RB, KV_SLAB = BK * RB;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  static constexpr int Q = 0;
  static constexpr int K = Q + SLABS * Q_SLAB;  // slot s at K + s * KV_TILE
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;
  // q_full, kv_full[STAGES], kv_empty[STAGES]; 1024 bytes of slack to
  // align the dynamic shared memory to the swizzle's 1024-byte period
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Columns [64 N i, 64 N (i + 1)) of a 64 x D accumulator (d[32 N i ..]),
// as the accumulator of a 64 x 64 N product.
template <int N, int M>
__device__ __forceinline__ float (&part(float (&d)[M], int i))[N] {
  return *reinterpret_cast<float(*)[N]>(d + N * i);
}

// ---- the NARROW tile body's pieces (16-bit D 16 / 32, see the header)

// sc (64 q, BK keys) = Q_wg K^T, both K-major narrow slabs: a k16 step
// moves 32 bytes along the 2 D-byte row.
template <typename E, int D, int BK>
__device__ __forceinline__ void narrow_scores(float (&sc)[BK / 2],
                                              uint32_t q_addr,
                                              uint32_t k_addr) {
  constexpr uint32_t HI = desc_hi(2 * D);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<E, 0, 0, HI>(sc, desc_k(q_addr + 32 * kk),
                        desc_k(k_addr + 32 * kk), kk > 0);
}

// acc (64 q, D) += P V: P as E A fragments, V (BK keys, D) MN-major, one
// narrow N block; a k16 step moves 16 rows.
template <typename E, int D, int BK>
__device__ __forceinline__ void narrow_pv(float (&acc)[D / 2],
                                          const uint32_t (&pa)[BK / 4],
                                          uint32_t v_addr) {
  constexpr uint32_t HI = desc_hi(2 * D);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_rs<E, 1, HI>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3], desc(v_addr + kk * 16 * 2 * D,
                                          BK * 2 * D), 1);
}

// The online softmax of one score tile in its accumulator registers, as
// the D >= 64 body does it inline: keys past T, and on the causal
// diagonal keys after the row, masked where `mask`; the running max m
// (scaled, log2 units) and the thread's part of the sum l of its two
// rows moved on, alpha = exp2(m_old - m_new) returned for O, and sc
// replaced by P = exp2(sc scale log2 e - m_new) in f32.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool mask,
                                             int k0, int row_a, int col,
                                             int T, int causal, float sl2) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + col + (i % 2);
      const int row = row_a + 8 * ((i / 2) % 2);
      if (key >= T || (causal && key > row)) sc[i] = ptt::NEG_INF;
    }
  }
  float mx[2] = {ptt::NEG_INF, ptt::NEG_INF}, neg_m[2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], sl2, neg_m[r]));
    l[r] += sc[i];
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS, FwdSmem<D>::SM_CTAS)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      E* __restrict__ o, float* __restrict__ lse, int H,
                      int Hk, int T, int bh_layout, float scale,
                      int causal) {
  using S = FwdSmem<D>;
  constexpr int STAGES = S::STAGES, SLABS = S::SLABS, BK = S::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - ptt::grid_tile(n_qt);  // longest causal rows first
  const int bh = ptt::grid_bh(n_qt);
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = qt * BQ;
  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (qt + 1) * (BQ / BK));

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&mq);
      prefetch_map(&mk);
      prefetch_map(&mv);
      const int2 cq = head_coords(b, h, H, bh_layout);
      const int2 ck = head_coords(b, hk, Hk, bh_layout);
      mbar_expect_tx(q_full, SLABS * S::Q_SLAB);
      for (int r = 0; r < SLABS; ++r)
        tma_load_4d(smem + S::Q + r * S::Q_SLAB, &mq, q_full, 64 * r, cq.x,
                    q0, cq.y);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        mbar_wait(&kv_empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * S::KV_TILE);
        for (int r = 0; r < SLABS; ++r) {
          tma_load_4d(smem + S::K + s * S::KV_TILE + r * S::KV_SLAB, &mk,
                      &kv_full[s], 64 * r, ck.x, j * BK, ck.y);
          tma_load_4d(smem + S::V + s * S::KV_TILE + r * S::KV_SLAB, &mv,
                      &kv_full[s], 64 * r, ck.x, j * BK, ck.y);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
  // (NARROW: two CTAs share the register file, 80 registers a thread at
  // launch; 128 x 24 + 256 x 104 of them)
  if constexpr (S::NARROW)
    setmaxnreg_inc<104>();
  else
    setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row_a = q0 + 64 * wg + 16 * warp + lane / 4;  // row_b = +8
  const int col = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (scaled, log2 units) and this thread's part of the sum
  float m[2] = {ptt::NEG_INF, ptt::NEG_INF}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_u32(smem + S::Q) + 64 * wg * SLAB;
  // the key tiles this warpgroup reads: with BK < BQ, on the causal walk
  // warpgroup 0's rows end before the last tile starts
  int n_kt_wg = n_kt;
  if constexpr (BK < BQ)
    if (causal) n_kt_wg = min(n_kt, (q0 + 64 * wg + 64 + BK - 1) / BK);
  mbar_wait(q_full, 0);

  if constexpr (S::NARROW) {
    // S_j is issued before O += P_{j-1} V_{j-1}, and P_j's exponentials
    // run while that product is in flight (see the header)
    const uint32_t qn_addr = smem_u32(smem + S::Q) + 64 * wg * S::RB;
    const uint32_t k_base = smem_u32(smem + S::K);
    const uint32_t v_base = smem_u32(smem + S::V);
    // keys past T, or on the diagonal tiles (the last BQ / BK of the
    // causal walk)
    auto masked = [&](int j) {
      return (causal && j >= n_kt - BQ / BK) || (j + 1) * BK > T;
    };
    float sc[BK / 2], alpha[2];
    uint32_t pa[BK / 4];
    mbar_wait(&kv_full[0], 0);
    wgmma_fence();
    narrow_scores<E, D, BK>(sc, qn_addr, k_base);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<BK>(sc, m, l, alpha, masked(0), 0, row_a, col, T, causal,
                     sl2);
#pragma unroll
    for (int t = 0; t < BK / 4; ++t)
      pa[t] = pack<E>(sc[2 * t], sc[2 * t + 1]);
    for (int j = 1; j < n_kt_wg; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(&kv_full[s], (j / STAGES) & 1);
      wgmma_fence();
      narrow_scores<E, D, BK>(sc, qn_addr, k_base + s * S::KV_TILE);
      wgmma_commit();
      narrow_pv<E, D, BK>(acc, pa, v_base + sp * S::KV_TILE);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile<BK>(sc, m, l, alpha, masked(j), j * BK, row_a, col, T,
                       causal, sl2);
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&kv_empty[sp]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
      for (int t = 0; t < BK / 4; ++t)
        pa[t] = pack<E>(sc[2 * t], sc[2 * t + 1]);
    }
    const int sl = (n_kt_wg - 1) % STAGES;
    wgmma_fence();
    narrow_pv<E, D, BK>(acc, pa, v_base + sl * S::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&kv_empty[sl]);
  } else {
    for (int j = 0; j < n_kt_wg; ++j) {
      const int s = j % STAGES;
      mbar_wait(&kv_full[s], (j / STAGES) & 1);
      const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV_TILE);

      // S = Q K^T: (64, BK) f32
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
        mma_ss<E, 0, 0>(sc, desc_k(q_addr + off), desc_k(k_addr + koff),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask: keys past T, and keys after the row on the diagonal tiles
      // (the last BQ / BK of the causal walk)
      if ((causal && (BK == BQ ? j == n_kt - 1 : j >= n_kt - BQ / BK)) ||
          (j + 1) * BK > T) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = j * BK + 8 * (i / 4) + col + (i % 2);
          const int row = row_a + 8 * ((i / 2) % 2);
          if (key >= T || (causal && key > row)) sc[i] = ptt::NEG_INF;
        }
      }

      // online softmax over the two rows this thread holds a quarter of
      float mx[2] = {ptt::NEG_INF, ptt::NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sl2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        neg_m[r] = -m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = ex2(fmaf(sc[i], sl2, neg_m[r]));
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P V: P as E A fragments, V (BK keys, D) MN-major; at D 256
      // one product per half of D (two slabs, LBO = a slab)
      uint32_t pa[BK / 4];
#pragma unroll
      for (int t = 0; t < BK / 4; ++t)
        pa[t] = pack<E>(sc[2 * t], sc[2 * t + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D == 256) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_rs<E, 1>(part<64>(acc, n), pa[4 * kk], pa[4 * kk + 1],
                         pa[4 * kk + 2], pa[4 * kk + 3],
                         desc(v_addr + 2 * n * S::KV_SLAB + kk * 16 * SLAB,
                              S::KV_SLAB), 1);
        } else {
          mma_rs<E, 1>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3],
                       desc(v_addr + kk * 16 * SLAB, S::KV_SLAB), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&kv_empty[s]);
    }
  }

  // epilogue: o / l in E, lse = (m + log2 l) ln 2
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= T) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    E* orow = o + q_base + (int64_t)row * q_rs + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack<E>(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[(int64_t)bh * T + row] = (m[r] + __log2f(l_safe)) * LN2;
  }
}

// ---- f32: TF32 wgmma (see the header) ----

template <int D> struct FwdTf32Smem {
  // NARROW (D 16 / 32): 128-row Q and 64-key K and V tiles, each one slab
  // of 4 D-byte rows (swizzled at 64 bytes at D 16), four stages, two
  // V^T buffers, SM_CTAS blocks a multiprocessor (see the header)
  static constexpr bool NARROW = D < 64;
  static constexpr int SM_CTAS = NARROW ? 2 : 1;
  // D 256: both consumer warpgroups own the same 64 q rows, each half of
  // D's columns of O (a 128-row Q tile alone would take 128 KB)
  static constexpr bool SPLIT = D == 256;
  static constexpr int BQ = SPLIT ? 64 : 128;
  static constexpr int BK = D == 64 ? 128 : D == 128 || NARROW ? 64 : 32;
  static constexpr int STAGES = NARROW ? 4 : 2;
  static constexpr int VT_STAGES = D == 64 || NARROW ? 2 : 1;
  static constexpr int DW = SPLIT ? D / 2 : D;  // O columns a warpgroup
  static constexpr int RB = NARROW ? 4 * D : SLAB;  // bytes a slab row
  static constexpr int SLABS = NARROW ? 1 : D / 32;  // 32 f32 columns a slab
  static constexpr int Q_SLAB = BQ * RB, KV_SLAB = BK * RB;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  // V^T: D rows (of 128 bytes: 32 keys), BK / 32 slabs
  static constexpr int VT_SLAB = D * SLAB, VT_TILE = (BK / 32) * VT_SLAB;
  static constexpr int Q = 0;
  static constexpr int K = Q + SLABS * Q_SLAB;  // slot s at K + s * KV_TILE
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int VT = V + STAGES * KV_TILE;
  static constexpr int BAR = VT + VT_STAGES * VT_TILE;
  // q_full, kv_full[STAGES], kv_empty[STAGES], vt_full[VT_STAGES],
  // vt_empty[VT_STAGES]
  static constexpr int BYTES =
      BAR + 8 * (1 + 2 * STAGES + 2 * VT_STAGES) + 1024;
  static_assert(BYTES * SM_CTAS <= 232448,
                "a multiprocessor has 227 KB of shared memory");
};

// The narrow (f32 D 16 / 32) registers a thread of each warpgroup holds at
// two CTAs a multiprocessor: 128 x 48 + 256 x 96 = 30,720, the block's
// 384 x 80 at launch (sm90.cuh: the transposer spilled at 40).
constexpr int TF32_NARROW_PRODUCER_REGS = 48, TF32_NARROW_CONSUMER_REGS = 96;

template <int D>
__global__ void __launch_bounds__(THREADS, FwdTf32Smem<D>::SM_CTAS)
flash_fwd_sm90_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           float* __restrict__ o, float* __restrict__ lse,
                           int H, int Hk, int T, int bh_layout, float scale,
                           int causal) {
  using S = FwdTf32Smem<D>;
  constexpr int STAGES = S::STAGES, VS = S::VT_STAGES, SLABS = S::SLABS;
  constexpr int BQ = S::BQ, BK = S::BK, DW = S::DW;
  constexpr bool SPLIT = S::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;
  uint64_t* vt_full = kv_empty + STAGES;
  uint64_t* vt_empty = vt_full + VS;

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - ptt::grid_tile(n_qt);  // longest causal rows first
  const int bh = ptt::grid_bh(n_qt);
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = qt * BQ;
  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (qt + 1) * (BQ / BK));

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&vt_full[s], TF32_TRANSPOSERS);
      mbar_init(&vt_empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: thread 256 issues the TMA loads; warps 1-3 write
    // each V tile's transpose V^T, keys in the A fragments' order ----
    if constexpr (S::SM_CTAS == 2)
      setmaxnreg_dec<TF32_NARROW_PRODUCER_REGS>();
    else
      setmaxnreg_dec<TF32_PRODUCER_REGS>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      prefetch_map(&mq);
      prefetch_map(&mk);
      prefetch_map(&mv);
      const int2 cq = head_coords(b, h, H, bh_layout);
      const int2 ck = head_coords(b, hk, Hk, bh_layout);
      mbar_expect_tx(q_full, SLABS * S::Q_SLAB);
      for (int r = 0; r < SLABS; ++r)
        tma_load_4d(smem + S::Q + r * S::Q_SLAB, &mq, q_full, 32 * r, cq.x,
                    q0, cq.y);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        mbar_wait(&kv_empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * S::KV_TILE);
        for (int r = 0; r < SLABS; ++r) {
          tma_load_4d(smem + S::K + s * S::KV_TILE + r * S::KV_SLAB, &mk,
                      &kv_full[s], 32 * r, ck.x, j * BK, ck.y);
          tma_load_4d(smem + S::V + s * S::KV_TILE + r * S::KV_SLAB, &mv,
                      &kv_full[s], 32 * r, ck.x, j * BK, ck.y);
        }
      }
    } else if (pt >= 32) {
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES, vs = j % VS;
        mbar_wait(&kv_full[s], (j / STAGES) & 1);
        mbar_wait(&vt_empty[vs], ((j / VS) & 1) ^ 1);
        transpose_tf32<BK, D, true, TF32_TRANSPOSERS / 32>(
            smem + S::V + s * S::KV_TILE, smem + S::VT + vs * S::VT_TILE,
            pt / 32 - 1, pt % 32);
        fence_proxy_async();
        mbar_arrive(&vt_full[vs]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
  // and all of D, or (SPLIT) rows [q0, q0 + 64) and columns [DW wg, DW wg
  // + DW) of O
  if constexpr (S::SM_CTAS == 2)
    setmaxnreg_inc<TF32_NARROW_CONSUMER_REGS>();
  else
    setmaxnreg_inc<TF32_CONSUMER_REGS>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rw = SPLIT ? 0 : 64 * wg;  // this warpgroup's first q row
  const int row_a = q0 + rw + 16 * warp + lane / 4;  // row_b = +8
  const int col = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;

  float acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;
  float m[2] = {ptt::NEG_INF, ptt::NEG_INF}, l[2] = {0.f, 0.f};

  // Q and K slabs of RB-byte rows: DESC_HI's 128, or NARROW's 64 at D 16
  constexpr uint32_t HI = desc_hi(S::RB);
  const uint32_t q_addr = smem_u32(smem + S::Q) + rw * S::RB;
  int n_kt_wg = n_kt;
  if constexpr (!SPLIT && BK < BQ)
    if (causal) n_kt_wg = min(n_kt, (q0 + rw + 64 + BK - 1) / BK);
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kt_wg; ++j) {
    const int s = j % STAGES, vs = j % VS;
    mbar_wait(&kv_full[s], (j / STAGES) & 1);
    const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV_TILE);

    // S = Q K^T: (64, BK) f32, m64nBKk8 from shared memory
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t off = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
      mma_ss_tf32<HI>(sc, desc_k(q_addr + off), desc_k(k_addr + koff),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if ((causal && (BK == BQ ? j == n_kt - 1 : j >= n_kt - BQ / BK)) ||
        (j + 1) * BK > T) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = j * BK + 8 * (i / 4) + col + (i % 2);
        const int row = row_a + 8 * ((i / 2) % 2);
        if (key >= T || (causal && key > row)) sc[i] = ptt::NEG_INF;
      }
    }

    float mx[2] = {ptt::NEG_INF, ptt::NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = ex2(fmaf(sc[i], sl2, neg_m[r]));
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += P V as (P in A fragments) (V^T, K-major): P rounded to TF32,
    // each k8 block's columns in the order V^T's keys are written in
    uint32_t pa[BK / 2];
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      pa[4 * t] = tf32(sc[4 * t]);
      pa[4 * t + 1] = tf32(sc[4 * t + 2]);
      pa[4 * t + 2] = tf32(sc[4 * t + 1]);
      pa[4 * t + 3] = tf32(sc[4 * t + 3]);
    }
    mbar_wait(&vt_full[vs], (j / VS) & 1);
    const uint32_t vt_addr = smem_u32(smem + S::VT + vs * S::VT_TILE) +
                             (SPLIT ? DW * wg * SLAB : 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      mma_rs_tf32(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                  pa[4 * kk + 3],
                  desc_k(vt_addr + (kk / 4) * S::VT_SLAB + (kk % 4) * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) {
      mbar_arrive(&kv_empty[s]);
      mbar_arrive(&vt_empty[vs]);
    }
  }

  // epilogue: o / l in f32, lse = (m + log2 l) ln 2
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= T) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    float* orow = o + q_base + (int64_t)row * q_rs + (SPLIT ? DW * wg : 0) +
                  col;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    if (lane % 4 == 0 && (!SPLIT || wg == 0))
      lse[(int64_t)bh * T + row] = (m[r] + __log2f(l_safe)) * LN2;
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hk, int T, int bh_layout,
                float scale, int causal, cudaStream_t stream) {
  using S = FwdTf32Smem<D>;
  CUtensorMap mq, mk, mv;
  int e = make_head_map<float>(&mq, q, D, H, T, B, bh_layout, S::BQ, S::RB);
  if (!e)
    e = make_head_map<float>(&mk, k, D, Hk, T, B, bh_layout, S::BK, S::RB);
  if (!e)
    e = make_head_map<float>(&mv, v, D, Hk, T, B, bh_layout, S::BK, S::RB);
  if (e) return e;
  const int tiles = (T + S::BQ - 1) / S::BQ;
  if (!ptt::grid_fits(tiles, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_fwd_sm90_tf32_kernel<D>, S::BYTES);
  if (e) return e;
  flash_fwd_sm90_tf32_kernel<D><<<tiles * B * H, THREADS, S::BYTES, stream>>>(
      mq, mk, mv, static_cast<float*>(o), lse, H, Hk, T, bh_layout, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hk, int T, int bh_layout, float scale,
           int causal, cudaStream_t stream) {
  constexpr int BK = FwdSmem<D>::BK, RB = FwdSmem<D>::RB;
  CUtensorMap mq, mk, mv;
  int e = make_head_map<E>(&mq, q, D, H, T, B, bh_layout, BQ, RB);
  if (!e) e = make_head_map<E>(&mk, k, D, Hk, T, B, bh_layout, BK, RB);
  if (!e) e = make_head_map<E>(&mv, v, D, Hk, T, B, bh_layout, BK, RB);
  if (e) return e;
  const int bytes = FwdSmem<D>::BYTES, tiles = (T + BQ - 1) / BQ;
  if (!ptt::grid_fits(tiles, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_fwd_sm90_kernel<E, D>, bytes);
  if (e) return e;
  flash_fwd_sm90_kernel<E, D><<<tiles * B * H, THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<E*>(o), lse, H, Hk, T, bh_layout, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dim_tf32(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int Hk, int T, int D,
                    int bh_layout, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tf32<16>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
    case 32: return launch_tf32<32>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
    case 64: return launch_tf32<64>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
    case 128: return launch_tf32<128>(q, k, v, o, lse, B, H, Hk, T,
                                      bh_layout, scale, causal, s);
    case 256: return launch_tf32<256>(q, k, v, o, lse, B, H, Hk, T,
                                      bh_layout, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int launch_dim(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hk, int T, int D, int bh_layout,
               float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<E, 16>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                  scale, causal, s);
    case 32: return launch<E, 32>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                  scale, causal, s);
    case 64: return launch<E, 64>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                  scale, causal, s);
    case 128: return launch<E, 128>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
    case 256: return launch<E, 256>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int ctas_dim_tf32(int D, int* ctas) {
  switch (D) {
    case 16: return ctas_per_sm(flash_fwd_sm90_tf32_kernel<16>, THREADS,
                                FwdTf32Smem<16>::BYTES, ctas);
    case 32: return ctas_per_sm(flash_fwd_sm90_tf32_kernel<32>, THREADS,
                                FwdTf32Smem<32>::BYTES, ctas);
    case 64: return ctas_per_sm(flash_fwd_sm90_tf32_kernel<64>, THREADS,
                                FwdTf32Smem<64>::BYTES, ctas);
    case 128: return ctas_per_sm(flash_fwd_sm90_tf32_kernel<128>, THREADS,
                                 FwdTf32Smem<128>::BYTES, ctas);
    case 256: return ctas_per_sm(flash_fwd_sm90_tf32_kernel<256>, THREADS,
                                 FwdTf32Smem<256>::BYTES, ctas);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int ctas_dim(int D, int* ctas) {
  switch (D) {
    case 16: return ctas_per_sm(flash_fwd_sm90_kernel<E, 16>, THREADS,
                                FwdSmem<16>::BYTES, ctas);
    case 32: return ctas_per_sm(flash_fwd_sm90_kernel<E, 32>, THREADS,
                                FwdSmem<32>::BYTES, ctas);
    case 64: return ctas_per_sm(flash_fwd_sm90_kernel<E, 64>, THREADS,
                                FwdSmem<64>::BYTES, ctas);
    case 128: return ctas_per_sm(flash_fwd_sm90_kernel<E, 128>, THREADS,
                                 FwdSmem<128>::BYTES, ctas);
    case 256: return ctas_per_sm(flash_fwd_sm90_kernel<E, 256>, THREADS,
                                 FwdSmem<256>::BYTES, ctas);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// CTAs a multiprocessor holds of the f32 (dtype 0), bf16 (dtype 1) or
// fp16 (dtype 2) kernel at D (chip_smoke.py phase 1 records them).
extern "C" int flash_fwd_sm90_ctas_per_sm(int D, int dtype, int* ctas) {
  if (dtype == ptt::F32) return ctas_dim_tf32(D, ctas);
  if (dtype == ptt::BF16) return ctas_dim<__nv_bfloat16>(D, ctas);
  if (dtype == ptt::F16) return ctas_dim<__half>(D, ctas);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_fwd (flash_fwd.cu) for f32 (dtype 0), bf16 (dtype 1) and fp16
// (dtype 2) at D in {16, 32, 64, 128, 256}; any other dtype or head dim is
// cudaErrorInvalidValue.  q, k, v, o 16-byte aligned.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int Hk,
                              int T, int D, int bh_layout, float scale,
                              int causal, int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::F32)
    return launch_dim_tf32(q, k, v, o, lse, B, H, Hk, T, D, bh_layout, scale,
                           causal, s);
  if (dtype == ptt::BF16)
    return launch_dim<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, T, D,
                                     bh_layout, scale, causal, s);
  if (dtype == ptt::F16)
    return launch_dim<__half>(q, k, v, o, lse, B, H, Hk, T, D, bh_layout,
                              scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
