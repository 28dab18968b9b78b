// dq kernel of the two-kernel flash-attention backward for Hopper: bf16,
// fp16 or f32 (as TF32) in at head dim 64, 128 or 256, f32 accumulate, dq
// in the inputs' type, causal or not, GQA, either layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (the first pallas_call of _flash_bwd) at D in {64, 128,
// 256} for every dtype; the WMMA kernel flash_bwd_dq.cu keeps D 16/32.
// Per (q tile, q head) it recomputes, for each key tile up to the
// diagonal,
//   S = Q K^T,  P = exp(S scale - lse),  dP = dO V^T,
//   dS = P (dP - delta) scale,
// and accumulates dq = sum_j dS K_j: three products per tile.  P stays in
// f32 until dS is formed, as in the JAX kernel; dS is rounded to the
// input type (TF32 for f32) for its product.
//
// Deterministic: each dq element is summed in one thread's accumulator in
// a fixed order (key tile by key tile) and written once.  There are no
// atomics, so dq is bit-identical from run to run.
//
// Bound on the H100: tensor-core operations.  At B1 T16384 H16 D128
// causal the three products are 6 * B*H * T(T+1)/2 * D = 1.65 TFLOP,
// about 1.67 ms at 989 TFLOP/s bf16, against about 0.14 GB of q/k/v/dO,
// lse, delta and dq (0.04 ms at 3.35 TB/s).  Design, the forward's
// (flash_fwd_sm90.cu):
//  - one CTA per (128-row q tile, q head), longest causal rows first;
//    three warpgroups.  Warp 0 of the last one is the producer: it loads
//    Q and dO once, then streams 64-row K and V tiles of kv head
//    h / (H / Hk) through a ring of STAGES slots by TMA, each slot guarded
//    by a "full" and an "empty" mbarrier.  The two consumer warpgroups
//    own 64 q rows each and hold lse (times log2 e) and delta of their
//    rows in registers; setmaxnreg moves registers from the producer to
//    them.
//  - per key tile each consumer issues S = Q_wg K^T and dP = dO_wg V^T
//    (m64n64k16, shared memory, K-major) back to back and waits once,
//    forms P = exp2(S scale log2 e - lse log2 e) and dS in the
//    accumulator registers (the mask only on the two diagonal tiles and
//    the ragged tail), and packs dS to E pairs: the register A operand
//    of dq += dS K, with K read MN-major from the same ring slot.
//  - dq (64 x D f32 per warpgroup) stays in wgmma accumulator registers
//    for the whole walk: at D = 128 the peak is dq 64 + S 32 + dP 32 f32
//    a thread, within the 240 registers setmaxnreg gives.  It is written
//    once in E, rows at or past T skipped; TMA zero-fills the tiles past
//    T, so the host pads nothing.
//  - D 256 (DqSmem::SPLIT): a 128-row Q and dO would take 128 KB and dq
//    over 256 columns 128 f32 a thread beside S and dP.  So 64-row q tiles:
//    both consumer warpgroups form all of S and dP for those 64 rows
//    (the two products repeated) and each owns 128 columns of dq (64 + 32
//    + 32 f32 a thread), dq += dS K[:, its columns] as one m64n128k16
//    product a k step; Q 32 KB + dO 32 KB + two stages of K and V 128 KB.
//  - f32 (flash_bwd_dq_sm90_tf32_kernel<D>) multiplies in TF32, whose
//    wgmma takes both shared-memory operands K-major.  S = Q K^T and dP =
//    dO V^T are K-major already; dq += dS K takes K^T (D rows of the
//    tile's keys), written for each ring slot by the producer
//    warpgroup's warps 1-3 into KT_STAGES buffers, keys in the order [0,
//    2, 4, 6, 1, 3, 5, 7] of each 8 so that dS's accumulator registers,
//    rounded (cvt.rna), are the k8 A fragments as they are (sm90.cuh
//    transpose_tf32).  TMA rounds Q, K, V and dO to TF32 as it loads them
//    (sm90.cuh make_map).  128-row Q and dO take 128 KB at D 128, so the
//    key tiles are 32 rows there (64 at D 64), two stages, two K^T
//    buffers (225 KB at D 128).
//  - f32 at D 256 (DqTf32Smem::CLUSTER): 128-row Q and dO take 256 KB;
//    64-row ones 128 KB, beside 128 KB of two 32-key K and V stages and 64
//    of K^T.  So a cluster of two CTAs takes each (64-row q tile, q head)
//    (sm90.cuh launch_clusters, the cluster rank the grid's fastest index),
//    CTA r owning columns [128 r, 128 r + 128) of Q, dO, K, V and dq (TMA
//    loads only those): the D 128 design over half of D, on the same key
//    tiles.  Only S and dP sum over D.  Per 32-key tile warpgroup 0 forms
//    the CTA's partial S and warpgroup 1 its partial dP (64 x 32 f32 each),
//    each sends its partial into the peer's shared memory (send_partial:
//    st.async, whose bytes complete the peer's x_full mbarrier) and hands it
//    to the other warpgroup through LX (one named barrier a tile), and both
//    add the peer's two (own + peer in one CTA is peer + own in the other,
//    so both CTAs and both warpgroups hold the same bits of P and dS) before
//    every consumer warp arrives on the peer's x_empty: the f32 walk's
//    exchange (flash_bwd_sm90.cuh).  Forming both products in both
//    warpgroups instead, as at 16-bit D 256, gave the same bits more slowly
//    on the H100 (PERF.md).  Each warpgroup then owns 64 of the CTA's dq columns:
//    dq += dS K as m64n64k8 from its 64 rows of the CTA's K^T.  Q 32 KB +
//    dO 32 + K and V 64 + K^T 32 + the peer's partials 16 + LX 32: 209 KB
//    a CTA.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt::sm90;

constexpr int SLAB = 128;  // bytes per slab row
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

// A consumer thread's 16 f32 of a partial score tile into (put_partial)
// or out of (get_partial) this CTA's shared memory, laid out as
// sm90.cuh send_partial lays them out in the peer's.
__device__ __forceinline__ void put_partial(const float (&a)[16],
                                            unsigned char* dst, int tid) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    *reinterpret_cast<float4*>(dst + (128 * m + tid) * 16) =
        make_float4(a[4 * m], a[4 * m + 1], a[4 * m + 2], a[4 * m + 3]);
}

__device__ __forceinline__ void get_partial(float (&a)[16],
                                            const unsigned char* src,
                                            int tid) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 p =
        *reinterpret_cast<const float4*>(src + (128 * m + tid) * 16);
    a[4 * m] = p.x;
    a[4 * m + 1] = p.y;
    a[4 * m + 2] = p.z;
    a[4 * m + 3] = p.w;
  }
}

// The 16-bit kernel's tiles by head dim (see the header): 128 q rows, 64
// a consumer warpgroup, and four stages of 64 keys; at D 256 (SPLIT) 64
// q rows for both warpgroups, each owning DW = 128 columns of dq, and two
// stages.
template <int D> struct DqSmem {
  static constexpr bool SPLIT = D == 256;
  static constexpr int BQ = SPLIT ? 64 : 128, BK = 64;
  static constexpr int STAGES = SPLIT ? 2 : 4;
  static constexpr int DW = SPLIT ? D / 2 : D;  // dq columns a warpgroup
  static constexpr int SLABS = D / 64;
  static constexpr int Q_SLAB = BQ * SLAB, KV_SLAB = BK * SLAB;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  static constexpr int Q = 0;
  static constexpr int DO = Q + SLABS * Q_SLAB;
  static constexpr int K = DO + SLABS * Q_SLAB;  // slot s at K + s * KV_TILE
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;
  // q_full, kv_full[STAGES], kv_empty[STAGES]; 1024 bytes of slack to
  // align the dynamic shared memory to the swizzle's 1024-byte period
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

template <typename E, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         E* __restrict__ dq, int H, int Hk, int T,
                         int bh_layout, float scale, int causal) {
  using S = DqSmem<D>;
  constexpr int SLABS = S::SLABS, BQ = S::BQ, BK = S::BK;
  constexpr int STAGES = S::STAGES, DW = S::DW;
  constexpr bool SPLIT = S::SPLIT;
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
  if (causal) n_kt = min(n_kt, (q0 + BQ) / BK);

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
      prefetch_map(&mk);
      prefetch_map(&mv);
      const int2 cq = head_coords(b, h, H, bh_layout);
      const int2 ck = head_coords(b, hk, Hk, bh_layout);
      mbar_expect_tx(q_full, 2 * SLABS * S::Q_SLAB);
      for (int r = 0; r < SLABS; ++r) {
        tma_load_4d(smem + S::Q + r * S::Q_SLAB, &mq, q_full, 64 * r, cq.x,
                    q0, cq.y);
        tma_load_4d(smem + S::DO + r * S::Q_SLAB, &mdo, q_full, 64 * r,
                    cq.x, q0, cq.y);
      }
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

  // ---- consumers: warpgroup wg owns q rows [q0w, q0w + 64) and dq's
  // columns [cw, cw + DW) (SPLIT: both the same rows, half of D each)
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rw = SPLIT ? 0 : 64 * wg, cw = SPLIT ? DW * wg : 0;
  const int q0w = q0 + rw;
  const int row_a = q0w + 16 * warp + lane / 4;  // row_b = +8
  const int col = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;

  // lse (times log2 e) and delta of the two rows this thread holds
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool in = row < T;
    lse2[r] = in ? lse[(int64_t)bh * T + row] * LOG2E : 0.f;
    dl[r] = in ? delta[(int64_t)bh * T + row] : 0.f;
  }

  float acc[DW / 2];  // dq
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;

  const uint32_t q_addr = smem_u32(smem + S::Q) + rw * SLAB;
  const uint32_t do_addr = smem_u32(smem + S::DO) + rw * SLAB;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    mbar_wait(&kv_full[s], (j / STAGES) & 1);
    // nothing to add where every key is after every row of this
    // warpgroup (warpgroup 0 on the causal walk's last tile) or every row
    // is past T; the slot is still released below
    if (!((causal && k0 > q0w + 63) || q0w >= T)) {
      const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV_TILE);

      // S = Q_wg K^T and dP = dO_wg V^T: (64 q, 64 keys) f32 each
      float st[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
        mma_ss<E, 0, 0>(st, desc_k(q_addr + qoff), desc_k(k_addr + koff),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
        mma_ss<E, 0, 0>(dp, desc_k(do_addr + qoff), desc_k(v_addr + koff),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dp);

      // dS = P (dP - delta) scale with P in f32, masked past T and, on
      // the diagonal tiles, after the row; E pairs: the A fragments
      const bool mask = (causal && k0 + BK - 1 > q0w) || k0 + BK > T;
      uint32_t da[BK / 4];
#pragma unroll
      for (int t = 0; t < BK / 4; ++t) {
        const int e = 2 * t, r = t % 2;  // columns c and c + 1 of row r
        const int key = k0 + 8 * (t / 2) + col;
        float p0 = ex2(fmaf(st[e], sl2, -lse2[r]));
        float p1 = ex2(fmaf(st[e + 1], sl2, -lse2[r]));
        if (mask) {
          const int row = row_a + 8 * r;
          if (key >= T || (causal && key > row)) p0 = 0.f;
          if (key + 1 >= T || (causal && key + 1 > row)) p1 = 0.f;
        }
        da[t] = pack<E>(p0 * (dp[e] - dl[r]) * scale,
                        p1 * (dp[e + 1] - dl[r]) * scale);
      }

      // dq += dS K: K (64 keys, this warpgroup's DW columns) MN-major
      const uint32_t kc_addr = k_addr + (cw / 64) * S::KV_SLAB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<E, 1>(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                     da[4 * kk + 3],
                     desc(kc_addr + kk * 16 * SLAB, S::KV_SLAB), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (tid == 0) mbar_arrive(&kv_empty[s]);
  }

  // dq in E, rows at or past T skipped
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= T) continue;
    E* out = dq + q_base + (int64_t)row * q_rs + cw + col;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack<E>(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  }
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hk, int T, int bh_layout, float scale, int causal,
           cudaStream_t stream) {
  using S = DqSmem<D>;
  CUtensorMap mq, mk, mv, mdo;
  int e = make_head_map<E>(&mq, q, D, H, T, B, bh_layout, S::BQ);
  if (!e) e = make_head_map<E>(&mdo, dout, D, H, T, B, bh_layout, S::BQ);
  if (!e) e = make_head_map<E>(&mk, k, D, Hk, T, B, bh_layout, S::BK);
  if (!e) e = make_head_map<E>(&mv, v, D, Hk, T, B, bh_layout, S::BK);
  if (e) return e;
  const int bytes = S::BYTES, tiles = (T + S::BQ - 1) / S::BQ;
  if (!ptt::grid_fits(tiles, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_bwd_dq_sm90_kernel<E, D>, bytes);
  if (e) return e;
  flash_bwd_dq_sm90_kernel<E, D><<<tiles * B * H, THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<E*>(dq), H, Hk, T, bh_layout,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: TF32 wgmma (see the header) ----

template <int D> struct DqTf32Smem {
  static_assert(D == 64 || D == 128 || D == 256,
                "the f32 dq kernel takes D 64, 128 and 256");
  // D 256: a cluster of CTAS = 2 CTAs, each owning DC = 128 of D's
  // columns, both warpgroups the same BQ = 64 q rows and DW = 64 of the
  // CTA's dq columns each; else each warpgroup its own 64 rows, all of D
  static constexpr bool CLUSTER = D == 256;
  static constexpr int CTAS = CLUSTER ? 2 : 1, DC = D / CTAS;
  static constexpr int BQ = CLUSTER ? 64 : 128, BK = D == 64 ? 64 : 32;
  static constexpr int DW = CLUSTER ? DC / 2 : D;  // dq columns a warpgroup
  static constexpr int STAGES = 2, KT_STAGES = 2;
  static constexpr int SLABS = DC / 32;  // 32 f32 columns a slab
  static constexpr int Q_SLAB = BQ * SLAB, KV_SLAB = BK * SLAB;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  // K^T: DC rows (of 128 bytes: 32 keys), BK / 32 slabs
  static constexpr int KT_SLAB = DC * SLAB, KT_TILE = (BK / 32) * KT_SLAB;
  static constexpr int Q = 0;
  static constexpr int DO = Q + SLABS * Q_SLAB;
  static constexpr int K = DO + SLABS * Q_SLAB;  // slot s at K + s * KV_TILE
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int KT = V + STAGES * KV_TILE;
  // CLUSTER: the peer's partial S then dP (BQ x BK f32 each, as
  // send_partial lays them out), then this CTA's own two for the other
  // warpgroup, in two buffers (a warpgroup may write tile j + 1's while
  // the other still reads tile j's)
  static constexpr int XS = KT + KT_STAGES * KT_TILE;
  static constexpr int X_TILE = BQ * BK * 4, X_BYTES = CLUSTER ? 2 * X_TILE : 0;
  static constexpr int LX = XS + X_BYTES;
  static constexpr int BAR = LX + 2 * X_BYTES;
  // q_full, kv_full[STAGES], kv_empty[STAGES], kt_full[KT_STAGES],
  // kt_empty[KT_STAGES], and with CLUSTER x_full, x_empty
  static constexpr int BYTES =
      BAR + 8 * (1 + 2 * STAGES + 2 * KT_STAGES + (CLUSTER ? 2 : 0)) + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int H, int Hk, int T,
                              int bh_layout, float scale, int causal) {
  using S = DqTf32Smem<D>;
  constexpr int STAGES = S::STAGES, KTS = S::KT_STAGES, SLABS = S::SLABS;
  constexpr int BQ = S::BQ, BK = S::BK, DC = S::DC, DW = S::DW;
  constexpr bool CLUSTER = S::CLUSTER;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;
  uint64_t* kt_full = kv_empty + STAGES;
  uint64_t* kt_empty = kt_full + KTS;
  uint64_t* x_full = kt_empty + KTS;  // CLUSTER: the peer's partials landed
  uint64_t* x_empty = x_full + 1;     // CLUSTER: the peer read ours

  // CLUSTER: blocks 2 c and 2 c + 1 are cluster c's two CTAs, this one
  // owning D's columns [c0, c0 + DC); both walk the same key tiles
  const int n_qt = (T + BQ - 1) / BQ;
  const int tile = CLUSTER ? (blockIdx.x / 2) % n_qt : ptt::grid_tile(n_qt);
  const int qt = n_qt - 1 - tile;  // longest causal rows first
  const int bh = CLUSTER ? blockIdx.x / 2 / n_qt : ptt::grid_bh(n_qt);
  const int rank = CLUSTER ? cluster_ctarank() : 0, c0 = DC * rank;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = qt * BQ;
  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < KTS; ++s) {
      mbar_init(&kt_full[s], TF32_TRANSPOSERS);
      mbar_init(&kt_empty[s], 2);
    }
    if constexpr (CLUSTER) {
      mbar_init(x_full, 1);   // its expect_tx; the bytes come from the peer
      mbar_init(x_empty, 8);  // each of the peer's consumer warps
      // the first tile's bytes, before the peer may send them (a later
      // tile's is expected as the previous one is released)
      mbar_expect_tx(x_full, S::X_BYTES);
    }
    fence_barrier_init();
  }
  if constexpr (CLUSTER)
    cluster_sync();  // both CTAs' barriers exist before any remote use
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: thread 256 issues the TMA loads; warps 1-3 write
    // each K tile's transpose K^T, keys in the A fragments' order ----
    setmaxnreg_dec<TF32_PRODUCER_REGS>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      prefetch_map(&mk);
      prefetch_map(&mv);
      const int2 cq = head_coords(b, h, H, bh_layout);
      const int2 ck = head_coords(b, hk, Hk, bh_layout);
      mbar_expect_tx(q_full, 2 * SLABS * S::Q_SLAB);
      for (int r = 0; r < SLABS; ++r) {
        tma_load_4d(smem + S::Q + r * S::Q_SLAB, &mq, q_full, c0 + 32 * r,
                    cq.x, q0, cq.y);
        tma_load_4d(smem + S::DO + r * S::Q_SLAB, &mdo, q_full,
                    c0 + 32 * r, cq.x, q0, cq.y);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        mbar_wait(&kv_empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * S::KV_TILE);
        for (int r = 0; r < SLABS; ++r) {
          tma_load_4d(smem + S::K + s * S::KV_TILE + r * S::KV_SLAB, &mk,
                      &kv_full[s], c0 + 32 * r, ck.x, j * BK, ck.y);
          tma_load_4d(smem + S::V + s * S::KV_TILE + r * S::KV_SLAB, &mv,
                      &kv_full[s], c0 + 32 * r, ck.x, j * BK, ck.y);
        }
      }
    } else if (pt >= 32) {
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES, ks = j % KTS;
        mbar_wait(&kv_full[s], (j / STAGES) & 1);
        mbar_wait(&kt_empty[ks], ((j / KTS) & 1) ^ 1);
        transpose_tf32<BK, DC, true, TF32_TRANSPOSERS / 32>(
            smem + S::K + s * S::KV_TILE, smem + S::KT + ks * S::KT_TILE,
            pt / 32 - 1, pt % 32);
        fence_proxy_async();
        mbar_arrive(&kt_full[ks]);
      }
    }
    if constexpr (CLUSTER) cluster_sync();  // the consumers' final one
    return;
  }

  // ---- consumers: warpgroup wg owns q rows [q0w, q0w + 64) and dq's
  // columns [c0 + cw, c0 + cw + DW) (CLUSTER: both the same rows, half of
  // the CTA's columns each; else all of D)
  setmaxnreg_inc<TF32_CONSUMER_REGS>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rw = CLUSTER ? 0 : 64 * wg, cw = CLUSTER ? DW * wg : 0;
  const int q0w = q0 + rw;
  const int row_a = q0w + 16 * warp + lane / 4;  // row_b = +8
  const int col = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;

  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool in = row < T;
    lse2[r] = in ? lse[(int64_t)bh * T + row] * LOG2E : 0.f;
    dl[r] = in ? delta[(int64_t)bh * T + row] : 0.f;
  }

  float acc[DW / 2];  // dq
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;

  const uint32_t q_addr = smem_u32(smem + S::Q) + rw * SLAB;
  const uint32_t do_addr = smem_u32(smem + S::DO) + rw * SLAB;
  // CLUSTER: the peer's partials (warpgroup 0 sends S at 0, warpgroup 1
  // dP at X_TILE of the peer's buffer) and barriers
  uint32_t x_peer = 0, x_full_peer = 0, x_empty_peer = 0;
  if constexpr (CLUSTER) {
    x_peer = mapa(smem_u32(smem + S::XS), rank ^ 1) + wg * S::X_TILE;
    x_full_peer = mapa(smem_u32(x_full), rank ^ 1);
    x_empty_peer = mapa(smem_u32(x_empty), rank ^ 1);
  }
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES, ks = j % KTS, k0 = j * BK;
    mbar_wait(&kv_full[s], (j / STAGES) & 1);
    // CLUSTER: no tile is skipped (the last causal one starts 32 keys
    // before the q tile's last row), so both CTAs exchange every tile
    if (CLUSTER || !((causal && k0 > q0w + 63) || q0w >= T)) {
      const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV_TILE);

      // S = Q_wg K^T and dP = dO_wg V^T: (64 q, BK keys) f32 each,
      // m64nBKk8 from shared memory
      float st[BK / 2], dp[BK / 2];
      if constexpr (CLUSTER) {
        // partial sums over this CTA's DC columns: warpgroup 0 forms S,
        // warpgroup 1 dP, and each sends its partial to the peer (once
        // the peer has read the last tile's) and hands it to the other
        // warpgroup through LX; then both add the peer's two partials
        // once they have landed (one exchange a key tile, so j counts
        // the phases)
        float x[BK / 2];
        const uint32_t a_addr = wg == 0 ? q_addr : do_addr;
        const uint32_t b_addr = wg == 0 ? k_addr : v_addr;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DC / 8; ++kk) {
          const uint32_t aoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
          const uint32_t boff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
          mma_ss_tf32(x, desc_k(a_addr + aoff), desc_k(b_addr + boff),
                      kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        unsigned char* lx = smem + S::LX + (j & 1) * S::X_BYTES;
        mbar_wait_cluster(x_empty, (j & 1) ^ 1);
        send_partial(x, x_peer, tid, x_full_peer);
        put_partial(x, lx + wg * S::X_TILE, tid);
        named_barrier(1, 256);  // both warpgroups' partials are in LX
        float y[BK / 2];
        get_partial(y, lx + (wg ^ 1) * S::X_TILE, tid);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          st[i] = wg == 0 ? x[i] : y[i];
          dp[i] = wg == 0 ? y[i] : x[i];
        }
        mbar_wait_cluster(x_full, j & 1);
        add_partial(st, smem + S::XS, tid);
        add_partial(dp, smem + S::XS + S::X_TILE, tid);
        __syncwarp();
        if (lane == 0) {
          // the next tile's bytes are expected before the peer, released
          // here, may send them
          if (tid == 0 && wg == 0 && j + 1 < n_kt)
            mbar_expect_tx(x_full, S::X_BYTES);
          mbar_arrive_cluster(x_empty_peer);
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
          mma_ss_tf32(st, desc_k(q_addr + qoff), desc_k(k_addr + koff),
                      kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
          mma_ss_tf32(dp, desc_k(do_addr + qoff), desc_k(v_addr + koff),
                      kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);
      }

      // dS = P (dP - delta) scale with P in f32, in place
      const bool mask = (causal && k0 + BK - 1 > q0w) || k0 + BK > T;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e / 2) % 2;
        const int key = k0 + 8 * (e / 4) + col + (e % 2);
        float p = ex2(fmaf(st[e], sl2, -lse2[r]));
        if (mask) {
          const int row = row_a + 8 * r;
          if (key >= T || (causal && key > row)) p = 0.f;
        }
        dp[e] = p * (dp[e] - dl[r]) * scale;
      }
      // its TF32 A fragments: each k8 block of keys in the order K^T is
      // written in
      uint32_t da[BK / 2];
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) {
        da[4 * t] = tf32(dp[4 * t]);
        da[4 * t + 1] = tf32(dp[4 * t + 2]);
        da[4 * t + 2] = tf32(dp[4 * t + 1]);
        da[4 * t + 3] = tf32(dp[4 * t + 3]);
      }

      // dq += dS K as (dS in A fragments) (K^T's DW rows of this
      // warpgroup's columns, K-major), m64nDWk8
      mbar_wait(&kt_full[ks], (j / KTS) & 1);
      const uint32_t kt_addr =
          smem_u32(smem + S::KT + ks * S::KT_TILE) + cw * SLAB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        mma_rs_tf32(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                    da[4 * kk + 3],
                    desc_k(kt_addr + (kk / 4) * S::KT_SLAB + (kk % 4) * 32),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      // the slot and its K^T buffer are released only once the K^T is
      // written: an early arrival could count in the buffer's last use
      mbar_wait(&kt_full[ks], (j / KTS) & 1);
    }
    if (tid == 0) {
      mbar_arrive(&kv_empty[s]);
      mbar_arrive(&kt_empty[ks]);
    }
  }

  // dq in f32, rows at or past T skipped
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= T) continue;
    float* out = dq + q_base + (int64_t)row * q_rs + c0 + cw + col;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c)
      *reinterpret_cast<float2*>(out + 8 * c) =
          make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  }
  if constexpr (CLUSTER) cluster_sync();  // the peer writes here no more
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, int B, int H, int Hk, int T, int bh_layout,
                float scale, int causal, cudaStream_t stream) {
  using S = DqTf32Smem<D>;
  CUtensorMap mq, mk, mv, mdo;
  int e = make_head_map<float>(&mq, q, D, H, T, B, bh_layout, S::BQ);
  if (!e) e = make_head_map<float>(&mdo, dout, D, H, T, B, bh_layout, S::BQ);
  if (!e) e = make_head_map<float>(&mk, k, D, Hk, T, B, bh_layout, S::BK);
  if (!e) e = make_head_map<float>(&mv, v, D, Hk, T, B, bh_layout, S::BK);
  if (e) return e;
  const int tiles = (T + S::BQ - 1) / S::BQ;
  if (!ptt::grid_fits(tiles * S::CTAS, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_bwd_dq_sm90_tf32_kernel<D>, S::BYTES);
  if (e) return e;
  if constexpr (S::CLUSTER)
    return launch_clusters(flash_bwd_dq_sm90_tf32_kernel<D>,
                           tiles * S::CTAS * B * H, THREADS, S::BYTES,
                           S::CTAS, stream, mq, mk, mv, mdo, lse, delta,
                           static_cast<float*>(dq), H, Hk, T, bh_layout,
                           scale, causal);
  flash_bwd_dq_sm90_tf32_kernel<D>
      <<<tiles * B * H, THREADS, S::BYTES, stream>>>(
          mq, mk, mv, mdo, lse, delta, static_cast<float*>(dq), H, Hk, T,
          bh_layout, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_dim(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, int B, int H,
               int Hk, int T, int D, int bh_layout, float scale, int causal,
               cudaStream_t s) {
  switch (D) {
    case 64: return launch<E, 64>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                  T, bh_layout, scale, causal, s);
    case 128: return launch<E, 128>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                    T, bh_layout, scale, causal, s);
    case 256: return launch<E, 256>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                    T, bh_layout, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As flash_bwd_dq (flash_bwd_dq.cu) for bf16 (dtype 1), fp16 (dtype 2)
// and f32 (dtype 0) at D in {64, 128, 256}; any other dtype or head dim
// is cudaErrorInvalidValue.  q, k, v, dout, dq 16-byte
// aligned.
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int B, int H,
                                 int Hk, int T, int D, int bh_layout,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::F32) {
    if (D == 64)
      return launch_tf32<64>(q, k, v, dout, lse, delta, dq, B, H, Hk, T,
                             bh_layout, scale, causal, s);
    if (D == 128)
      return launch_tf32<128>(q, k, v, dout, lse, delta, dq, B, H, Hk, T,
                              bh_layout, scale, causal, s);
    if (D == 256)
      return launch_tf32<256>(q, k, v, dout, lse, delta, dq, B, H, Hk, T,
                              bh_layout, scale, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == ptt::BF16)
    return launch_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Hk,
                                     T, D, bh_layout, scale, causal, s);
  if (dtype == ptt::F16)
    return launch_dim<__half>(q, k, v, dout, lse, delta, dq, B, H, Hk, T, D,
                              bh_layout, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
