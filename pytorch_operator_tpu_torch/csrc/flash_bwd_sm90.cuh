// The key-tile walk of the Hopper flash backward (flash_bwd_sm90.cu) and
// of the Hopper dk/dv kernel (flash_bwd_dkv_sm90.cu).
//
// One CTA per (BK-key tile, q head), three warpgroups: the producer warp
// streams the q tiles, the two consumer warpgroups keep dK and dV in
// wgmma accumulators (see flash_bwd_sm90.cu).  With DQ the walk also
// forms dq_tile = dS K and adds it to dq; without it the walk is the
// dk/dv kernel's, whose dk and dv are therefore bitwise the fused
// kernel's.
//
// How the consumers split the tile, by head dim:
//  - D 64 and 128: BK = 128 keys; warpgroup wg owns keys [64 wg, 64 wg +
//    64) and all of D.
//  - D 256: 128 keys would not fit twice over.  K and V alone would take
//    128 KB of shared memory beside the ~130 KB ring of 64-row Q / dO
//    tiles (227 KB is a block's most), and a warpgroup's dK and dV over
//    all of D (2 x 64 x 256 f32) 256 registers a thread (240 is the
//    consumers' most).  So BK = 64 keys (K and V 64 KB, 210 KB in all),
//    both warpgroups own all 64 keys, and warpgroup wg owns columns
//    [128 wg, 128 wg + 128) of dK and dV (128 registers).  Each forms
//    the whole S^T and dP^T (64 keys x 64 q) itself: the two products
//    are repeated, which costs tensor time but no shared-memory exchange
//    or extra barrier.  It forms them in two passes of 32 q columns and
//    its 128 columns of dq_tile as two 64-column products, so that a
//    thread holds at most dK, dV and 32 (S^T, dP^T) or 32 (dq_tile) f32
//    beside them; each writes half of dS^T's q columns.
//  - D 32 and 16 (NARROW): a 16-bit row of Q, dO, K and V is 64 or 32
//    bytes, one narrow slab each (sm90.cuh: TMA and the descriptors
//    swizzle at the row's width; the walk writes none of them by hand).
//    The products are a quarter or an eighth of D 128's per score
//    element while the exponentials and the per-tile handshakes stay, so
//    the q tiles are 128 rows (half the tiles, barriers and waits a
//    score element): BK = 128 keys, warpgroup wg owning keys [64 wg,
//    64 wg + 64) and all of D as at D 128, S^T and dP^T 64 keys x 128 q
//    (64 f32 each), dK / dV m64nDk16.  dS^T keeps its 128-byte slabs
//    (keys as rows, two slabs of 64 q), and dq_tile = dS K is split by q
//    rows: warpgroup wg forms rows [64 wg, 64 wg + 64) over all D
//    columns (A = dS^T's slab wg, B = K at N = D: one narrow block, so no
//    product starts inside one).  A tile's products are committed one
//    group each, so that P^T's exponentials run while dP^T is formed and
//    dS^T's elementwise while dV += P^T dO runs (3-9 % faster than
//    waiting for S^T and dP^T together).  The slot is released as soon
//    as dK / dV have read it.  Timed in turns on the H100 (PERF.md §6),
//    this beat 64-row q tiles, and 128-row ones whose warpgroups each
//    add the part of dq over their own keys (no barrier, twice the
//    atomics), by 5-18 % in the fused kernel (64-row tiles were 3-4 %
//    faster in the dk/dv kernel, which runs this same walk); a 4-slot
//    ring, or dq issued behind dK, gave nothing.
//
// f32 (walk_tf32, every D) multiplies in TF32, whose wgmma takes both
// shared-memory operands K-major.  S^T = K Q^T and dP^T = V dO^T
// are K-major already; the other three products read an MN-major
// operand at 16 bits, so the f32 walk writes transposed copies:
//  - dV += P^T dO and dK += dS^T Q take dO^T and Q^T (D rows of the 32
//    q of a tile), written by the producer warpgroup's warps 1-3 from
//    each ring slot (TMA rounds Q, dO, K and V to TF32 as it loads them:
//    sm90.cuh make_map), q in the order [0, 2, 4, 6, 1, 3,
//    5, 7] of each 8 so that P^T's and dS^T's accumulator registers,
//    rounded (cvt.rna), are the k8 A fragments as they are (sm90.cuh);
//  - dq = dS K is formed as dq^T = K^T dS^T: K^T written once a CTA by
//    the same warps, dS stored by the consumers q-row-major (keys
//    K-major), rounded to TF32, and dq^T's elements added to dq by
//    scalar f32 reductions.
// Shared memory doubles at f32: 32-row q tiles, and at D 128 64-key
// tiles split by D's columns as at D 256 above (K + V 64 KB, K^T 32,
// ring 66, Q^T + dO^T 32, two dS buffers 16: 210 KB); at D 64 128 keys
// split by keys (194 KB, two Q^T / dO^T buffers).  D 256 does not fit
// one CTA (K and V alone take 128 KB at 64 keys, K^T 64 more: about 400
// KB in all), so at f32 D 256 a cluster of two CTAs takes each (64-key
// tile, q head), CTA r owning columns [128 r, 128 r + 128) of K, V, Q,
// dO, dK, dV and dq: each is the D 128 walk over its 128 columns, but
// that its S^T = K Q^T and dP^T = V dO^T are partial sums over its half
// of D.  Per q tile each CTA's warpgroup 0 sends its partial S^T and
// warpgroup 1 its partial dP^T (64 x 32 f32 each) into the peer's shared
// memory (sm90.cuh send_partial: st.async, whose bytes complete the
// peer's x_full mbarrier), each CTA adds the peer's partials to its own
// (own + peer in one CTA is peer + own in the other, so both hold the
// same bits of S^T and dP^T, hence of P^T and dS^T), and every consumer
// warp then arrives on the peer's x_empty, which the peer waits on
// before it sends the next tile.
// The room for the peer's partials (16 KB) comes from the ring: there
// lse and delta leave the slots, whose rounding to 1 KB took 2 KB.
// f32 at D 32 and 16 (NARROW): a row of Q, dO, K or V is 128 or 64 bytes,
// one slab (at D 16 swizzled at 64 bytes, read by descriptors of
// desc_hi(64), as the 16-bit D 32 walk's); a k8 step moves 32 bytes
// inside it.  As at 16 bits the products are small beside the
// exponentials and the per-tile handshakes, so the tiles are 128 keys
// (warpgroup wg owning keys [64 wg, 64 wg + 64)) by 128 q rows: S^T and
// dP^T m64n128k8 (64 f32 each, each its own commit group, P^T's
// exponentials while dP^T runs), dV / dK m64nDk8 from Q^T and dO^T in
// four 32-q slabs of D rows (transpose_tf32: at D 16 from the narrow
// slab).  P^T and dS^T are rounded to TF32 in place, their registers
// taken in the fragments' order at the product, so a thread holds S^T,
// dP^T, dK and dV (128 + D f32) and no second copy.  dq^T = K^T dS^T
// would put D in wgmma's M, which is 64, so dq = dS K instead, split by
// q rows as at 16 bits: warpgroup wg forms q rows [64 wg, 64 wg + 64)
// over all D (A = dS, q rows of 128 keys K-major in four 32-key slabs;
// B = K^T, D rows of 128 keys) and adds them with vector f32 reductions.
// dS takes 64 KB a buffer: at D 16 two fit (219 KB); at D 32 the fused
// kernel keeps one dS buffer and one Q^T / dO^T stage (211 KB), and a
// warpgroup writes the next tile's dS only once the other has read this
// one's (named barriers 2 and 3).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace ptt {
namespace bwd_sm90 {

using namespace ptt::sm90;

constexpr int BQ = 64, SLAB = 128;  // rows; bytes per slab row
constexpr int THREADS = 384, STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// Key rows and q rows of a CTA's tiles (see above).
template <int D> constexpr int key_tile() { return D == 256 ? 64 : 128; }
template <int D> constexpr int q_tile() { return D < 64 ? 128 : BQ; }

template <int D, bool DQ> struct BwdSmem {
  // NARROW (D 16 / 32): one slab of 2 D bytes a row (see above)
  static constexpr bool NARROW = D < 64;
  static constexpr int RB = NARROW ? 2 * D : SLAB;  // bytes a slab row
  static constexpr int SLABS = NARROW ? 1 : D / 64, BK = key_tile<D>();
  static constexpr int BQ = q_tile<D>();
  static constexpr int K_SLAB = BK * RB, Q_SLAB = BQ * RB;
  static constexpr int K = 0;
  static constexpr int V = K + SLABS * K_SLAB;
  // one ring slot: Q, dO, then lse (times log2 e) and delta, BQ f32 each
  static constexpr int DO_OFF = SLABS * Q_SLAB;
  static constexpr int LSE_OFF = 2 * SLABS * Q_SLAB;
  static constexpr int DELTA_OFF = LSE_OFF + BQ * 4;
  static constexpr int SLOT = (DELTA_OFF + BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int RING = V + SLABS * K_SLAB;
  // with DQ: dS^T (BK keys, BQ q) in E, BQ / 64 128-byte-swizzled slabs
  // of 64 q, in two buffers (a warpgroup may write tile i + 1's while the
  // other still reads tile i's)
  static constexpr int DS = RING + STAGES * SLOT;
  static constexpr int DS_SLAB = BK * SLAB, DS_BUF = (BQ / 64) * DS_SLAB;
  static constexpr int BAR = DS + (DQ ? 2 : 0) * DS_BUF;
  // kv_full, q_full[STAGES], q_empty[STAGES]; 1024 bytes of slack to
  // align the dynamic shared memory to the swizzle's 1024-byte period
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// The walk's tensor maps: q and dO in boxes of BQ rows, k and v of
// key_tile<D>().
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Rows of the walk's q tiles and key tiles over E at head dim D, and the
// bytes of a slab row: the f32 walk's (walk_tf32) are 32 q rows and 64
// keys at D 128 and 256, 128 at D 64, and 128 of each at D 16 / 32, whose
// rows are one slab of 4 D bytes; a 16-bit D 16 / 32 has narrow slabs.
template <typename E, int D> struct WalkTiles {
  static constexpr int BQ = q_tile<D>(), BK = key_tile<D>();
  static constexpr int RB = BwdSmem<D, false>::RB;
};
template <int D> struct WalkTiles<float, D> {
  static constexpr int BQ = D < 64 ? 128 : 32;
  static constexpr int BK = D <= 64 ? 128 : 64, RB = D < 64 ? 4 * D : SLAB;
};

template <typename E, int D>
int make_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, int B, int H, int Hk, int T, int bh_layout) {
  using W = WalkTiles<E, D>;
  int e = make_head_map<E>(&m->q, q, D, H, T, B, bh_layout, W::BQ, W::RB);
  if (!e)
    e = make_head_map<E>(&m->dout, dout, D, H, T, B, bh_layout, W::BQ,
                         W::RB);
  if (!e)
    e = make_head_map<E>(&m->k, k, D, Hk, T, B, bh_layout, W::BK, W::RB);
  if (!e)
    e = make_head_map<E>(&m->v, v, D, Hk, T, B, bh_layout, W::BK, W::RB);
  return e;
}

// The body of a kernel launched with THREADS threads and
// BwdSmem<D, DQ>::BYTES of dynamic shared memory on a grid of
// ceil(T / BK) * B * H blocks (common.cuh grid_tile / grid_bh); the maps
// are the kernel's __grid_constant__ parameters (make_maps<E, D>).
//
// Registers: a consumer thread holds its dK and dV (DW / 2 f32 each) for
// the whole walk.  Beside them it holds the S^T and dP^T accumulators
// (BQ / 2 f32 each, issued back to back) until P^T and dS^T are formed
// from them, dS^T from the f32 P^T as the TPU kernel forms ds from the
// f32 p; dV / dK complete before dq_tile is issued.  At D 128 the peak
// is 128 + 64 f32 (dK, dV, S^T, dP^T) and the E pairs that replace them;
// at D 256 128 + 32 (S^T and dP^T in two passes of 32 q columns); at D
// 32 32 + 128 (S^T and dP^T over 128 q).
template <typename E, int D, bool DQ>
__device__ __forceinline__ void walk(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    const CUtensorMap& mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    float* __restrict__ dkp, float* __restrict__ dvp, int H, int Hk, int T,
    int bh_layout, float scale, int causal) {
  using S = BwdSmem<D, DQ>;
  constexpr int SLABS = S::SLABS, BK = S::BK, BQ = S::BQ, RB = S::RB;
  constexpr uint32_t HI = desc_hi(RB);  // DESC_HI but NARROW
  // D 256 splits D between the consumers, the others the keys
  constexpr bool SPLIT = D == 256;
  constexpr int DW = SPLIT ? D / 2 : D;  // dK / dV columns a warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + STAGES;

  const int kt = grid_tile((T + BK - 1) / BK);  // tile 0 walks the most q tiles
  const int bh = grid_bh((T + BK - 1) / BK);
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int k0 = kt * BK;
  const int n_qt = (T + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&q_full[s], 32);  // the producer warp's lanes
      mbar_init(&q_empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one warp; lane 0 issues the TMA loads, every lane
    // brings two of the slot's lse (times log2 e) and delta rows ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        prefetch_map(&mq);
        prefetch_map(&mdo);
        const int2 ck = head_coords(b, hk, Hk, bh_layout);
        mbar_expect_tx(kv_full, 2 * SLABS * S::K_SLAB);
        for (int r = 0; r < SLABS; ++r) {
          tma_load_4d(smem + S::K + r * S::K_SLAB, &mk, kv_full, 64 * r,
                      ck.x, k0, ck.y);
          tma_load_4d(smem + S::V + r * S::K_SLAB, &mv, kv_full, 64 * r,
                      ck.x, k0, ck.y);
        }
      }
      const int2 cq = head_coords(b, h, H, bh_layout);
      const float* lse_row = lse + (int64_t)bh * T;
      const float* delta_row = delta + (int64_t)bh * T;
      for (int i = i0; i < n_qt; ++i) {
        const int it = i - i0, s = it % STAGES, q0 = i * BQ;
        mbar_wait(&q_empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* slot = smem + S::RING + s * S::SLOT;
        float* lse_s = reinterpret_cast<float*>(slot + S::LSE_OFF);
        float* delta_s = reinterpret_cast<float*>(slot + S::DELTA_OFF);
        for (int t = lane; t < BQ; t += 32) {
          const bool in = q0 + t < T;
          lse_s[t] = in ? lse_row[q0 + t] * LOG2E : 0.f;
          delta_s[t] = in ? delta_row[q0 + t] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&q_full[s], 2 * SLABS * S::Q_SLAB);
          for (int r = 0; r < SLABS; ++r) {
            tma_load_4d(slot + r * S::Q_SLAB, &mq, &q_full[s], 64 * r, cq.x,
                        q0, cq.y);
            tma_load_4d(slot + S::DO_OFF + r * S::Q_SLAB, &mdo, &q_full[s],
                        64 * r, cq.x, q0, cq.y);
          }
        } else {
          mbar_arrive(&q_full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [k0 + kw, k0 + kw + 64) and
  // columns [cw, cw + DW) of dK and dV
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int kw = SPLIT ? 0 : 64 * wg, cw = SPLIT ? DW * wg : 0;
  const int key_a = k0 + kw + 16 * warp + lane / 4;  // key_b = +8
  const int col = 2 * (lane % 4);

  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_addr = smem_u32(smem + S::K) + kw * RB;
  const uint32_t v_addr = smem_u32(smem + S::V) + kw * RB;
  // this warpgroup's half of D of K, for dq = dS K (not NARROW): half of
  // the one slab's row at D = 64, a slab at D = 128, two slabs at D = 256
  const uint32_t kh_addr =
      smem_u32(smem + S::K) +
      (SLABS == 1 ? wg * 64 : (SLABS / 2) * wg * S::K_SLAB);
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
  mbar_wait(kv_full, 0);

  for (int i = i0; i < n_qt; ++i) {
    const int it = i - i0, s = it % STAGES, q0 = i * BQ;
    mbar_wait(&q_full[s], (it / STAGES) & 1);
    unsigned char* slot = smem + S::RING + s * S::SLOT;
    const uint32_t q_addr = smem_u32(slot);
    const uint32_t do_addr = q_addr + S::DO_OFF;
    const float* lse_s = reinterpret_cast<const float*>(slot + S::LSE_OFF);
    const float* delta_s =
        reinterpret_cast<const float*>(slot + S::DELTA_OFF);
    const bool mask = (causal && q0 < k0 + BK) || q0 + BQ > T || k0 + BK > T;
    if constexpr (S::NARROW) {
      // S^T = K_wg Q^T, then dP^T = V_wg dO^T (64 keys, BQ q), each its
      // own group: P^T = exp2(S^T scale log2 e - lse log2 e) is formed
      // while dP^T is in flight and dV += P^T dO issued at once; dS^T =
      // P^T (dP^T - delta) scale (from the f32 P^T) while dV runs; then
      // dK += dS^T Q.  dO and Q are MN-major narrow slabs
      float st[BQ / 2], dpt[BQ / 2];
      uint32_t pa[BQ / 4], da[BQ / 4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<E, 0, 0, HI>(st, desc_k(k_addr + 32 * kk),
                            desc_k(q_addr + 32 * kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<E, 0, 0, HI>(dpt, desc_k(v_addr + 32 * kk),
                            desc_k(do_addr + 32 * kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      const float sl2 = scale * LOG2E;
#pragma unroll
      for (int t = 0; t < BQ / 4; ++t) {
        const int e = 2 * t;  // columns c and c + 1 of one key row
        const int key = key_a + 8 * ((e / 2) % 2);
        const int c = 8 * (e / 4) + col;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        float p0 = ex2(fmaf(st[e], sl2, -ls.x));
        float p1 = ex2(fmaf(st[e + 1], sl2, -ls.y));
        if (mask) {
          const int q = q0 + c;
          const bool kin = key < T;
          if (!(kin && q < T && (!causal || key <= q))) p0 = 0.f;
          if (!(kin && q + 1 < T && (!causal || key <= q + 1))) p1 = 0.f;
        }
        st[e] = p0;
        st[e + 1] = p1;
        pa[t] = pack<E>(p0, p1);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<E, 1, HI>(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                         pa[4 * kk + 3],
                         desc(do_addr + kk * 16 * RB, S::Q_SLAB), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dpt);
#pragma unroll
      for (int t = 0; t < BQ / 4; ++t) {
        const int e = 2 * t, c = 8 * (e / 4) + col;
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
        da[t] = pack<E>(st[e] * (dpt[e] - dl.x) * scale,
                        st[e + 1] * (dpt[e + 1] - dl.y) * scale);
      }
      unsigned char* ds_buf = smem + S::DS + (it & 1) * S::DS_BUF;
      if constexpr (DQ) {
        // dS^T into shared memory for dq_tile = dS K below: q column c
        // in slab c / 64
#pragma unroll
        for (int t = 0; t < BQ / 4; ++t) {
          const int e = 2 * t, c8 = 8 * (e / 4);
          const int r = kw + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
          *reinterpret_cast<uint32_t*>(ds_buf + (c8 / 64) * S::DS_SLAB +
                                       swizzle_128b(r, c8 % 64 + col)) =
              da[t];
        }
        fence_proxy_async();
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<E, 1, HI>(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                         da[4 * kk + 3],
                         desc(q_addr + kk * 16 * RB, S::Q_SLAB), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      // Q, dO, lse and delta were read last here
      if (tid == 0) mbar_arrive(&q_empty[s]);

      if constexpr (DQ) {
        // both warpgroups' halves of dS^T are in place; this warpgroup's
        // 64 q rows of dq_tile = dS K over all D: A = dS (64 q, BK keys)
        // read from dS^T's slab wg (MN-major), B = K (BK keys, D)
        // MN-major
        named_barrier(1, 256);
        const uint32_t ds_addr = smem_u32(ds_buf) + wg * S::DS_SLAB;
        const uint32_t kq_addr = smem_u32(smem + S::K);
        float dqa[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_ss<E, 1, 1, DESC_HI, HI>(
              dqa, desc(ds_addr + kk * 16 * SLAB, S::DS_SLAB),
              desc(kq_addr + kk * 16 * RB, S::K_SLAB), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        // added to dq by vector f32 reductions (red.global.add.v2.f32)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * r;
          if (q >= T) continue;
          float* dst = dq + q_base + (int64_t)q * q_rs + col;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * c),
                      make_float2(dqa[4 * c + 2 * r],
                                  dqa[4 * c + 2 * r + 1]));
        }
      }
    } else {
      // S^T = K_wg Q^T and dP^T = V_wg dO^T (64 keys, 64 q), issued back
      // to back; then P^T = exp2(S^T scale log2 e - lse log2 e) and
      // dS^T = P^T (dP^T - delta) scale from the f32 P^T, each rounded to
      // E pairs: the A fragments of dV += P^T dO and dK += dS^T Q
      // At D 256 in two passes of 32 q columns (m64n32k16), so that S^T and
      // dP^T beside dK and dV take 32 registers, not 64: over all 64 q
      // columns ptxas spilled there
      constexpr int QP = SPLIT ? 2 : 1, QW = BQ / QP;  // passes; q a pass
      uint32_t pa[BQ / 4], da[BQ / 4];
#pragma unroll
      for (int qp = 0; qp < QP; ++qp) {
        float st[QW / 2], dpt[QW / 2];
        const uint32_t q_rows = qp * QW * SLAB;  // rows qp QW.. of Q and dO
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk / 4) * S::K_SLAB + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
          mma_ss<E, 0, 0>(st, desc_k(k_addr + koff),
                          desc_k(q_addr + q_rows + qoff), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk / 4) * S::K_SLAB + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
          mma_ss<E, 0, 0>(dpt, desc_k(v_addr + koff),
                          desc_k(do_addr + q_rows + qoff), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        const float sl2 = scale * LOG2E;
#pragma unroll
        for (int t = 0; t < QW / 4; ++t) {
          const int e = 2 * t;  // columns c and c + 1 of one key row
          const int key = key_a + 8 * ((e / 2) % 2);
          const int c = qp * QW + 8 * (e / 4) + col;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
          float p0 = ex2(fmaf(st[e], sl2, -ls.x));
          float p1 = ex2(fmaf(st[e + 1], sl2, -ls.y));
          if (mask) {
            const int q = q0 + c;
            const bool kin = key < T;
            if (!(kin && q < T && (!causal || key <= q))) p0 = 0.f;
            if (!(kin && q + 1 < T && (!causal || key <= q + 1))) p1 = 0.f;
          }
          pa[qp * QW / 4 + t] = pack<E>(p0, p1);
          da[qp * QW / 4 + t] = pack<E>(p0 * (dpt[e] - dl.x) * scale,
                                        p1 * (dpt[e + 1] - dl.y) * scale);
        }
      }
      unsigned char* ds_buf = smem + S::DS + (it & 1) * S::DS_BUF;
      if constexpr (DQ) {
        // dS^T into shared memory for dq_tile = dS K below (at D 256 both
        // warpgroups hold all of it: each writes q columns [32 wg, 32 wg
        // + 32))
#pragma unroll
        for (int t = 0; t < BQ / 4; ++t) {
          if (SPLIT && t / (BQ / 8) != wg) continue;
          const int e = 2 * t;
          const int r = kw + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
          *reinterpret_cast<uint32_t*>(
              ds_buf + swizzle_128b(r, 8 * (e / 4) + col)) = da[t];
        }
        fence_proxy_async();
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q (64 q, this warpgroup's DW
      // columns) MN-major
      const uint32_t cw_off = (cw / 64) * S::Q_SLAB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<E, 1>(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     desc(do_addr + cw_off + kk * 16 * SLAB, S::Q_SLAB), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<E, 1>(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                     da[4 * kk + 3],
                     desc(q_addr + cw_off + kk * 16 * SLAB, S::Q_SLAB), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);

      if constexpr (DQ) {
        // both warpgroups' halves of dS^T are in place
        named_barrier(1, 256);
        // this warpgroup's half of D of dq_tile = dS K: A = dS (64 q, BK
        // keys) read from dS^T (MN-major), B = K (BK keys, D / 2) MN-major;
        // at D 256 in two products of 64 columns, one after the other, so
        // that dK, dV and the product's accumulator stay in 240 registers
        // (one 128-column product beside them spilled)
        constexpr int PARTS = D == 256 ? 2 : 1, DQW = D / 2 / PARTS;
        const uint32_t ds_addr = smem_u32(ds_buf);
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
          float dqa[DQW / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            mma_ss<E, 1, 1>(
                dqa, desc(ds_addr + kk * 16 * SLAB, S::DS_BUF),
                desc(kh_addr + part * S::K_SLAB + kk * 16 * SLAB, S::K_SLAB),
                kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dqa);
          if (part == 0 && tid == 0) mbar_arrive(&q_empty[s]);

          // added to dq by vector f32 reductions (red.global.add.v2.f32)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = q0 + 16 * warp + lane / 4 + 8 * r;
            if (q >= T) continue;
            float* dst = dq + q_base + (int64_t)q * q_rs + (D / 2) * wg +
                         DQW * part + col;
#pragma unroll
            for (int c = 0; c < DQW / 8; ++c)
              atomicAdd(reinterpret_cast<float2*>(dst + 8 * c),
                        make_float2(dqa[4 * c + 2 * r],
                                    dqa[4 * c + 2 * r + 1]));
          }
        }
      } else {
        if (tid == 0) mbar_arrive(&q_empty[s]);
      }
    }
  }

  // dK / dV partials of this warpgroup's 64 keys and DW columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= T) continue;
    const int64_t off = q_base + (int64_t)key * q_rs + cw + col;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c) {
      *reinterpret_cast<float2*>(dkp + off + 8 * c) =
          make_float2(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
      *reinterpret_cast<float2*>(dvp + off + 8 * c) =
          make_float2(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the walk with TF32 wgmma (see the header)
// ---------------------------------------------------------------------------

template <int D, bool DQ> struct BwdTf32Smem {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "the f32 walk takes D 16, 32, 64, 128 and 256");
  // D 256: a cluster of CTAS = 2 CTAs, each owning DC = 128 of D's
  // columns (see the header)
  static constexpr bool CLUSTER = D == 256;
  static constexpr int CTAS = CLUSTER ? 2 : 1, DC = D / CTAS;
  // DC 128: both warpgroups own all BK keys and half of the CTA's columns
  // of dK and dV; D 64: each its own 64 keys and all of D
  static constexpr bool SPLIT = DC == 128;
  // NARROW (D 16 / 32): 128-row q tiles, Q, dO, K and V one slab of 4 D
  // bytes a row (swizzled at 64 bytes at D 16), dq = dS K (see the header)
  static constexpr bool NARROW = D < 64;
  static constexpr int BK = WalkTiles<float, D>::BK;
  static constexpr int BQ = WalkTiles<float, D>::BQ;
  static constexpr int RB = WalkTiles<float, D>::RB;  // bytes a slab row
  static constexpr int SLABS = NARROW ? 1 : DC / 32;  // 32 f32 columns a slab
  static constexpr int K_SLAB = BK * RB, Q_SLAB = BQ * RB;
  static constexpr int K = 0;
  static constexpr int V = K + SLABS * K_SLAB;
  // with DQ: K^T, DC rows of BK keys (BK / 32 slabs of DC rows), written
  // once
  static constexpr int KT_SLAB = DC * SLAB;
  static constexpr int KT = V + SLABS * K_SLAB;
  static constexpr int RING = KT + (DQ ? (BK / 32) * KT_SLAB : 0);
  // one ring slot: Q, dO (BQ rows each), then (not CLUSTER) lse (times
  // log2 e) and delta, BQ f32 each
  static constexpr int DO_OFF = SLABS * Q_SLAB;
  static constexpr int QD = 2 * SLABS * Q_SLAB;
  static constexpr int SLOT =
      CLUSTER ? QD : (QD + 2 * BQ * 4 + 1023) / 1024 * 1024;
  // Q^T then dO^T of a slot's tile: DC rows of BQ q each (BQ / 32 slabs
  // of QT_SUB bytes: one at BQ = 32), q in the A fragments' order;
  // QT_STAGES buffers.  With DQ at D 32 one, and one dS buffer, for room
  static constexpr int QT_SUB = DC * SLAB, QT_SLAB = (BQ / 32) * QT_SUB;
  static constexpr bool ROOM = NARROW && DQ && D == 32;
  static constexpr int QT_STAGES = SPLIT || ROOM ? 1 : 2;
  static constexpr int QT = RING + STAGES * SLOT;
  // with DQ: dS (BQ q rows of BK keys, BK / 32 slabs), DS_BUFS buffers
  static constexpr int DS_SLAB = BQ * SLAB, DS_BUF = (BK / 32) * DS_SLAB;
  static constexpr int DS_BUFS = ROOM ? 1 : 2;
  static constexpr int DS = QT + QT_STAGES * 2 * QT_SLAB;
  // CLUSTER: the peer's partial S^T then dP^T (BK x BQ f32 each, in the
  // order of the consumer threads' accumulator registers), then each
  // slot's lse and delta
  static constexpr int XS = DS + (DQ ? DS_BUFS : 0) * DS_BUF;
  static constexpr int X_TILE = BK * BQ * 4, X_BYTES = CLUSTER ? 2 * X_TILE : 0;
  static constexpr int ROWS = XS + X_BYTES;
  static constexpr int BAR = ROWS + (CLUSTER ? STAGES * 2 * BQ * 4 : 0);
  // kv_full, kt_full, q_full[STAGES], q_empty[STAGES], qt_full[QT_STAGES],
  // qt_empty[QT_STAGES], and with CLUSTER x_full, x_empty
  static constexpr int BYTES =
      BAR + 8 * (2 + 2 * STAGES + 2 * QT_STAGES + (CLUSTER ? 2 : 0)) + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// As walk<E, D, DQ> for f32 inputs: the same contract, grid (ceil(T /
// BK) * B * H * CTAS blocks, clusters of CTAS consecutive blocks:
// launch_walk_tf32, BwdTf32Smem<D, DQ>::BYTES of dynamic shared memory)
// and maps (make_maps<float, D>).
template <int D, bool DQ>
__device__ __forceinline__ void walk_tf32(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    const CUtensorMap& mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    float* __restrict__ dkp, float* __restrict__ dvp, int H, int Hk, int T,
    int bh_layout, float scale, int causal) {
  using S = BwdTf32Smem<D, DQ>;
  constexpr int SLABS = S::SLABS, BK = S::BK, BQ = S::BQ, DC = S::DC;
  constexpr int QTS = S::QT_STAGES;
  constexpr uint32_t HI = desc_hi(S::RB);  // Q, dO, K, V: DESC_HI but D 16
  constexpr bool SPLIT = S::SPLIT, CLUSTER = S::CLUSTER;
  constexpr int DW = SPLIT ? DC / 2 : DC;  // dK / dV columns a warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* kt_full = kv_full + 1;
  uint64_t* q_full = kt_full + 1;
  uint64_t* q_empty = q_full + STAGES;
  uint64_t* qt_full = q_empty + STAGES;
  uint64_t* qt_empty = qt_full + QTS;
  uint64_t* x_full = qt_empty + QTS;  // CLUSTER: the peer's partials landed
  uint64_t* x_empty = x_full + 1;     // CLUSTER: the peer read ours

  // CLUSTER: blocks 2 c and 2 c + 1 are cluster c's two CTAs, this one
  // owning D's columns [c0, c0 + DC)
  const int n_kt = (T + BK - 1) / BK;
  const int kt = CLUSTER ? (blockIdx.x / 2) % n_kt
                         : grid_tile(n_kt);  // tile 0 walks the most q tiles
  const int bh = CLUSTER ? blockIdx.x / 2 / n_kt : grid_bh(n_kt);
  const int rank = CLUSTER ? cluster_ctarank() : 0, c0 = DC * rank;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int k0 = kt * BK;
  const int n_qt = (T + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kt_full, TF32_TRANSPOSERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&q_full[s], 32);  // the producer warp's lanes
      mbar_init(&q_empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < QTS; ++s) {
      mbar_init(&qt_full[s], TF32_TRANSPOSERS);
      mbar_init(&qt_empty[s], 2);
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
    // ---- producer: warp 0 streams K, V and the ring as the 16-bit walk
    // does; warps 1-3 write K^T once (with DQ) and each slot's Q^T and
    // dO^T ----
    setmaxnreg_dec<TF32_PRODUCER_REGS>();
    const int pt = threadIdx.x - 256;
    if (pt < 32) {
      const int lane = pt;
      if (lane == 0) {
        prefetch_map(&mq);
        prefetch_map(&mdo);
        const int2 ck = head_coords(b, hk, Hk, bh_layout);
        mbar_expect_tx(kv_full, 2 * SLABS * S::K_SLAB);
        for (int r = 0; r < SLABS; ++r) {
          tma_load_4d(smem + S::K + r * S::K_SLAB, &mk, kv_full,
                      c0 + 32 * r, ck.x, k0, ck.y);
          tma_load_4d(smem + S::V + r * S::K_SLAB, &mv, kv_full,
                      c0 + 32 * r, ck.x, k0, ck.y);
        }
      }
      const int2 cq = head_coords(b, h, H, bh_layout);
      const float* lse_row = lse + (int64_t)bh * T;
      const float* delta_row = delta + (int64_t)bh * T;
      for (int i = i0; i < n_qt; ++i) {
        const int it = i - i0, s = it % STAGES, q0 = i * BQ;
        mbar_wait(&q_empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* slot = smem + S::RING + s * S::SLOT;
        unsigned char* rows =  // lse, then delta
            CLUSTER ? smem + S::ROWS + s * 2 * BQ * 4 : slot + S::QD;
        float* lse_s = reinterpret_cast<float*>(rows);
        float* delta_s = reinterpret_cast<float*>(rows + BQ * 4);
        for (int t = lane; t < BQ; t += 32) {
          const bool in = q0 + t < T;
          lse_s[t] = in ? lse_row[q0 + t] * LOG2E : 0.f;
          delta_s[t] = in ? delta_row[q0 + t] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&q_full[s], 2 * SLABS * S::Q_SLAB);
          for (int r = 0; r < SLABS; ++r) {
            tma_load_4d(slot + r * S::Q_SLAB, &mq, &q_full[s], c0 + 32 * r,
                        cq.x, q0, cq.y);
            tma_load_4d(slot + S::DO_OFF + r * S::Q_SLAB, &mdo, &q_full[s],
                        c0 + 32 * r, cq.x, q0, cq.y);
          }
        } else {
          mbar_arrive(&q_full[s]);
        }
      }
    } else {
      constexpr int W = TF32_TRANSPOSERS / 32;
      constexpr int Q_UNITS = transpose_tf32_units<BQ, DC>();  // then dO^T's
      const int tw = pt / 32 - 1, lane = pt % 32;
      if constexpr (DQ) {
        mbar_wait(kv_full, 0);
        transpose_tf32<BK, DC, false, W>(smem + S::K, smem + S::KT, tw,
                                         lane);
        fence_proxy_async();
        mbar_arrive(kt_full);
      }
      for (int i = i0; i < n_qt; ++i) {
        const int it = i - i0, s = it % STAGES, qs = it % QTS;
        mbar_wait(&q_full[s], (it / STAGES) & 1);
        mbar_wait(&qt_empty[qs], ((it / QTS) & 1) ^ 1);
        const unsigned char* slot = smem + S::RING + s * S::SLOT;
        unsigned char* qt = smem + S::QT + qs * 2 * S::QT_SLAB;
        transpose_tf32<BQ, DC, true, W>(slot, qt, tw, lane);
        transpose_tf32<BQ, DC, true, W>(slot + S::DO_OFF, qt + S::QT_SLAB,
                                        tw, lane, Q_UNITS);
        fence_proxy_async();
        mbar_arrive(&qt_full[qs]);
      }
    }
    if constexpr (CLUSTER) cluster_sync();  // the consumers' final one
    return;
  }

  // ---- consumers: warpgroup wg owns keys [k0 + kw, k0 + kw + 64) and
  // columns [c0 + cw, c0 + cw + DW) of dK and dV
  setmaxnreg_inc<TF32_CONSUMER_REGS>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int kw = SPLIT ? 0 : 64 * wg, cw = SPLIT ? DW * wg : 0;
  const int key_a = k0 + kw + 16 * warp + lane / 4;  // key_b = +8
  const int col = 2 * (lane % 4);

  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_addr = smem_u32(smem + S::K) + kw * S::RB;
  const uint32_t v_addr = smem_u32(smem + S::V) + kw * S::RB;
  // dq^T = K^T dS^T, this warpgroup's part: SPLIT, d rows [64 wg, 64 wg +
  // 64) of the CTA's over all BQ q; else all 64 d rows over q [16 wg, 16
  // wg + 16)
  constexpr int DQN = SPLIT ? BQ : BQ / 2;  // q columns of the product
  const int dm = SPLIT ? 64 * wg : 0, qn = SPLIT ? 0 : DQN * wg;
  const uint32_t kt_addr = smem_u32(smem + S::KT) + dm * SLAB;
  // CLUSTER: the peer's partials (this warpgroup sends S^T at 0 or dP^T at
  // X_TILE of the peer's buffer) and barriers
  uint32_t x_peer = 0, x_full_peer = 0, x_empty_peer = 0;
  if constexpr (CLUSTER) {
    x_peer = mapa(smem_u32(smem + S::XS), rank ^ 1) + wg * S::X_TILE;
    x_full_peer = mapa(smem_u32(x_full), rank ^ 1);
    x_empty_peer = mapa(smem_u32(x_empty), rank ^ 1);
  }
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
  mbar_wait(kv_full, 0);

  for (int i = i0; i < n_qt; ++i) {
    const int it = i - i0, s = it % STAGES, qs = it % QTS, q0 = i * BQ;
    mbar_wait(&q_full[s], (it / STAGES) & 1);
    unsigned char* slot = smem + S::RING + s * S::SLOT;
    const uint32_t q_addr = smem_u32(slot);
    const uint32_t do_addr = q_addr + S::DO_OFF;
    const unsigned char* rows =  // lse, then delta
        CLUSTER ? smem + S::ROWS + s * 2 * BQ * 4 : slot + S::QD;
    const float* lse_s = reinterpret_cast<const float*>(rows);
    const float* delta_s = reinterpret_cast<const float*>(rows + BQ * 4);
    const bool mask = (causal && q0 < k0 + BK) || q0 + BQ > T || k0 + BK > T;

    if constexpr (S::NARROW) {
      // The tile's shared addresses from a base the compiler cannot hoist
      // out of the loop: at D 32, with one Q^T / dO^T stage and one dS
      // buffer, every descriptor and dS address is loop-invariant, and the
      // compiler kept them all in registers (628 bytes spilled)
      const uint32_t nb = opaque(smem_u32(smem));
      const uint32_t k_at = nb + S::K + kw * S::RB;
      const uint32_t v_at = nb + S::V + kw * S::RB;
      const uint32_t q_at = nb + S::RING + s * S::SLOT;
      const uint32_t do_at = q_at + S::DO_OFF;
      // S^T = K_wg Q^T, then dP^T = V_wg dO^T (64 keys, 128 q, m64n128k8
      // over D / 8 steps), each its own group: P^T's exponentials run
      // while dP^T is formed
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_ss_tf32<HI>(st, desc_k(k_at + 32 * kk), desc_k(q_at + 32 * kk),
                        kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_ss_tf32<HI>(dpt, desc_k(v_at + 32 * kk),
                        desc_k(do_at + 32 * kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      const float sl2 = scale * LOG2E;
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {  // columns c, c + 1 of a key row
        const int key = key_a + 8 * ((e / 2) % 2);
        const int c = 8 * (e / 4) + col;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        float p0 = ex2(fmaf(st[e], sl2, -ls.x));
        float p1 = ex2(fmaf(st[e + 1], sl2, -ls.y));
        if (mask) {
          const int q = q0 + c;
          const bool kin = key < T;
          if (!(kin && q < T && (!causal || key <= q))) p0 = 0.f;
          if (!(kin && q + 1 < T && (!causal || key <= q + 1))) p1 = 0.f;
        }
        st[e] = p0;
        st[e + 1] = p1;
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T from the f32 P^T; then both rounded to TF32 in place: the A
      // fragments of dV += P^T dO and dK += dS^T Q, a k8 block's registers
      // taken in the order {0, 2, 1, 3} (q in the order of Q^T and dO^T)
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {
        const int c = 8 * (e / 4) + col;
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
        dpt[e] = st[e] * (dpt[e] - dl.x) * scale;
        dpt[e + 1] = st[e + 1] * (dpt[e + 1] - dl.y) * scale;
      }
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        st[e] = __uint_as_float(tf32(st[e]));
        dpt[e] = __uint_as_float(tf32(dpt[e]));
      }
      const uint32_t dsn =
          nb + S::DS + (S::DS_BUFS == 2 ? (it & 1) * S::DS_BUF : 0);
      if constexpr (DQ) {
        // dS (q rows, keys K-major) into shared memory for dq = dS K below;
        // with one buffer once the other warpgroup has read the last
        // tile's.  Register 4 j + 2 h + b holds key row h, q column 8 j +
        // col + b: swizzled at (col + b, key) plus 1024 j bytes
        if (S::DS_BUFS == 1 && it > 0) named_barrier(2 + wg, 256);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = kw + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const uint32_t at = dsn + (key / 32) * S::DS_SLAB +
                                swizzle_128b_f32(col + b, key % 32);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j)
              st_shared_f32(at + 1024 * j, dpt[4 * j + 2 * h + b]);
          }
        }
        fence_proxy_async();
      }

      // dV += P^T dO and dK += dS^T Q: B = dO^T and Q^T (D rows of 128 q
      // K-major, four slabs), m64nDk8
      mbar_wait(&qt_full[qs], (it / QTS) & 1);
      const uint32_t qt_addr = nb + S::QT + qs * 2 * S::QT_SLAB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        mma_rs_tf32(dv, __float_as_uint(st[4 * kk]),
                    __float_as_uint(st[4 * kk + 2]),
                    __float_as_uint(st[4 * kk + 1]),
                    __float_as_uint(st[4 * kk + 3]),
                    desc_k(qt_addr + S::QT_SLAB + (kk / 4) * S::QT_SUB +
                           (kk % 4) * 32),
                    1);
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        mma_rs_tf32(dk, __float_as_uint(dpt[4 * kk]),
                    __float_as_uint(dpt[4 * kk + 2]),
                    __float_as_uint(dpt[4 * kk + 1]),
                    __float_as_uint(dpt[4 * kk + 3]),
                    desc_k(qt_addr + (kk / 4) * S::QT_SUB + (kk % 4) * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      // Q, dO, Q^T, dO^T, lse and delta were read last here
      if (tid == 0) {
        mbar_arrive(&qt_empty[qs]);
        mbar_arrive(&q_empty[s]);
      }

      if constexpr (DQ) {
        // both warpgroups' halves of dS are in place, and K^T; this
        // warpgroup's 64 q rows of dq_tile = dS K over all D: A = dS (64 q
        // rows of BK keys), B = K^T (D rows of BK keys), m64nDk8
        named_barrier(1, 256);
        mbar_wait(kt_full, 0);
        const uint32_t ds_addr = dsn + 64 * wg * SLAB;
        const uint32_t ktd_addr = nb + S::KT;
        float dqa[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          mma_ss_tf32(
              dqa, desc_k(ds_addr + (kk / 4) * S::DS_SLAB + (kk % 4) * 32),
              desc_k(ktd_addr + (kk / 4) * S::KT_SLAB + (kk % 4) * 32),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        // the other warpgroup may write the next tile's dS
        if (S::DS_BUFS == 1 && i + 1 < n_qt) named_arrive(2 + (wg ^ 1), 256);
        // added to dq by vector f32 reductions (red.global.add.v2.f32)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * r;
          if (q >= T) continue;
          float* dst = dq + q_base + (int64_t)q * q_rs + col;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * c),
                      make_float2(dqa[4 * c + 2 * r], dqa[4 * c + 2 * r + 1]));
        }
      }
    } else {
      // S^T = K_wg Q^T and dP^T = V_wg dO^T (64 keys, BQ q), m64n32k8 from
      // shared memory, issued back to back
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk) {
        const uint32_t koff = (kk / 4) * S::K_SLAB + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        mma_ss_tf32(st, desc_k(k_addr + koff), desc_k(q_addr + qoff), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk) {
        const uint32_t koff = (kk / 4) * S::K_SLAB + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        mma_ss_tf32(dpt, desc_k(v_addr + koff), desc_k(do_addr + qoff),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      if constexpr (CLUSTER) {
        // partial sums over this CTA's columns: send ours once the peer has
        // read the last tile's, add the peer's once they have landed
        mbar_wait_cluster(x_empty, (it & 1) ^ 1);
        if (wg == 0)
          send_partial(st, x_peer, tid, x_full_peer);
        else
          send_partial(dpt, x_peer, tid, x_full_peer);
        mbar_wait_cluster(x_full, it & 1);
        add_partial(st, smem + S::XS, tid);
        add_partial(dpt, smem + S::XS + S::X_TILE, tid);
        __syncwarp();
        if (lane == 0) {
          // the next tile's bytes are expected before the peer, released
          // here, may send them
          if (tid == 0 && wg == 0 && i + 1 < n_qt)
            mbar_expect_tx(x_full, S::X_BYTES);
          mbar_arrive_cluster(x_empty_peer);
        }
      }

      // P^T and dS^T in f32 (dS^T from the f32 P^T), in place
      const float sl2 = scale * LOG2E;
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {  // columns c and c + 1 of a key row
        const int key = key_a + 8 * ((e / 2) % 2);
        const int c = 8 * (e / 4) + col;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
        float p0 = ex2(fmaf(st[e], sl2, -ls.x));
        float p1 = ex2(fmaf(st[e + 1], sl2, -ls.y));
        if (mask) {
          const int q = q0 + c;
          const bool kin = key < T;
          if (!(kin && q < T && (!causal || key <= q))) p0 = 0.f;
          if (!(kin && q + 1 < T && (!causal || key <= q + 1))) p1 = 0.f;
        }
        st[e] = p0;
        st[e + 1] = p1;
        dpt[e] = p0 * (dpt[e] - dl.x) * scale;
        dpt[e + 1] = p1 * (dpt[e + 1] - dl.y) * scale;
      }
      // their TF32 A fragments: each k8 block of q in the order Q^T and
      // dO^T are written in
      uint32_t pa[BQ / 2], da[BQ / 2];
#pragma unroll
      for (int t = 0; t < BQ / 8; ++t) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * t + (j == 1 ? 2 : j == 2 ? 1 : j);
          pa[4 * t + j] = tf32(st[e]);
          da[4 * t + j] = tf32(dpt[e]);
        }
      }
      unsigned char* ds_buf = smem + S::DS + (it & 1) * S::DS_BUF;
      if constexpr (DQ) {
        // dS (q rows, keys K-major) into shared memory for dq^T = K^T dS^T
        // below, rounded to TF32 (SPLIT: both warpgroups hold all of it,
        // each writes q columns [16 wg, 16 wg + 16))
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          if (SPLIT && (e / 4) / 2 != wg) continue;
          const int key = kw + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
          const int q = 8 * (e / 4) + col + (e % 2);
          *reinterpret_cast<uint32_t*>(
              ds_buf + (key / 32) * S::DS_SLAB +
              swizzle_128b_f32(q, key % 32)) = tf32(dpt[e]);
        }
        fence_proxy_async();
      }

      // dV += P^T dO and dK += dS^T Q: B = dO^T and Q^T (this warpgroup's
      // DW rows of the CTA's columns, BQ q K-major), m64n64k8
      mbar_wait(&qt_full[qs], (it / QTS) & 1);
      const uint32_t qt_addr =
          smem_u32(smem + S::QT + qs * 2 * S::QT_SLAB) + cw * SLAB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        mma_rs_tf32(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                    pa[4 * kk + 3], desc_k(qt_addr + S::QT_SLAB + kk * 32), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        mma_rs_tf32(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                    da[4 * kk + 3], desc_k(qt_addr + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (tid == 0) {
        mbar_arrive(&qt_empty[qs]);
        mbar_arrive(&q_empty[s]);
      }

      if constexpr (DQ) {
        // both warpgroups' parts of dS are in place, and K^T
        named_barrier(1, 256);
        mbar_wait(kt_full, 0);
        const uint32_t ds_addr = smem_u32(ds_buf) + qn * SLAB;
        float dqa[DQN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          mma_ss_tf32(
              dqa, desc_k(kt_addr + (kk / 4) * S::KT_SLAB + (kk % 4) * 32),
              desc_k(ds_addr + (kk / 4) * S::DS_SLAB + (kk % 4) * 32), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        // dq^T's (d, q) element added to dq[q, d] (red.global.add.f32)
#pragma unroll
        for (int e = 0; e < DQN / 2; ++e) {
          const int d = c0 + dm + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
          const int q = q0 + qn + 8 * (e / 4) + col + (e % 2);
          if (q < T) atomicAdd(dq + q_base + (int64_t)q * q_rs + d, dqa[e]);
        }
      }
    }
  }

  // dK / dV partials of this warpgroup's 64 keys and DW columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= T) continue;
    const int64_t off = q_base + (int64_t)key * q_rs + c0 + cw + col;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c) {
      *reinterpret_cast<float2*>(dkp + off + 8 * c) =
          make_float2(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
      *reinterpret_cast<float2*>(dvp + off + 8 * c) =
          make_float2(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
    }
  }
  if constexpr (CLUSTER) cluster_sync();  // the peer writes here no more
}

// Launch a walk_tf32<D, DQ> kernel on its grid: B * H * ceil(T / BK)
// CTA tiles, at D 256 as clusters of two CTAs.  `args` are the kernel's
// parameters, converted to their types.
template <int D, bool DQ, typename... Params>
int launch_walk_tf32(void (*kernel)(Params...), int B, int H, int T,
                     cudaStream_t stream, std::remove_cv_t<Params>... args) {
  using S = BwdTf32Smem<D, DQ>;
  const int tiles = (T + S::BK - 1) / S::BK;
  if (!ptt::grid_fits(tiles * S::CTAS, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  int e = ptt::allow_smem(kernel, S::BYTES);
  if (e) return e;
  if constexpr (S::CLUSTER)
    return launch_clusters(kernel, tiles * S::CTAS * B * H, THREADS,
                           S::BYTES, S::CTAS, stream, args...);
  kernel<<<tiles * B * H, THREADS, S::BYTES, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd_sm90
}  // namespace ptt
