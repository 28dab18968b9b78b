// The key-tile walk of the Hopper flash backward (flash_bwd_sm90.cu).
//
// One CTA per (128-key tile, q head), three warpgroups: the producer warp
// streams the q tiles, the two consumer warpgroups own 64 keys each and
// keep dK and dV in wgmma accumulators (see flash_bwd_sm90.cu).  With DQ
// the walk also forms dq_tile = dS K and adds it to dq; without it the
// walk is a dk/dv-only kernel's, as flash_bwd_kv.cuh's walk<E, D, DQ> is
// for the WMMA kernels.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace ptt {
namespace bwd_sm90 {

using namespace ptt::sm90;

constexpr int BK = 128, BQ = 64, SLAB = 128;  // rows; bytes per slab row
constexpr int THREADS = 384, STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool DQ> struct BwdSmem {
  static constexpr int SLABS = D / 64;
  static constexpr int K_SLAB = BK * SLAB, Q_SLAB = BQ * SLAB;
  static constexpr int K = 0;
  static constexpr int V = K + SLABS * K_SLAB;
  // one ring slot: Q, dO, then lse (times log2 e) and delta, BQ f32 each
  static constexpr int DO_OFF = SLABS * Q_SLAB;
  static constexpr int LSE_OFF = 2 * SLABS * Q_SLAB;
  static constexpr int DELTA_OFF = LSE_OFF + BQ * 4;
  static constexpr int SLOT = (DELTA_OFF + BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int RING = V + SLABS * K_SLAB;
  // with DQ: dS^T (BK keys, BQ q) in bf16, one 128-byte-swizzled slab, in
  // two buffers (a warpgroup may write tile i + 1's while the other still
  // reads tile i's)
  static constexpr int DS = RING + STAGES * SLOT;
  static constexpr int DS_BUF = BK * SLAB;
  static constexpr int BAR = DS + (DQ ? 2 : 0) * DS_BUF;
  // kv_full, q_full[STAGES], q_empty[STAGES]; 1024 bytes of slack to
  // align the dynamic shared memory to the swizzle's 1024-byte period
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// The body of a kernel launched with THREADS threads and
// BwdSmem<D, DQ>::BYTES of dynamic shared memory on a grid of
// (ceil(T / BK), B * H); the maps are the kernel's __grid_constant__
// parameters (q and dO in boxes of BQ rows, k and v of BK rows).
//
// Registers: a consumer thread holds dK and dV (D / 2 f32 each) for the
// whole walk.  Beside them it holds one product's accumulator at a time:
// S^T is reduced to bf16 P^T before dP^T is issued, and dV / dK complete
// before dq_tile is issued, so at D = 128 the peak is 128 + 16 + 32 f32
// (dK, dV, P^T, dP^T) and ptxas fits it without spilling.
template <int D, bool DQ>
__device__ __forceinline__ void walk(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    const CUtensorMap& mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    float* __restrict__ dkp, float* __restrict__ dvp, int H, int Hk, int T,
    int bh_layout, float scale, int causal) {
  using S = BwdSmem<D, DQ>;
  constexpr int SLABS = S::SLABS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + STAGES;

  const int kt = blockIdx.x;  // key tile; tile 0 walks the most q tiles
  const int bh = blockIdx.y;
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

  // ---- consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key_a = k0 + 64 * wg + 16 * warp + lane / 4;  // key_b = +8
  const int col = 2 * (lane % 4);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_addr = smem_u32(smem + S::K) + 64 * wg * SLAB;
  const uint32_t v_addr = smem_u32(smem + S::V) + 64 * wg * SLAB;
  // this warpgroup's half of D of K, for dq = dS K: a slab at D = 128,
  // half of the one slab's row at D = 64
  const uint32_t kh_addr =
      smem_u32(smem + S::K) + (SLABS == 2 ? wg * S::K_SLAB : wg * 64);
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

    // P^T = exp2(S^T scale log2 e - lse log2 e) from S^T = K_wg Q^T (64
    // keys, 64 q), rounded to bf16 pairs: the A fragments of dV += P^T dO
    uint32_t pa[BQ / 4];
    {
      float st[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / 4) * S::K_SLAB + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        mma_ss<0, 0>(st, desc_k(k_addr + koff), desc_k(q_addr + qoff),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
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
        pa[t] = pack_bf16(p0, p1);
      }
    }
    // dS^T = P^T (dP^T - delta) scale from dP^T = V_wg dO^T, in bf16 pairs
    uint32_t da[BQ / 4];
    {
      float dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / 4) * S::K_SLAB + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        mma_ss<0, 0>(dpt, desc_k(v_addr + koff), desc_k(do_addr + qoff),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int t = 0; t < BQ / 4; ++t) {
        const int e = 2 * t;
        const float2 dl =
            *reinterpret_cast<const float2*>(delta_s + 8 * (e / 4) + col);
        const float2 p = unpack_bf16(pa[t]);
        da[t] = pack_bf16(p.x * (dpt[e] - dl.x) * scale,
                          p.y * (dpt[e + 1] - dl.y) * scale);
      }
    }
    unsigned char* ds_buf = smem + S::DS + (it & 1) * S::DS_BUF;
    if constexpr (DQ) {
      // dS^T into shared memory for dq_tile = dS K below
#pragma unroll
      for (int t = 0; t < BQ / 4; ++t) {
        const int e = 2 * t;
        const int r = 64 * wg + 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
        *reinterpret_cast<uint32_t*>(
            ds_buf + swizzle_128b(r, 8 * (e / 4) + col)) = da[t];
      }
      fence_proxy_async();
    }

    // dV += P^T dO and dK += dS^T Q: dO and Q (64 q, D) MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<1>(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                pa[4 * kk + 3], desc(do_addr + kk * 16 * SLAB, S::Q_SLAB), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<1>(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                da[4 * kk + 3], desc(q_addr + kk * 16 * SLAB, S::Q_SLAB), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);

    if constexpr (DQ) {
      // both warpgroups' halves of dS^T are in place
      named_barrier(1, 256);
      // this warpgroup's half of D of dq_tile = dS K: A = dS (64 q, 128
      // keys) read from dS^T (MN-major), B = K (128 keys, D / 2) MN-major
      float dqa[D / 4];
      const uint32_t ds_addr = smem_u32(ds_buf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_ss<1, 1>(dqa, desc(ds_addr + kk * 16 * SLAB, S::DS_BUF),
                     desc(kh_addr + kk * 16 * SLAB, S::K_SLAB), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      if (tid == 0) mbar_arrive(&q_empty[s]);

      // added to dq by vector f32 reductions (red.global.add.v2.f32)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 16 * warp + lane / 4 + 8 * r;
        if (q >= T) continue;
        float* dst = dq + q_base + (int64_t)q * q_rs + (D / 2) * wg + col;
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
          atomicAdd(reinterpret_cast<float2*>(dst + 8 * c),
                    make_float2(dqa[4 * c + 2 * r], dqa[4 * c + 2 * r + 1]));
      }
    } else {
      if (tid == 0) mbar_arrive(&q_empty[s]);
    }
  }

  // dK / dV partials of this warpgroup's 64 keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= T) continue;
    const int64_t off = q_base + (int64_t)key * q_rs + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(dkp + off + 8 * c) =
          make_float2(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
      *reinterpret_cast<float2*>(dvp + off + 8 * c) =
          make_float2(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
    }
  }
}

}  // namespace bwd_sm90
}  // namespace ptt
