// The key-tile walk shared by the fused backward (flash_bwd.cu) and the
// dk/dv kernel of the two-kernel backward (flash_bwd_dkv.cu).
//
// One 128-thread CTA per (64-key tile, q head) walks the q tiles from the
// diagonal on.  Each of its four warps owns 16 keys and keeps its dk and
// dv rows in WMMA f32 accumulator fragments for the whole walk.  Per q
// tile it recomputes
//   s^T = K_w Q^T,  dp^T = V_w dO^T,
//   p^T = exp(s^T * scale - lse),  ds^T = p^T * (dp^T - delta) * scale,
// and accumulates dv += p^T dO and dk += ds^T Q.  With DQ it also adds
// the q tile's dq rows (ds K over all 64 keys) into an f32 buffer with
// atomicAdd.  dk and dv are written once, per q head (f32 partials); the
// wrapper sums them over each GQA group.  Rows past T are zero in shared
// memory and their p is forced to 0, so nothing past T is read as a
// probability, added into or written.
#pragma once

#include "common.cuh"

namespace ptt {

namespace bwd_kv {

constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int LDF = BQ + 4;  // f32 (16, BQ) scratch, leading dimension

template <typename E, int D> struct Smem {
  static constexpr int LDD = D + pad<E>();   // k / v / q / dO tiles
  static constexpr int LDS = BQ + pad<E>();  // (key, q) tiles: p^T, ds^T
  static constexpr int LDQ = D + 4;          // f32 (16, D) scratch
  // per-warp f32 scratch: s^T and dp^T, later the (16, D) dq / dk / dv rows
  static constexpr int F_WARP = (2 * 16 * LDF > 16 * LDQ) ? 2 * 16 * LDF
                                                          : 16 * LDQ;
  static constexpr int TILE = align128(BK * LDD * sizeof(E));
  static constexpr int K = 0;
  static constexpr int V = K + TILE;
  static constexpr int Q = V + TILE;
  static constexpr int DO = Q + TILE;
  static constexpr int DST = DO + TILE;
  static constexpr int PT = DST + align128(BK * LDS * sizeof(E));
  static constexpr int F = PT + align128(WARPS * 16 * LDS * sizeof(E));
  static constexpr int LSE = F + WARPS * F_WARP * 4;
  static constexpr int DELTA = LSE + BQ * 4;
  static constexpr int BYTES = DELTA + BQ * 4;
};

// Write a warp's (16, D) f32 accumulator rows [row0, row0 + 16) to dst,
// skipping rows at or past T.
template <typename E, int D>
__device__ __forceinline__ void store_key_rows(Acc<E> (&acc)[D / 16],
                                               float* scratch, float* dst,
                                               int64_t row_stride, int row0,
                                               int T, int lane) {
  constexpr int LDQ = Smem<E, D>::LDQ;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], LDQ,
                            wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int row = e / D, col = e % D;
    if (row0 + row < T)
      dst[(int64_t)(row0 + row) * row_stride + col] = scratch[row * LDQ + col];
  }
  __syncwarp();
}

template <typename E, int D, bool DQ>
__device__ __forceinline__ void walk(const E* __restrict__ q,
                                     const E* __restrict__ k,
                                     const E* __restrict__ v,
                                     const E* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dq,
                                     float* __restrict__ dkp,
                                     float* __restrict__ dvp, int H, int Hk,
                                     int T, int bh_layout, float scale,
                                     int causal) {
  using S = Smem<E, D>;
  using row = wmma::row_major;
  using col = wmma::col_major;
  constexpr int LDD = S::LDD, LDS = S::LDS, LDQ = S::LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  E* Ks = reinterpret_cast<E*>(smem + S::K);
  E* Vs = reinterpret_cast<E*>(smem + S::V);
  E* Qs = reinterpret_cast<E*>(smem + S::Q);
  E* dOs = reinterpret_cast<E*>(smem + S::DO);
  E* dSt = reinterpret_cast<E*>(smem + S::DST);
  float* lse_s = reinterpret_cast<float*>(smem + S::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + S::DELTA);

  const int j = blockIdx.x;   // k tile
  const int bh = blockIdx.y;  // b * H + q head
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  int64_t q_rs, kv_rs;
  const int64_t q_base = head_base(b, h, H, T, D, bh_layout, &q_rs);
  const int64_t kv_base = head_base(b, hk, Hk, T, D, bh_layout, &kv_rs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  E* Ptw = reinterpret_cast<E*>(smem + S::PT) + warp * 16 * LDS;
  float* Fs = reinterpret_cast<float*>(smem + S::F) + warp * S::F_WARP;
  float* Fdp = Fs + 16 * LDF;

  const int k0 = j * BK;
  load_rows<E, BK, D, LDD, THREADS>(Ks, k + kv_base, k0, T, kv_rs);
  load_rows<E, BK, D, LDD, THREADS>(Vs, v + kv_base, k0, T, kv_rs);

  Acc<E> dk[D / 16], dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  // lane -> (key row rr of the warp's 16, half of the q columns)
  const int rr = lane >> 1, half = lane & 1;
  const int kpos = k0 + warp * 16 + rr;
  const int n_qt = (T + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;

  for (int i = i0; i < n_qt; ++i) {
    const int q0 = i * BQ;
    __syncthreads();  // every warp is done with the previous q tile
    load_rows<E, BQ, D, LDD, THREADS>(Qs, q + q_base, q0, T, q_rs);
    load_rows<E, BQ, D, LDD, THREADS>(dOs, dout + q_base, q0, T, q_rs);
    load_row_values(lse_s, lse + (int64_t)bh * T, q0, T, BQ);
    load_row_values(delta_s, delta + (int64_t)bh * T, q0, T, BQ);
    __syncthreads();

    // s^T = K_w Q^T and dp^T = V_w dO^T: (16 keys, BQ), f32
#pragma unroll
    for (int n = 0; n < BQ / 16; ++n) {
      Acc<E> cs, cp;
      wmma::fill_fragment(cs, 0.f);
      wmma::fill_fragment(cp, 0.f);
      mma_acc<E, row, col>(cs, Ks + warp * 16 * LDD, LDD, Qs + n * 16 * LDD,
                           LDD, D);
      mma_acc<E, row, col>(cp, Vs + warp * 16 * LDD, LDD, dOs + n * 16 * LDD,
                           LDD, D);
      wmma::store_matrix_sync(Fs + n * 16, cs, LDF, wmma::mem_row_major);
      wmma::store_matrix_sync(Fdp + n * 16, cp, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // p^T and ds^T for this lane's 32 q columns of key row rr
    constexpr int COLS = BQ / 2;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int cl = half * COLS + c;
      const int qpos = q0 + cl;
      const bool ok = qpos < T && kpos < T && (!causal || kpos <= qpos);
      const float p = ok ? expf(Fs[rr * LDF + cl] * scale - lse_s[cl]) : 0.f;
      const float ds = p * (Fdp[rr * LDF + cl] - delta_s[cl]) * scale;
      Ptw[rr * LDS + cl] = from_f32<E>(p);
      dSt[(warp * 16 + rr) * LDS + cl] = from_f32<E>(ds);
    }
    __syncwarp();

    // dv += p^T dO and dk += ds^T Q: (16 keys, D)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      mma_acc<E, row, row>(dv[n], Ptw, LDS, dOs + n * 16, LDD, BQ);
      mma_acc<E, row, row>(dk[n], dSt + warp * 16 * LDS, LDS, Qs + n * 16,
                           LDD, BQ);
    }

    if constexpr (DQ) {
      __syncthreads();  // all four warps' ds^T rows are in dSt

      // dq rows [16 w, 16 w + 16) of this q tile += ds K over all 64 keys
      float* Fq = Fs;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        Acc<E> c;
        wmma::fill_fragment(c, 0.f);
        // ds = (ds^T)^T: column-major A
        mma_acc<E, col, row>(c, dSt + warp * 16, LDS, Ks + n * 16, LDD, BK);
        wmma::store_matrix_sync(Fq + n * 16, c, LDQ, wmma::mem_row_major);
      }
      __syncwarp();
      for (int e = lane; e < 16 * D; e += 32) {
        const int row_ = e / D, col_ = e % D;
        const int qpos = q0 + warp * 16 + row_;
        if (qpos < T)
          atomicAdd(dq + q_base + (int64_t)qpos * q_rs + col_,
                    Fq[row_ * LDQ + col_]);
      }
    }
    __syncwarp();  // the next tile's s^T overwrites the scratch
  }

  // dk / dv partials of this warp's 16 keys, through the scratch
  store_key_rows<E, D>(dk, Fs, dkp + q_base, q_rs, k0 + warp * 16, T, lane);
  store_key_rows<E, D>(dv, Fs, dvp + q_base, q_rs, k0 + warp * 16, T, lane);
}

}  // namespace bwd_kv

}  // namespace ptt
