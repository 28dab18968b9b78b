// Fused flash-attention backward (FlashAttention-2, one pass), bf16 in,
// f32 accumulate.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_fused_kernel (pallas_call in _flash_bwd_fused).  For one
// (k tile, q head) it recomputes p^T = exp(s^T - lse) tile by tile and
// accumulates
//   dv += p^T dO,   dp^T = V dO^T,   ds^T = p^T * (dp^T - delta) * scale,
//   dk += ds^T Q,   dq += ds K,
// five products per tile.  dk and dv are per q head (f32 partials); the
// wrapper sums them over each GQA group.
//
// Bound on the H100: tensor-core operations.  At B2 T2048 H16 D128 causal
// the five products are 10 * B*H * T(T+1)/2 * D = 86 GFLOP, about 87 us
// at 989 TFLOP/s bf16.  Design: one 128-thread CTA per (64-key tile,
// q head) walks the q tiles from the diagonal on; each of its four warps
// owns 16 keys and keeps its dk and dv rows in WMMA f32 accumulator
// fragments for the whole walk.  Q, dO, K and V tiles sit in shared
// memory, the products run on the tensor cores (WMMA 16x16x16 bf16), the
// elementwise p / ds math runs in f32.  On the TPU the grid ran in order
// and dq stayed in VMEM across k tiles; here CTAs of different k tiles
// run at once, so each CTA adds its (64, D) dq tile into an f32 buffer
// with atomicAdd, once per element per q tile (the four warps' key slices
// are summed in one 64-deep product first).  f32 atomics make dq's
// summation order, and so its last bits, change from run to run.  Rows
// past T are zero in shared memory and their p is forced to 0, so no dq
// row past T is ever added into and nothing is written outside [0, T).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int LDS = BQ + 8;   // bf16 (key, q) tiles, leading dimension
constexpr int LDF = BQ + 4;   // f32 (16, BQ) scratch, leading dimension

template <int D> struct BwdSmem {
  static constexpr int LDD = D + 8;
  static constexpr int LDQ = D + 4;  // f32 (16, D) scratch
  // per-warp f32 scratch: s^T and dp^T, later the (16, D) dq / dk / dv rows
  static constexpr int F_WARP = (2 * 16 * LDF > 16 * LDQ) ? 2 * 16 * LDF
                                                          : 16 * LDQ;
  static constexpr int K = 0;
  static constexpr int V = K + BK * LDD * 2;
  static constexpr int Q = V + BK * LDD * 2;
  static constexpr int DO = Q + BQ * LDD * 2;
  static constexpr int DST = DO + BQ * LDD * 2;
  static constexpr int PT = DST + BK * LDS * 2;
  static constexpr int F = PT + WARPS * 16 * LDS * 2;
  static constexpr int LSE = F + WARPS * F_WARP * 4;
  static constexpr int DELTA = LSE + BQ * 4;
  static constexpr int BYTES = DELTA + BQ * 4;
};

// Write a warp's (16, D) f32 accumulator rows [row0, row0 + 16) to dst,
// skipping rows at or past T.
template <int D>
__device__ __forceinline__ void store_key_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* scratch, float* dst, int64_t row_stride, int row0, int T,
    int lane) {
  constexpr int LDQ = BwdSmem<D>::LDQ;
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ dkp, float* __restrict__ dvp, int H,
                 int Hk, int T, int bh_layout, float scale, int causal) {
  using S = BwdSmem<D>;
  constexpr int LDD = S::LDD, LDQ = S::LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::V);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::Q);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + S::DO);
  __nv_bfloat16* dSt = reinterpret_cast<__nv_bfloat16*>(smem + S::DST);
  float* lse_s = reinterpret_cast<float*>(smem + S::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + S::DELTA);

  const int j = blockIdx.x;   // k tile
  const int bh = blockIdx.y;  // b * H + q head
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  int64_t q_rs, kv_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
  const int64_t kv_base = ptt::head_base(b, hk, Hk, T, D, bh_layout, &kv_rs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* Ptw = reinterpret_cast<__nv_bfloat16*>(smem + S::PT) +
                       warp * 16 * LDS;
  float* Fs = reinterpret_cast<float*>(smem + S::F) + warp * S::F_WARP;
  float* Fdp = Fs + 16 * LDF;

  const int k0 = j * BK;
  ptt::load_rows<BK, D, LDD, THREADS>(Ks, k + kv_base, k0, T, kv_rs);
  ptt::load_rows<BK, D, LDD, THREADS>(Vs, v + kv_base, k0, T, kv_rs);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[D / 16], dv[D / 16];
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
    ptt::load_rows<BQ, D, LDD, THREADS>(Qs, q + q_base, q0, T, q_rs);
    ptt::load_rows<BQ, D, LDD, THREADS>(dOs, dout + q_base, q0, T, q_rs);
    for (int t = threadIdx.x; t < BQ; t += THREADS) {
      const bool in = q0 + t < T;
      lse_s[t] = in ? lse[(int64_t)bh * T + q0 + t] : 0.f;
      delta_s[t] = in ? delta[(int64_t)bh * T + q0 + t] : 0.f;
    }
    __syncthreads();

    // s^T = K_w Q^T and dp^T = V_w dO^T: (16 keys, BQ), f32
#pragma unroll
    for (int n = 0; n < BQ / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cs, cp;
      wmma::fill_fragment(cs, 0.f);
      wmma::fill_fragment(cp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bt;
        wmma::load_matrix_sync(a, Ks + warp * 16 * LDD + kk * 16, LDD);
        wmma::load_matrix_sync(bt, Qs + n * 16 * LDD + kk * 16, LDD);
        wmma::mma_sync(cs, a, bt, cs);
        wmma::load_matrix_sync(a, Vs + warp * 16 * LDD + kk * 16, LDD);
        wmma::load_matrix_sync(bt, dOs + n * 16 * LDD + kk * 16, LDD);
        wmma::mma_sync(cp, a, bt, cp);
      }
      wmma::store_matrix_sync(Fs + n * 16, cs, LDF, wmma::mem_row_major);
      wmma::store_matrix_sync(Fdp + n * 16, cp, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // p^T and ds^T for this lane's 32 q columns of key row rr
    constexpr int COLS = BQ / 2;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = half * COLS + c;
      const int qpos = q0 + col;
      const bool ok = qpos < T && kpos < T && (!causal || kpos <= qpos);
      const float p =
          ok ? expf(Fs[rr * LDF + col] * scale - lse_s[col]) : 0.f;
      const float ds = p * (Fdp[rr * LDF + col] - delta_s[col]) * scale;
      Ptw[rr * LDS + col] = __float2bfloat16(p);
      dSt[(warp * 16 + rr) * LDS + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dv += p^T dO and dk += ds^T Q: (16 keys, D)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bm;
        wmma::load_matrix_sync(a, Ptw + kk * 16, LDS);
        wmma::load_matrix_sync(bm, dOs + kk * 16 * LDD + n * 16, LDD);
        wmma::mma_sync(dv[n], a, bm, dv[n]);
        wmma::load_matrix_sync(a, dSt + warp * 16 * LDS + kk * 16, LDS);
        wmma::load_matrix_sync(bm, Qs + kk * 16 * LDD + n * 16, LDD);
        wmma::mma_sync(dk[n], a, bm, dk[n]);
      }
    }
    __syncthreads();  // all four warps' ds^T rows are in dSt

    // dq rows [16 w, 16 w + 16) of this q tile += ds K over all 64 keys
    float* Fq = Fs;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> a;  // ds = (ds^T)^T
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bk;
        wmma::load_matrix_sync(a, dSt + kk * 16 * LDS + warp * 16, LDS);
        wmma::load_matrix_sync(bk, Ks + kk * 16 * LDD + n * 16, LDD);
        wmma::mma_sync(c, a, bk, c);
      }
      wmma::store_matrix_sync(Fq + n * 16, c, LDQ, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * D; e += 32) {
      const int row = e / D, col = e % D;
      const int qpos = q0 + warp * 16 + row;
      if (qpos < T)
        atomicAdd(dq + q_base + (int64_t)qpos * q_rs + col,
                  Fq[row * LDQ + col]);
    }
    __syncwarp();  // the next tile's s^T overwrites the scratch
  }

  // dk / dv partials of this warp's 16 keys, through the scratch
  store_key_rows<D>(dk, Fs, dkp + q_base, q_rs, k0 + warp * 16, T, lane);
  store_key_rows<D>(dv, Fs, dvp + q_base, q_rs, k0 + warp * 16, T, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, float* dkp,
           float* dvp, int B, int H, int Hk, int T, int bh_layout,
           float scale, int causal, cudaStream_t s) {
  const int bytes = BwdSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + BK - 1) / BK, B * H);
  flash_bwd_kernel<D><<<grid, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, dq, dkp, dvp, H,
      Hk, T, bh_layout, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: (B, T, H, D) or (B*H, T, D) contiguous bf16 (bh_layout 0 / 1);
// k, v: the same with Hk heads.  lse, delta: (B*H, T) f32.  dq (zeroed by
// the caller), dkp, dvp: f32 in q's shape; dkp / dvp hold one partial per
// q head.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, float* dq, float* dkp,
                         float* dvp, int B, int H, int Hk, int T, int D,
                         int bh_layout, float scale, int causal,
                         void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H, Hk, T,
                      bh_layout, scale, causal, s);
  if (D == 128)
    return launch<128>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H, Hk, T,
                       bh_layout, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
