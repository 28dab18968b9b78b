// Flash-attention forward (causal or not, GQA), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _fwd_kernel (pallas_call in _flash_fwd).  Per (batch, q head) row b the
// kernel computes o = softmax(q k^T * scale) v with an online softmax and
// lse = m + log(l), reading kv head h / (H / Hk) of the same batch.
//
// Bound on the H100: tensor-core operations.  At B2 T2048 H16 D128 causal
// the two products are 4 * B*H * T(T+1)/2 * D = 34.4 GFLOP (about 35 us
// at 989 TFLOP/s bf16) against 34 MB of q/k/v/o (about 10 us at
// 3.35 TB/s).  Design, kept simple on purpose: one 128-thread CTA per
// (64-row q tile, q head); each of its four warps owns 16 q rows.  K and
// V tiles of 64 rows are staged in shared memory, s = q k^T and p v run
// on the tensor cores through WMMA 16x16x16 bf16 fragments with f32
// accumulators, and the online softmax (running max m, running sum l,
// NEG_INF masking, the l == 0 guard) runs in f32 registers: each lane
// owns half of one q row.  The k loop stops at the diagonal tile, and the
// tail past T is masked in the kernel (rows past T load as zeros and are
// never stored), so the host pads nothing.  No TMA, wgmma or pipelining
// yet: the loads and the products do not overlap.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int LDP = BK + 8;  // bf16 probabilities, leading dimension

template <int D> struct FwdSmem {
  static constexpr int LDD = D + 8;                     // bf16 tiles
  static constexpr int LDF = (BK > D ? BK : D) + 4;     // f32 scratch
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDD * 2;
  static constexpr int V = K + BK * LDD * 2;
  static constexpr int P = V + BK * LDD * 2;
  static constexpr int F = P + WARPS * 16 * LDP * 2;
  static constexpr int BYTES = F + WARPS * 16 * LDF * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Hk, int T, int bh_layout, float scale,
                 int causal) {
  using S = FwdSmem<D>;
  constexpr int LDD = S::LDD, LDF = S::LDF, HALF = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::V);

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  int64_t q_rs, kv_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
  const int64_t kv_base = ptt::head_base(b, hk, Hk, T, D, bh_layout, &kv_rs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(smem + S::P) +
                      warp * 16 * LDP;
  float* Fw = reinterpret_cast<float*>(smem + S::F) + warp * 16 * LDF;

  const int q0 = qt * BQ;
  ptt::load_rows<BQ, D, LDD, THREADS>(Qs, q + q_base, q0, T, q_rs);

  // lane -> (row r of the warp's 16, half of the columns)
  const int r = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float m = ptt::NEG_INF, l = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < n_kt; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    ptt::load_rows<BK, D, LDD, THREADS>(Ks, k + kv_base, j * BK, T, kv_rs);
    ptt::load_rows<BK, D, LDD, THREADS>(Vs, v + kv_base, j * BK, T, kv_rs);
    __syncthreads();

    // s = q_w k^T: (16, BK), f32
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDD + kk * 16, LDD);
        wmma::load_matrix_sync(bt, Ks + n * 16 * LDD + kk * 16, LDD);
        wmma::mma_sync(c, a, bt, c);
      }
      wmma::store_matrix_sync(Fw + n * 16, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's 32 columns of row r
    constexpr int COLS = BK / 2;
    float s[COLS];
    float mx = ptt::NEG_INF;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = half * COLS + c;
      const int kpos = j * BK + col;
      const bool ok = kpos < T && (!causal || kpos <= qpos);
      s[c] = ok ? Fw[r * LDF + col] * scale : ptt::NEG_INF;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const float p = expf(s[c] - m_new);
      rs += p;
      Pw[r * LDP + half * COLS + c] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
    __syncwarp();

    // p v: (16, D), f32, through the scratch into the lanes' registers
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LDD + n * 16, LDD);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(Fw + n * 16, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] += Fw[r * LDF + half * HALF + i];
    __syncwarp();  // the next tile's s overwrites the scratch
  }

  if (qpos < T) {
    const float l_safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + q_base + (int64_t)qpos * q_rs + half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; i += 8) {
      uint4 u;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t) e[t] = __float2bfloat16(acc[i + t] / l_safe);
      *reinterpret_cast<uint4*>(orow + i) = u;
    }
    if (half == 0) lse[(int64_t)bh * T + qpos] = m + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hk, int T, int bh_layout, float scale,
           int causal, cudaStream_t s) {
  const int bytes = FwdSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), lse, H, Hk, T, bh_layout, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, T, H, D) or (B*H, T, D) contiguous bf16 (bh_layout 0 / 1);
// k, v: the same with Hk heads.  lse: (B*H, T) f32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int Hk, int T,
                         int D, int bh_layout, float scale, int causal,
                         void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, B, H, Hk, T, bh_layout, scale,
                      causal, s);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, B, H, Hk, T, bh_layout, scale,
                       causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
