// dq kernel of the two-kernel flash-attention backward, bf16, fp16 or f32
// in, f32 accumulate, dq in the inputs' type.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (the first pallas_call of _flash_bwd), which the JAX
// backward runs with _bwd_dkv_kernel (flash_bwd_dkv.cu here) once the
// fused kernel's (T, D) f32 dq no longer fits its VMEM budget.  Per
// (q tile, q head) it recomputes, for each k tile up to the diagonal,
//   s = Q K^T * scale,  p = exp(s - lse),  dp = dO V^T,
//   ds = p * (dp - delta) * scale,
// and accumulates dq = sum_j ds[i, j] K[j]: three products per tile.
//
// Deterministic: every dq element is summed by one warp in a fixed order
// (k tile by k tile, 16 keys at a time inside the tensor-core product)
// and written once.  There are no atomics, so dq is bit-identical from
// run to run, unlike the fused kernel's (flash_bwd.cu), whose dq sums
// with f32 atomics in an order that changes between runs.
//
// Bound on the H100: tensor-core operations.  At B1 T16384 H16 D128
// causal the three products are 6 * B*H * T(T+1)/2 * D = 1.65 TFLOP,
// about 1.67 ms at 989 TFLOP/s bf16, against about 0.14 GB of q/k/v/dO,
// lse, delta and dq (0.04 ms at 3.35 TB/s).  Design: one 128-thread CTA
// per (64-row q tile, q head), the longest causal rows first.  Q and dO
// are loaded once; K and V tiles of 64 rows are staged in shared memory
// from kv head h / (H / Hk), so no repeated K/V exists.  Each of the four
// warps owns 16 q rows and keeps its dq rows in WMMA f32 accumulators
// for the whole walk; s and dp go through a per-warp f32 scratch, where
// each lane computes p and ds for half of one row in f32 and stores ds
// in the inputs' type for the ds K product (bf16 m16n16k16; f32 inputs
// as TF32 m16n16k8).  Rows at or past T read as zero and their p is
// forced to 0; dq rows past T are never written.  Head dims 16, 32, 64,
// 128 and 256 (f32 at D 256 on 32-row tiles, see ptt::tile_rows).  The
// route (ops/flash_attention.py SM90_RULE) sends only f32 at D 16/32
// here; bf16 and fp16 at every D and f32 at D 64/128/256 run
// flash_bwd_dq_sm90.cu, and these instantiations stay as the yardstick it
// is timed against (the wrappers' kernel=).
#include "common.cuh"

using namespace nvcuda;

namespace {

// BQ q rows (16 a warp) and BK key rows a tile
template <typename E, int D, int BQ_ = ptt::tile_rows<E, D>(), int BK_ = BQ_>
struct DqSmem {
  static constexpr int BQ = BQ_, BK = BK_, WARPS = BQ / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDF = BK + 4;  // f32 (16, BK) scratch
  static constexpr int LDD = D + ptt::pad<E>();   // q / dO / k / v tiles
  static constexpr int LDS = BK + ptt::pad<E>();  // ds rows
  static constexpr int LDQ = D + 4;               // f32 (16, D) dq rows
  // per-warp f32 scratch: s and dp, at the end the warp's dq rows
  static constexpr int F_WARP = (2 * 16 * LDF > 16 * LDQ) ? 2 * 16 * LDF
                                                          : 16 * LDQ;
  static constexpr int TILE = ptt::align128(BQ * LDD * sizeof(E));
  static constexpr int Q = 0;
  static constexpr int DO = Q + TILE;
  static constexpr int K = DO + TILE;
  static constexpr int V = K + TILE;
  static constexpr int DS = V + TILE;
  static constexpr int F = DS + ptt::align128(WARPS * 16 * LDS * sizeof(E));
  static constexpr int LSE = F + WARPS * F_WARP * 4;
  static constexpr int DELTA = LSE + BQ * 4;
  static constexpr int BYTES = DELTA + BQ * 4;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

template <typename E, int D>
__global__ void __launch_bounds__(DqSmem<E, D>::THREADS)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, E* __restrict__ dq,
                    int H, int Hk, int T, int bh_layout, float scale,
                    int causal) {
  using S = DqSmem<E, D>;
  using row = wmma::row_major;
  using col = wmma::col_major;
  constexpr int BQ = S::BQ, BK = S::BK, THREADS = S::THREADS;
  constexpr int LDD = S::LDD, LDS = S::LDS, LDQ = S::LDQ, LDF = S::LDF;
  extern __shared__ __align__(128) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem + S::Q);
  E* dOs = reinterpret_cast<E*>(smem + S::DO);
  E* Ks = reinterpret_cast<E*>(smem + S::K);
  E* Vs = reinterpret_cast<E*>(smem + S::V);
  float* lse_s = reinterpret_cast<float*>(smem + S::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + S::DELTA);

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - ptt::grid_tile(n_qt);  // longest causal rows first
  const int bh = ptt::grid_bh(n_qt);               // b * H + q head
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  int64_t q_rs, kv_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
  const int64_t kv_base = ptt::head_base(b, hk, Hk, T, D, bh_layout, &kv_rs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  E* dSw = reinterpret_cast<E*>(smem + S::DS) + warp * 16 * LDS;
  float* Fs = reinterpret_cast<float*>(smem + S::F) + warp * S::F_WARP;
  float* Fdp = Fs + 16 * LDF;

  const int q0 = qt * BQ;
  ptt::load_rows<E, BQ, D, LDD, THREADS>(Qs, q + q_base, q0, T, q_rs);
  ptt::load_rows<E, BQ, D, LDD, THREADS>(dOs, dout + q_base, q0, T, q_rs);
  ptt::load_row_values(lse_s, lse + (int64_t)bh * T, q0, T, BQ);
  ptt::load_row_values(delta_s, delta + (int64_t)bh * T, q0, T, BQ);

  ptt::Acc<E> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // lane -> (q row r of the warp's 16, half of the key columns)
  const int r = lane >> 1, half = lane & 1;
  const int qrow = warp * 16 + r;
  const int qpos = q0 + qrow;
  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    ptt::load_rows<E, BK, D, LDD, THREADS>(Ks, k + kv_base, k0, T, kv_rs);
    ptt::load_rows<E, BK, D, LDD, THREADS>(Vs, v + kv_base, k0, T, kv_rs);
    __syncthreads();

    // s = Q_w K^T and dp = dO_w V^T: (16 q rows, BK), f32
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      ptt::Acc<E> cs, cp;
      wmma::fill_fragment(cs, 0.f);
      wmma::fill_fragment(cp, 0.f);
      ptt::mma_acc<E, row, col>(cs, Qs + warp * 16 * LDD, LDD,
                                Ks + n * 16 * LDD, LDD, D);
      ptt::mma_acc<E, row, col>(cp, dOs + warp * 16 * LDD, LDD,
                                Vs + n * 16 * LDD, LDD, D);
      wmma::store_matrix_sync(Fs + n * 16, cs, LDF, wmma::mem_row_major);
      wmma::store_matrix_sync(Fdp + n * 16, cp, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // p and ds for this lane's BK / 2 key columns of q row r
    const float lse_r = lse_s[qrow], delta_r = delta_s[qrow];
    constexpr int COLS = BK / 2;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int cl = half * COLS + c;
      const int kpos = k0 + cl;
      const bool ok = kpos < T && qpos < T && (!causal || kpos <= qpos);
      const float p = ok ? expf(Fs[r * LDF + cl] * scale - lse_r) : 0.f;
      dSw[r * LDS + cl] =
          ptt::from_f32<E>(p * (Fdp[r * LDF + cl] - delta_r) * scale);
    }
    __syncwarp();

    // dq_w += ds_w K: (16 q rows, D)
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      ptt::mma_acc<E, row, row>(acc[n], dSw, LDS, Ks + n * 16, LDD, BK);
    __syncwarp();  // the next tile's s overwrites the scratch
  }

  // the warp's dq rows, through the scratch, in the inputs' type
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(Fs + n * 16, acc[n], LDQ, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int rw = e / D, cl = e % D;
    const int pos = q0 + warp * 16 + rw;
    if (pos < T)
      dq[q_base + (int64_t)pos * q_rs + cl] =
          ptt::from_f32<E>(Fs[rw * LDQ + cl]);
  }
}

template <typename E, int D> struct Launch {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int H, int Hk, int T, int bh_layout,
                 float scale, int causal, cudaStream_t s) {
    using S = DqSmem<E, D>;
    const int bytes = S::BYTES, tiles = (T + S::BQ - 1) / S::BQ;
    if (!ptt::grid_fits(tiles, B * H))
      return static_cast<int>(cudaErrorInvalidValue);
    int e = ptt::allow_smem(flash_bwd_dq_kernel<E, D>, bytes);
    if (e) return e;
    flash_bwd_dq_kernel<E, D><<<tiles * B * H, S::THREADS, bytes, s>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        static_cast<E*>(dq), H, Hk, T, bh_layout, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q, dout, dq: (B, T, H, D) or (B*H, T, D) contiguous (bh_layout 0 / 1);
// k, v: the same with Hk heads; all of `dtype` (0 float32, 1 bfloat16, 2
// float16), D in {16, 32, 64, 128, 256}.  lse,
// delta: (B*H, T) f32.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H,
                            int Hk, int T, int D, int bh_layout, float scale,
                            int causal, int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  return ptt::dispatch_dtype_dim<Launch>(
      dtype, D, q, k, v, dout, lse, delta, dq, B, H, Hk, T, bh_layout, scale,
      causal, static_cast<cudaStream_t>(stream));
}
