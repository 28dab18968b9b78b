// dk / dv kernel of the two-kernel flash-attention backward, bf16 or f32
// in, f32 accumulate.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (pallas_call at the end of _flash_bwd), the long-T
// partner of flash_bwd_dq.cu.  Per (k tile, q head) it recomputes
// p^T = exp(s^T - lse) and ds^T = p^T * (dp^T - delta) * scale tile by
// tile and accumulates
//   dk[j] = sum_i ds[i, j]^T Q[i],   dv[j] = sum_i p[i, j]^T dO[i],
// four products per tile.  It is the fused kernel's walk
// (flash_bwd_kv.cuh) without the dq product and its atomics.  dk and dv
// are written once per q head as f32 partials; the wrapper sums them over
// each GQA group (_reduce_kv_partials).
//
// Bound on the H100: tensor-core operations.  At B1 T16384 H16 D128
// causal the four products are 8 * B*H * T(T+1)/2 * D = 2.20 TFLOP,
// about 2.22 ms at 989 TFLOP/s bf16, against about 0.16 GB of q/k/v/dO,
// lse, delta and the f32 partials (0.05 ms at 3.35 TB/s).  Design: one
// 128-thread CTA per (64-key tile, q head) walks the q tiles from the
// diagonal on; each of its four warps owns 16 keys and keeps its dk and
// dv rows in WMMA f32 accumulators for the whole walk, the products on
// the tensor cores (bf16 m16n16k16; f32 inputs as TF32 m16n16k8).  Each
// output element is written by one thread, once: no atomics.  Rows past
// T read as zero and their p is forced to 0, so the host pads nothing.
// Head dims 16, 32, 64, 128 and 256 (f32 at D 256 on 32-row tiles, see
// ptt::tile_rows).
#include "flash_bwd_kv.cuh"

namespace {

using namespace ptt::bwd_kv;

template <typename E, int D>
__global__ void __launch_bounds__(Smem<E, D>::THREADS)
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const E* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dkp, float* __restrict__ dvp,
                     int H, int Hk, int T, int bh_layout, float scale,
                     int causal) {
  ptt::bwd_kv::walk<E, D, false>(q, k, v, dout, lse, delta, nullptr, dkp,
                                 dvp, H, Hk, T, bh_layout, scale, causal);
}

template <typename E, int D> struct Launch {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dkp, float* dvp, int B, int H, int Hk, int T,
                 int bh_layout, float scale, int causal, cudaStream_t s) {
    using S = Smem<E, D>;
    const int bytes = S::BYTES, tiles = (T + S::BK - 1) / S::BK;
    if (!ptt::grid_fits(tiles, B * H))
      return static_cast<int>(cudaErrorInvalidValue);
    int e = ptt::allow_smem(flash_bwd_dkv_kernel<E, D>, bytes);
    if (e) return e;
    flash_bwd_dkv_kernel<E, D><<<tiles * B * H, S::THREADS, bytes, s>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        dkp, dvp, H, Hk, T, bh_layout, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q, dout: (B, T, H, D) or (B*H, T, D) contiguous (bh_layout 0 / 1); k,
// v: the same with Hk heads; all of `dtype` (0 float32, 1 bfloat16, 2
// float16), D in {16, 32, 64, 128, 256}.  lse, delta: (B*H, T) f32.  dkp, dvp: f32 in q's
// shape, one partial per q head.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, float* dkp, float* dvp,
                             int B, int H, int Hk, int T, int D,
                             int bh_layout, float scale, int causal,
                             int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  return ptt::dispatch_dtype_dim<Launch>(
      dtype, D, q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk, T, bh_layout,
      scale, causal, static_cast<cudaStream_t>(stream));
}
