// Fused flash-attention backward (FlashAttention-2, one pass), bf16 or
// f32 in, f32 accumulate.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_fused_kernel (pallas_call in _flash_bwd_fused).  For one
// (k tile, q head) it recomputes p^T = exp(s^T - lse) tile by tile and
// accumulates
//   dv += p^T dO,   dp^T = V dO^T,   ds^T = p^T * (dp^T - delta) * scale,
//   dk += ds^T Q,   dq += ds K,
// five products per tile (the walk is flash_bwd_kv.cuh's, with DQ).  dk
// and dv are per q head (f32 partials); the wrapper sums them over each
// GQA group.  Which calls reach it (ops/flash_attention.py SM90_RULE):
// f32 at D 16 and 32; the Hopper kernel flash_bwd_sm90.cu takes bf16 and
// fp16 at every D and f32 at D 64, 128 and 256.
//
// Bound on the H100: tensor-core operations.  At B2 T2048 H16 D128 causal
// the five products are 10 * B*H * T(T+1)/2 * D = 86 GFLOP, about 87 us
// at 989 TFLOP/s bf16.  Design: one 128-thread CTA per (64-key tile,
// q head) walks the q tiles from the diagonal on, the products on the
// tensor cores through WMMA (bf16 m16n16k16; f32 inputs as TF32
// m16n16k8), the elementwise p / ds math in f32.  On the TPU the grid ran
// in order and dq stayed in VMEM across k tiles; here CTAs of different
// k tiles run at once, so each CTA adds its (64, D) dq tile into an f32
// buffer with atomicAdd, once per element per q tile (the four warps' key
// slices are summed in one 64-deep product first).  f32 atomics make dq's
// summation order, and so its last bits, change from run to run; the
// two-kernel route (flash_bwd_dq.cu) has none.  Head dims 16, 32, 64, 128
// and 256 (f32 at D 256 on 32-row tiles, see ptt::tile_rows).
#include "flash_bwd_kv.cuh"

namespace {

using namespace ptt::bwd_kv;

template <typename E, int D>
__global__ void __launch_bounds__(Smem<E, D>::THREADS)
flash_bwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ dkp, float* __restrict__ dvp, int H,
                 int Hk, int T, int bh_layout, float scale, int causal) {
  ptt::bwd_kv::walk<E, D, true>(q, k, v, dout, lse, delta, dq, dkp, dvp, H,
                                Hk, T, bh_layout, scale, causal);
}

template <typename E, int D> struct Launch {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, float* dkp, float* dvp, int B, int H, int Hk,
                 int T, int bh_layout, float scale, int causal,
                 cudaStream_t s) {
    using S = Smem<E, D>;
    const int bytes = S::BYTES, tiles = (T + S::BK - 1) / S::BK;
    if (!ptt::grid_fits(tiles, B * H))
      return static_cast<int>(cudaErrorInvalidValue);
    int e = ptt::allow_smem(flash_bwd_kernel<E, D>, bytes);
    if (e) return e;
    flash_bwd_kernel<E, D><<<tiles * B * H, S::THREADS, bytes, s>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        dq, dkp, dvp, H, Hk, T, bh_layout, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q, dout: (B, T, H, D) or (B*H, T, D) contiguous (bh_layout 0 / 1); k,
// v: the same with Hk heads; all of `dtype` (0 float32, 1 bfloat16, 2
// float16), D in {16, 32, 64, 128, 256}.  lse, delta: (B*H, T) f32.  dq (zeroed by the
// caller), dkp, dvp: f32 in q's shape; dkp / dvp hold one partial per q
// head.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, float* dq, float* dkp,
                         float* dvp, int B, int H, int Hk, int T, int D,
                         int bh_layout, float scale, int causal, int dtype,
                         void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  return ptt::dispatch_dtype_dim<Launch>(
      dtype, D, q, k, v, dout, lse, delta, dq, dkp, dvp, B, H, Hk, T,
      bh_layout, scale, causal, static_cast<cudaStream_t>(stream));
}
