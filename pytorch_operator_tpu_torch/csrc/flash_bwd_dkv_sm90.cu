// dk / dv kernel of the two-kernel flash-attention backward for Hopper:
// bf16, fp16 or f32 (as TF32) in at head dim 16, 32, 64, 128 or 256, f32
// accumulate, causal or not, GQA, either layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (pallas_call at the end of _flash_bwd) at every dtype
// and D; the WMMA kernel flash_bwd_dkv.cu stays as its yardstick.  Its
// contract is flash_bwd_dkv's: per (key tile, q head) it accumulates
//   dk[j] = sum_i dS[i, j]^T Q[i],   dv[j] = sum_i P[i, j]^T dO[i]
// (four products per tile) and writes them once per q head as f32
// partials, which the wrapper sums over each GQA group
// (_reduce_kv_partials).  No atomics.
//
// Bound on the H100: tensor-core operations.  At B1 T16384 H16 D128
// causal the four products are 8 * B*H * T(T+1)/2 * D = 2.20 TFLOP,
// about 2.22 ms at 989 TFLOP/s bf16, against about 0.16 GB of q/k/v/dO,
// lse, delta and the f32 partials (0.05 ms at 3.35 TB/s).  Design: the
// fused Hopper kernel's key-tile walk (flash_bwd_sm90.cuh, walk<E, D,
// DQ>) without the dq product and its reductions: one CTA per (128-key
// tile, 64-key at D 256; q head), a producer warp streaming the (Q, dO)
// tiles (128-row at D 16/32, of narrow slabs) by TMA through an mbarrier
// ring, two consumer warpgroups with dK and dV in wgmma accumulators.
// At D 16/32 the exponentials (one a score element) set the bound, as
// in flash_bwd_sm90.cu.  Being the same walk, its dk and dv are
// bitwise those of flash_bwd_sm90.  Like it, and like the JAX kernel, it
// forms dS from the f32 P.  f32 runs walk_tf32<D, false>
// (flash_bwd_dkv_sm90_tf32_kernel; at D 256 on clusters of two CTAs, at
// D 16 / 32 on 128-row q tiles), bitwise flash_bwd_sm90's f32 dk / dv in
// the same way.
#include "flash_bwd_sm90.cuh"

namespace {

using namespace ptt::bwd_sm90;

template <typename E, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dkp, float* __restrict__ dvp,
                          int H, int Hk, int T, int bh_layout, float scale,
                          int causal) {
  walk<E, D, false>(mq, mk, mv, mdo, lse, delta, nullptr, dkp, dvp, H, Hk,
                    T, bh_layout, scale, causal);
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dkp, float* dvp,
           int B, int H, int Hk, int T, int bh_layout, float scale,
           int causal, cudaStream_t stream) {
  Maps m;
  int e = make_maps<E, D>(&m, q, k, v, dout, B, H, Hk, T, bh_layout);
  if (e) return e;
  const int bytes = BwdSmem<D, false>::BYTES,
            tiles = (T + key_tile<D>() - 1) / key_tile<D>();
  if (!ptt::grid_fits(tiles, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_bwd_dkv_sm90_kernel<E, D>, bytes);
  if (e) return e;
  flash_bwd_dkv_sm90_kernel<E, D><<<tiles * B * H, THREADS, bytes, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, dkp, dvp, H, Hk, T, bh_layout,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dkp,
                               float* __restrict__ dvp, int H, int Hk, int T,
                               int bh_layout, float scale, int causal) {
  walk_tf32<D, false>(mq, mk, mv, mdo, lse, delta, nullptr, dkp, dvp, H, Hk,
                      T, bh_layout, scale, causal);
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                float* dkp, float* dvp, int B, int H, int Hk, int T,
                int bh_layout, float scale, int causal,
                cudaStream_t stream) {
  Maps m;
  int e = make_maps<float, D>(&m, q, k, v, dout, B, H, Hk, T, bh_layout);
  if (e) return e;
  return launch_walk_tf32<D, false>(flash_bwd_dkv_sm90_tf32_kernel<D>, B, H,
                                    T, stream, m.q, m.k, m.v, m.dout, lse,
                                    delta, dkp, dvp, H, Hk, T, bh_layout,
                                    scale, causal);
}

template <typename E>
int launch_dim(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dkp, float* dvp,
               int B, int H, int Hk, int T, int D, int bh_layout, float scale,
               int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<E, 16>(q, k, v, dout, lse, delta, dkp, dvp, B, H,
                                  Hk, T, bh_layout, scale, causal, s);
    case 32: return launch<E, 32>(q, k, v, dout, lse, delta, dkp, dvp, B, H,
                                  Hk, T, bh_layout, scale, causal, s);
    case 64: return launch<E, 64>(q, k, v, dout, lse, delta, dkp, dvp, B, H,
                                  Hk, T, bh_layout, scale, causal, s);
    case 128: return launch<E, 128>(q, k, v, dout, lse, delta, dkp, dvp, B, H,
                                    Hk, T, bh_layout, scale, causal, s);
    case 256: return launch<E, 256>(q, k, v, dout, lse, delta, dkp, dvp, B, H,
                                    Hk, T, bh_layout, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int ctas_dim(int D, int* ctas) {
  switch (D) {
    case 16: return ctas_per_sm(flash_bwd_dkv_sm90_kernel<E, 16>,
                                THREADS, BwdSmem<16, false>::BYTES, ctas);
    case 32: return ctas_per_sm(flash_bwd_dkv_sm90_kernel<E, 32>,
                                THREADS, BwdSmem<32, false>::BYTES, ctas);
    case 64: return ctas_per_sm(flash_bwd_dkv_sm90_kernel<E, 64>,
                                THREADS, BwdSmem<64, false>::BYTES, ctas);
    case 128: return ctas_per_sm(flash_bwd_dkv_sm90_kernel<E, 128>,
                                 THREADS, BwdSmem<128, false>::BYTES, ctas);
    case 256: return ctas_per_sm(flash_bwd_dkv_sm90_kernel<E, 256>,
                                 THREADS, BwdSmem<256, false>::BYTES, ctas);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// CTAs a multiprocessor holds of the bf16 (dtype 1) or fp16 (dtype 2)
// kernel at D (chip_smoke.py phase 1 records them).
extern "C" int flash_bwd_dkv_sm90_ctas_per_sm(int D, int dtype, int* ctas) {
  if (dtype == ptt::BF16) return ctas_dim<__nv_bfloat16>(D, ctas);
  if (dtype == ptt::F16) return ctas_dim<__half>(D, ctas);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_dkv (flash_bwd_dkv.cu) for f32 (dtype 0), bf16 (dtype 1)
// and fp16 (dtype 2) at D in {16, 32, 64, 128, 256}; any other dtype or
// head dim is cudaErrorInvalidValue.  q, k, v, dout
// 16-byte aligned.
extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  float* dkp, float* dvp, int B, int H,
                                  int Hk, int T, int D, int bh_layout,
                                  float scale, int causal, int dtype,
                                  void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::F32) {
    if (D == 16)
      return launch_tf32<16>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk,
                             T, bh_layout, scale, causal, s);
    if (D == 32)
      return launch_tf32<32>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk,
                             T, bh_layout, scale, causal, s);
    if (D == 64)
      return launch_tf32<64>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk,
                             T, bh_layout, scale, causal, s);
    if (D == 128)
      return launch_tf32<128>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk,
                              T, bh_layout, scale, causal, s);
    if (D == 256)
      return launch_tf32<256>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk,
                              T, bh_layout, scale, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == ptt::BF16)
    return launch_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dkp, dvp, B,
                                     H, Hk, T, D, bh_layout, scale, causal, s);
  if (dtype == ptt::F16)
    return launch_dim<__half>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Hk,
                              T, D, bh_layout, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
