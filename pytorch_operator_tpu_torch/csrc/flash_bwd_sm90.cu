// Fused flash-attention backward for Hopper (one pass: dq, dk, dv), bf16,
// fp16 or f32 (as TF32) in at head dim 16, 32, 64, 128 or 256, f32
// accumulate, causal or not, GQA, either layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_fused_kernel (pallas_call in _flash_bwd_fused) at every dtype and
// D; the WMMA kernel flash_bwd.cu stays as its yardstick.  Its
// contract is flash_bwd's: dq f32, zeroed by the caller and added to here;
// dk / dv as per-q-head f32 partials that the wrapper sums over each GQA
// group.
//
// Bound on the H100: tensor-core operations (five products: at B2 T2048
// H16 D128 causal 86 GFLOP); at D 32 and 16 the exponentials, one a
// score element (at B2 T2048 H64 D32 causal 268.6 M, 0.069 ms at the
// card's 3.9 T special-function results a second, against 0.087 ms of
// products; at H128 D16 0.138 ms).  Design, FlashAttention-3 style:
//  - one CTA per (128-key tile, q head; 64-key at D 256), key tile 0 (the
//    longest causal walk) first; three warpgroups.  Warp 0 of the last
//    one is the producer: K and V come in once by TMA, then the 64-row
//    (Q, dO) tiles and their lse / delta rows stream through a ring of
//    STAGES slots, each guarded by a "full" and an "empty" mbarrier.
//    The two consumer warpgroups own 64 keys each (at D 256 all 64 keys
//    and half of D each; at D 16/32 128-row q tiles of narrow slabs,
//    flash_bwd_sm90.cuh) and keep dK and dV in wgmma
//    accumulator registers for the whole walk; setmaxnreg moves
//    registers from the producer to them.
//  - per q tile each consumer warpgroup runs
//      S^T = K_wg Q^T, dP^T = V_wg dO^T        (m64n64k16, shared memory,
//                                               issued back to back)
//      P^T = exp2(S^T scale log2 e - lse log2 e) in registers, to E
//      dS^T = P^T (dP^T - delta) scale         from the f32 P^T, to E
//      dV += P^T dO and dK += dS^T Q           (A from registers)
//    writes dS^T to shared memory in E (bf16 or fp16), and after a
//    barrier over both warpgroups forms its half of D of dq_tile = dS K
//    (A and B MN-major), added to dq with vector f32 reductions
//    (red.global.add.v2.f32).
//    S^T and dP^T beside dK / dV keep a consumer thread in the 240
//    registers setmaxnreg gives it (no spill at D = 128 or 256); the two
//    consumer warpgroups run their products interleaved on the SM.
//  - dK and dV are written once, rows at or past T skipped; TMA zero-fills
//    the tiles past T, so the host pads nothing.
// The walk is flash_bwd_sm90.cuh's walk<E, D, DQ> with DQ; the dk/dv kernel
// flash_bwd_dkv_sm90.cu runs it without.  f32 runs walk_tf32<D, DQ>
// (flash_bwd_sm90_tf32_kernel): the same walk on TF32 wgmma with Q^T,
// dO^T and K^T written in shared memory, 32-row q tiles, and dq formed
// as dq^T = K^T dS^T (flash_bwd_sm90.cuh); at D 256 on clusters of two
// CTAs, each owning half of D, that exchange their partial S^T and dP^T
// through shared memory (launch_walk_tf32); at D 16 / 32 on 128-row q
// tiles with dq formed as dS K, each warpgroup 64 q rows over all D.
#include "flash_bwd_sm90.cuh"

namespace {

using namespace ptt::bwd_sm90;

template <typename E, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      float* __restrict__ dkp, float* __restrict__ dvp,
                      int H, int Hk, int T, int bh_layout, float scale,
                      int causal) {
  walk<E, D, true>(mq, mk, mv, mdo, lse, delta, dq, dkp, dvp, H, Hk, T,
                   bh_layout, scale, causal);
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, float* dkp,
           float* dvp, int B, int H, int Hk, int T, int bh_layout,
           float scale, int causal, cudaStream_t stream) {
  Maps m;
  int e = make_maps<E, D>(&m, q, k, v, dout, B, H, Hk, T, bh_layout);
  if (e) return e;
  const int bytes = BwdSmem<D, true>::BYTES,
            tiles = (T + key_tile<D>() - 1) / key_tile<D>();
  if (!ptt::grid_fits(tiles, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_bwd_sm90_kernel<E, D>, bytes);
  if (e) return e;
  flash_bwd_sm90_kernel<E, D><<<tiles * B * H, THREADS, bytes, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, dq, dkp, dvp, H, Hk, T, bh_layout,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_sm90_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, float* __restrict__ dkp,
                           float* __restrict__ dvp, int H, int Hk, int T,
                           int bh_layout, float scale, int causal) {
  walk_tf32<D, true>(mq, mk, mv, mdo, lse, delta, dq, dkp, dvp, H, Hk, T,
                     bh_layout, scale, causal);
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                float* dq, float* dkp, float* dvp, int B, int H, int Hk,
                int T, int bh_layout, float scale, int causal,
                cudaStream_t stream) {
  Maps m;
  int e = make_maps<float, D>(&m, q, k, v, dout, B, H, Hk, T, bh_layout);
  if (e) return e;
  return launch_walk_tf32<D, true>(flash_bwd_sm90_tf32_kernel<D>, B, H, T,
                                   stream, m.q, m.k, m.v, m.dout, lse, delta,
                                   dq, dkp, dvp, H, Hk, T, bh_layout, scale,
                                   causal);
}

template <typename E>
int launch_dim(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, float* dkp,
               float* dvp, int B, int H, int Hk, int T, int D, int bh_layout,
               float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<E, 16>(q, k, v, dout, lse, delta, dq, dkp, dvp, B,
                                  H, Hk, T, bh_layout, scale, causal, s);
    case 32: return launch<E, 32>(q, k, v, dout, lse, delta, dq, dkp, dvp, B,
                                  H, Hk, T, bh_layout, scale, causal, s);
    case 64: return launch<E, 64>(q, k, v, dout, lse, delta, dq, dkp, dvp, B,
                                  H, Hk, T, bh_layout, scale, causal, s);
    case 128: return launch<E, 128>(q, k, v, dout, lse, delta, dq, dkp, dvp,
                                    B, H, Hk, T, bh_layout, scale, causal, s);
    case 256: return launch<E, 256>(q, k, v, dout, lse, delta, dq, dkp, dvp,
                                    B, H, Hk, T, bh_layout, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int ctas_dim(int D, int* ctas) {
  switch (D) {
    case 16: return ctas_per_sm(flash_bwd_sm90_kernel<E, 16>,
                                THREADS, BwdSmem<16, true>::BYTES, ctas);
    case 32: return ctas_per_sm(flash_bwd_sm90_kernel<E, 32>,
                                THREADS, BwdSmem<32, true>::BYTES, ctas);
    case 64: return ctas_per_sm(flash_bwd_sm90_kernel<E, 64>,
                                THREADS, BwdSmem<64, true>::BYTES, ctas);
    case 128: return ctas_per_sm(flash_bwd_sm90_kernel<E, 128>,
                                 THREADS, BwdSmem<128, true>::BYTES, ctas);
    case 256: return ctas_per_sm(flash_bwd_sm90_kernel<E, 256>,
                                 THREADS, BwdSmem<256, true>::BYTES, ctas);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// CTAs a multiprocessor holds of the bf16 (dtype 1) or fp16 (dtype 2)
// kernel at D (chip_smoke.py phase 1 records them).
extern "C" int flash_bwd_sm90_ctas_per_sm(int D, int dtype, int* ctas) {
  if (dtype == ptt::BF16) return ctas_dim<__nv_bfloat16>(D, ctas);
  if (dtype == ptt::F16) return ctas_dim<__half>(D, ctas);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd (flash_bwd.cu) for f32 (dtype 0), bf16 (dtype 1) and fp16
// (dtype 2) at D in {16, 32, 64, 128, 256}; any other dtype or head dim
// is cudaErrorInvalidValue.  q, k, v, dout 16-byte aligned;
// dq zeroed by the caller.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, float* dq, float* dkp,
                              float* dvp, int B, int H, int Hk, int T, int D,
                              int bh_layout, float scale, int causal,
                              int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::F32) {
    if (D == 16)
      return launch_tf32<16>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                             Hk, T, bh_layout, scale, causal, s);
    if (D == 32)
      return launch_tf32<32>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                             Hk, T, bh_layout, scale, causal, s);
    if (D == 64)
      return launch_tf32<64>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                             Hk, T, bh_layout, scale, causal, s);
    if (D == 128)
      return launch_tf32<128>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                              Hk, T, bh_layout, scale, causal, s);
    if (D == 256)
      return launch_tf32<256>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                              Hk, T, bh_layout, scale, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == ptt::BF16)
    return launch_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dkp, dvp,
                                     B, H, Hk, T, D, bh_layout, scale, causal,
                                     s);
  if (dtype == ptt::F16)
    return launch_dim<__half>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                              Hk, T, D, bh_layout, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
