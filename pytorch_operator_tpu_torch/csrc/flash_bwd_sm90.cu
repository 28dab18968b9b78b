// Fused flash-attention backward for Hopper (one pass: dq, dk, dv), bf16
// in, f32 accumulate, head dim 64 or 128, causal or not, GQA, either
// layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_fused_kernel (pallas_call in _flash_bwd_fused) for bf16 at D in
// {64, 128}; the WMMA kernel flash_bwd.cu keeps f32 and D 16/32.  Its
// contract is flash_bwd's: dq f32, zeroed by the caller and added to here;
// dk / dv as per-q-head f32 partials that the wrapper sums over each GQA
// group.
//
// Bound on the H100: tensor-core operations (five products: at B2 T2048
// H16 D128 causal 86 GFLOP).  Design, FlashAttention-3 style:
//  - one CTA per (128-key tile, q head), key tile 0 (the longest causal
//    walk) first; three warpgroups.  Warp 0 of the last one is the
//    producer: K and V come in once by TMA, then the 64-row (Q, dO) tiles
//    and their lse / delta rows stream through a ring of STAGES slots,
//    each guarded by a "full" and an "empty" mbarrier.  The two consumer
//    warpgroups own 64 keys each and keep dK and dV in wgmma accumulator
//    registers for the whole walk; setmaxnreg moves registers from the
//    producer to them.
//  - per q tile each consumer warpgroup runs, one product at a time
//      S^T = K_wg Q^T                          (m64n64k16, shared memory)
//      P^T = exp2(S^T scale log2 e - lse log2 e) in registers, to bf16
//      dP^T = V_wg dO^T                        (m64n64k16, shared memory)
//      dS^T = P^T (dP^T - delta) scale         in registers, to bf16
//      dV += P^T dO and dK += dS^T Q           (A from registers)
//    writes dS^T to shared memory in bf16, and after a barrier over both
//    warpgroups forms its half of D of dq_tile = dS K (A and B MN-major),
//    added to dq with vector f32 reductions (red.global.add.v2.f32).
//    One accumulator besides dK / dV at a time keeps a consumer thread in
//    the 240 registers setmaxnreg gives it (no spill at D = 128); the two
//    consumer warpgroups run their products interleaved on the SM.
//  - dK and dV are written once, rows at or past T skipped; TMA zero-fills
//    the tiles past T, so the host pads nothing.
// The walk is flash_bwd_sm90.cuh's walk<D, DQ> with DQ; a dk/dv-only
// kernel can run it without.
#include "flash_bwd_sm90.cuh"

namespace {

using namespace ptt::bwd_sm90;

template <int D>
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
  walk<D, true>(mq, mk, mv, mdo, lse, delta, dq, dkp, dvp, H, Hk, T,
                bh_layout, scale, causal);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, float* dkp,
           float* dvp, int B, int H, int Hk, int T, int bh_layout,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  const int Bq = bh_layout ? B * H : B, Bk = bh_layout ? B * Hk : B;
  const int Hq = bh_layout ? 1 : H, Hkv = bh_layout ? 1 : Hk;
  int e = make_map(&mq, q, D, Hq, T, Bq, BQ);
  if (!e) e = make_map(&mdo, dout, D, Hq, T, Bq, BQ);
  if (!e) e = make_map(&mk, k, D, Hkv, T, Bk, BK);
  if (!e) e = make_map(&mv, v, D, Hkv, T, Bk, BK);
  if (e) return e;
  const int bytes = BwdSmem<D, true>::BYTES;
  e = ptt::allow_smem(flash_bwd_sm90_kernel<D>, bytes);
  if (e) return e;
  dim3 grid((T + BK - 1) / BK, B * H);
  flash_bwd_sm90_kernel<D><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, dq, dkp, dvp, H, Hk, T, bh_layout, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As flash_bwd (flash_bwd.cu) for bf16 (dtype 1) at D in {64, 128}; any
// other dtype or head dim is cudaErrorInvalidValue.  q, k, v, dout 16-byte
// aligned; dq zeroed by the caller.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, float* dq, float* dkp,
                              float* dvp, int B, int H, int Hk, int T, int D,
                              int bh_layout, float scale, int causal,
                              int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk || B * H > 65535 || dtype != ptt::BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, dout, lse, delta, dq, dkp, dvp, B, H,
                               Hk, T, bh_layout, scale, causal, s);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dq, dkp, dvp, B,
                                 H, Hk, T, bh_layout, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
