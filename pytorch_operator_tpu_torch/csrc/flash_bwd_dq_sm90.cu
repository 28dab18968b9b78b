// dq kernel of the two-kernel flash-attention backward for Hopper: bf16
// in, f32 accumulate, dq in bf16, head dim 64 or 128, causal or not, GQA,
// either layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (the first pallas_call of _flash_bwd) for bf16 at D in
// {64, 128}; the WMMA kernel flash_bwd_dq.cu keeps f32 and D 16/32.  Per
// (q tile, q head) it recomputes, for each key tile up to the diagonal,
//   S = Q K^T,  P = exp(S scale - lse),  dP = dO V^T,
//   dS = P (dP - delta) scale,
// and accumulates dq = sum_j dS K_j: three products per tile.  P stays in
// f32 until dS is formed, as in the JAX kernel; dS is rounded to bf16 for
// its product.
//
// Deterministic: each dq element is summed in one thread's accumulator in
// a fixed order (key tile by key tile) and written once.  There are no
// atomics, so dq is bit-identical from run to run.
//
// Bound on the H100: tensor-core operations.  At B1 T16384 H16 D128
// causal the three products are 6 * B*H * T(T+1)/2 * D = 1.65 TFLOP,
// about 1.67 ms at 989 TFLOP/s bf16, against about 0.14 GB of q/k/v/dO,
// lse, delta and dq (0.04 ms at 3.35 TB/s).  Design, the forward's
// (flash_fwd_sm90.cu):
//  - one CTA per (128-row q tile, q head), longest causal rows first;
//    three warpgroups.  Warp 0 of the last one is the producer: it loads
//    Q and dO once, then streams 64-row K and V tiles of kv head
//    h / (H / Hk) through a ring of STAGES slots by TMA, each slot guarded
//    by a "full" and an "empty" mbarrier.  The two consumer warpgroups
//    own 64 q rows each and hold lse (times log2 e) and delta of their
//    rows in registers; setmaxnreg moves registers from the producer to
//    them.
//  - per key tile each consumer issues S = Q_wg K^T and dP = dO_wg V^T
//    (m64n64k16, shared memory, K-major) back to back and waits once,
//    forms P = exp2(S scale log2 e - lse log2 e) and dS in the
//    accumulator registers (the mask only on the two diagonal tiles and
//    the ragged tail), and packs dS to bf16 pairs: the register A operand
//    of dq += dS K, with K read MN-major from the same ring slot.
//  - dq (64 x D f32 per warpgroup) stays in wgmma accumulator registers
//    for the whole walk: at D = 128 the peak is dq 64 + S 32 + dP 32 f32
//    a thread, within the 240 registers setmaxnreg gives.  It is written
//    once in bf16, rows at or past T skipped; TMA zero-fills the tiles
//    past T, so the host pads nothing.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt::sm90;

constexpr int BQ = 128, BK = 64, SLAB = 128;  // rows; bytes per slab row
constexpr int THREADS = 384, STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct DqSmem {
  static constexpr int SLABS = D / 64;
  static constexpr int Q_SLAB = BQ * SLAB, KV_SLAB = BK * SLAB;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  static constexpr int Q = 0;
  static constexpr int DO = Q + SLABS * Q_SLAB;
  static constexpr int K = DO + SLABS * Q_SLAB;  // slot s at K + s * KV_TILE
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;
  // q_full, kv_full[STAGES], kv_empty[STAGES]; 1024 bytes of slack to
  // align the dynamic shared memory to the swizzle's 1024-byte period
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int Hk,
                         int T, int bh_layout, float scale, int causal) {
  using S = DqSmem<D>;
  constexpr int SLABS = S::SLABS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = qt * BQ;
  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&mk);
      prefetch_map(&mv);
      const int2 cq = head_coords(b, h, H, bh_layout);
      const int2 ck = head_coords(b, hk, Hk, bh_layout);
      mbar_expect_tx(q_full, 2 * SLABS * S::Q_SLAB);
      for (int r = 0; r < SLABS; ++r) {
        tma_load_4d(smem + S::Q + r * S::Q_SLAB, &mq, q_full, 64 * r, cq.x,
                    q0, cq.y);
        tma_load_4d(smem + S::DO + r * S::Q_SLAB, &mdo, q_full, 64 * r,
                    cq.x, q0, cq.y);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        mbar_wait(&kv_empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * S::KV_TILE);
        for (int r = 0; r < SLABS; ++r) {
          tma_load_4d(smem + S::K + s * S::KV_TILE + r * S::KV_SLAB, &mk,
                      &kv_full[s], 64 * r, ck.x, j * BK, ck.y);
          tma_load_4d(smem + S::V + s * S::KV_TILE + r * S::KV_SLAB, &mv,
                      &kv_full[s], 64 * r, ck.x, j * BK, ck.y);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows [q0w, q0w + 64)
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int q0w = q0 + 64 * wg;
  const int row_a = q0w + 16 * warp + lane / 4;  // row_b = +8
  const int col = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;

  // lse (times log2 e) and delta of the two rows this thread holds
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool in = row < T;
    lse2[r] = in ? lse[(int64_t)bh * T + row] * LOG2E : 0.f;
    dl[r] = in ? delta[(int64_t)bh * T + row] : 0.f;
  }

  float acc[D / 2];  // dq
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t q_addr = smem_u32(smem + S::Q) + 64 * wg * SLAB;
  const uint32_t do_addr = smem_u32(smem + S::DO) + 64 * wg * SLAB;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    mbar_wait(&kv_full[s], (j / STAGES) & 1);
    // nothing to add where every key is after every row of this
    // warpgroup (warpgroup 0 on the causal walk's last tile) or every row
    // is past T; the slot is still released below
    if (!((causal && k0 > q0w + 63) || q0w >= T)) {
      const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV_TILE);

      // S = Q_wg K^T and dP = dO_wg V^T: (64 q, 64 keys) f32 each
      float st[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
        mma_ss<0, 0>(st, desc_k(q_addr + qoff), desc_k(k_addr + koff),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
        mma_ss<0, 0>(dp, desc_k(do_addr + qoff), desc_k(v_addr + koff),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dp);

      // dS = P (dP - delta) scale with P in f32, masked past T and, on
      // the diagonal tiles, after the row; bf16 pairs: the A fragments
      const bool mask = (causal && k0 + BK - 1 > q0w) || k0 + BK > T;
      uint32_t da[BK / 4];
#pragma unroll
      for (int t = 0; t < BK / 4; ++t) {
        const int e = 2 * t, r = t % 2;  // columns c and c + 1 of row r
        const int key = k0 + 8 * (t / 2) + col;
        float p0 = ex2(fmaf(st[e], sl2, -lse2[r]));
        float p1 = ex2(fmaf(st[e + 1], sl2, -lse2[r]));
        if (mask) {
          const int row = row_a + 8 * r;
          if (key >= T || (causal && key > row)) p0 = 0.f;
          if (key + 1 >= T || (causal && key + 1 > row)) p1 = 0.f;
        }
        da[t] = pack_bf16(p0 * (dp[e] - dl[r]) * scale,
                          p1 * (dp[e + 1] - dl[r]) * scale);
      }

      // dq += dS K: K (64 keys, D) MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<1>(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                  da[4 * kk + 3], desc(k_addr + kk * 16 * SLAB, S::KV_SLAB),
                  1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (tid == 0) mbar_arrive(&kv_empty[s]);
  }

  // dq in bf16, rows at or past T skipped
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* out = dq + q_base + (int64_t)row * q_rs + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hk, int T, int bh_layout, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int e = make_head_map(&mq, q, D, H, T, B, bh_layout, BQ);
  if (!e) e = make_head_map(&mdo, dout, D, H, T, B, bh_layout, BQ);
  if (!e) e = make_head_map(&mk, k, D, Hk, T, B, bh_layout, BK);
  if (!e) e = make_head_map(&mv, v, D, Hk, T, B, bh_layout, BK);
  if (e) return e;
  const int bytes = DqSmem<D>::BYTES;
  e = ptt::allow_smem(flash_bwd_dq_sm90_kernel<D>, bytes);
  if (e) return e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_sm90_kernel<D><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), H, Hk,
      T, bh_layout, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As flash_bwd_dq (flash_bwd_dq.cu) for bf16 (dtype 1) at D in {64, 128};
// any other dtype or head dim is cudaErrorInvalidValue.  q, k, v, dout,
// dq 16-byte aligned.
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int B, int H,
                                 int Hk, int T, int D, int bh_layout,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk || B * H > 65535 || dtype != ptt::BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, dout, lse, delta, dq, B, H, Hk, T,
                               bh_layout, scale, causal, s);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dq, B, H, Hk, T,
                                 bh_layout, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
