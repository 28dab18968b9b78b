// Flash-attention forward for Hopper: bf16 or fp16 in, f32 accumulate,
// head dim 64, 128 or 256, causal or not, GQA, either layout.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _fwd_kernel (pallas_call in _flash_fwd) for bf16 and fp16 at D in {64,
// 128, 256}; the WMMA kernel flash_fwd.cu keeps f32 and D 16/32.  It
// computes what that kernel computes: per (batch, q head) o = softmax(q
// k^T * scale) v with an online softmax, and lse = m + log(l) as a
// natural log, reading kv head h / (H / Hk).
//
// Bound on the H100: tensor-core operations (at B2 T2048 H16 D128 causal,
// 34.4 GFLOP against 67 MB).  Design, FlashAttention-3 style:
//  - one CTA per (128-row q tile, q head), longest causal rows first;
//    three warpgroups.  Warp 0 of the last one is the producer: it loads
//    Q once, then streams BK-row K and V tiles through a ring of
//    STAGES slots by TMA, each slot guarded by a "full" and an "empty"
//    mbarrier.  The two consumer warpgroups own 64 q rows each;
//    setmaxnreg moves registers from the producer to them.
//  - BK = 128 keys at D 64 and 128.  At D 256 a 128-key K + V stage is
//    128 KB, and two of them beside the 64 KB Q tile pass the 227 KB a
//    block may have: BK = 64 there (64 KB a stage, 192 KB in all), and
//    on the causal walk warpgroup 0 skips the last key tile, which lies
//    wholly after its rows.  The O accumulator (64 x 256 f32, 128
//    registers a thread) takes two m64n128k16 products per k16 step of
//    P V, one per half of D.
//  - S = Q K^T by wgmma m64nBKk16 from shared memory; the online softmax
//    runs in the accumulator registers (each row's max and sum over its
//    quad of lanes, exp2 with scale * log2(e) folded in, the mask only on
//    the diagonal tiles and the ragged tail);
//  - P stays in registers: converted to E it is the A operand of
//    O += P V (V from shared memory, MN-major).  Nothing goes through a
//    shared-memory scratch.
//  - o / l is written in E and lse in f32, rows at or past T skipped;
//    TMA zero-fills the tiles past T, so the host pads nothing.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt::sm90;

constexpr int BQ = 128, SLAB = 128;  // rows; bytes per slab row
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D> struct FwdSmem {
  static constexpr int SLABS = D / 64;
  static constexpr int BK = D == 256 ? 64 : 128;  // key rows a tile
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int Q_SLAB = BQ * SLAB, KV_SLAB = BK * SLAB;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  static constexpr int Q = 0;
  static constexpr int K = Q + SLABS * Q_SLAB;  // slot s at K + s * KV_TILE
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;
  // q_full, kv_full[STAGES], kv_empty[STAGES]; 1024 bytes of slack to
  // align the dynamic shared memory to the swizzle's 1024-byte period
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Columns [64 N i, 64 N (i + 1)) of a 64 x D accumulator (d[32 N i ..]),
// as the accumulator of a 64 x 64 N product.
template <int N, int M>
__device__ __forceinline__ float (&part(float (&d)[M], int i))[N] {
  return *reinterpret_cast<float(*)[N]>(d + N * i);
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      E* __restrict__ o, float* __restrict__ lse, int H,
                      int Hk, int T, int bh_layout, float scale,
                      int causal) {
  using S = FwdSmem<D>;
  constexpr int STAGES = S::STAGES, SLABS = S::SLABS, BK = S::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - ptt::grid_tile(n_qt);  // longest causal rows first
  const int bh = ptt::grid_bh(n_qt);
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = qt * BQ;
  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (qt + 1) * (BQ / BK));

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
      prefetch_map(&mq);
      prefetch_map(&mk);
      prefetch_map(&mv);
      const int2 cq = head_coords(b, h, H, bh_layout);
      const int2 ck = head_coords(b, hk, Hk, bh_layout);
      mbar_expect_tx(q_full, SLABS * S::Q_SLAB);
      for (int r = 0; r < SLABS; ++r)
        tma_load_4d(smem + S::Q + r * S::Q_SLAB, &mq, q_full, 64 * r, cq.x,
                    q0, cq.y);
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

  // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row_a = q0 + 64 * wg + 16 * warp + lane / 4;  // row_b = +8
  const int col = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (scaled, log2 units) and this thread's part of the sum
  float m[2] = {ptt::NEG_INF, ptt::NEG_INF}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_u32(smem + S::Q) + 64 * wg * SLAB;
  // the key tiles this warpgroup reads: with BK < BQ, on the causal walk
  // warpgroup 0's rows end before the last tile starts
  int n_kt_wg = n_kt;
  if constexpr (BK < BQ)
    if (causal) n_kt_wg = min(n_kt, (q0 + 64 * wg + 64 + BK - 1) / BK);
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kt_wg; ++j) {
    const int s = j % STAGES;
    mbar_wait(&kv_full[s], (j / STAGES) & 1);
    const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV_TILE);
    const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV_TILE);

    // S = Q K^T: (64, BK) f32
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * S::Q_SLAB + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * S::KV_SLAB + (kk % 4) * 32;
      mma_ss<E, 0, 0>(sc, desc_k(q_addr + off), desc_k(k_addr + koff),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask: keys past T, and keys after the row on the diagonal tiles
    // (the last BQ / BK of the causal walk)
    if ((causal && (BK == BQ ? j == n_kt - 1 : j >= n_kt - BQ / BK)) ||
        (j + 1) * BK > T) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = j * BK + 8 * (i / 4) + col + (i % 2);
        const int row = row_a + 8 * ((i / 2) % 2);
        if (key >= T || (causal && key > row)) sc[i] = ptt::NEG_INF;
      }
    }

    // online softmax over the two rows this thread holds a quarter of
    float mx[2] = {ptt::NEG_INF, ptt::NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = ex2(fmaf(sc[i], sl2, neg_m[r]));
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += P V: P as E A fragments, V (BK keys, D) MN-major; at D 256
    // one product per half of D (two slabs, LBO = a slab)
    uint32_t pa[BK / 4];
#pragma unroll
    for (int t = 0; t < BK / 4; ++t) pa[t] = pack<E>(sc[2 * t], sc[2 * t + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (D == 256) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_rs<E, 1>(part<64>(acc, n), pa[4 * kk], pa[4 * kk + 1],
                       pa[4 * kk + 2], pa[4 * kk + 3],
                       desc(v_addr + 2 * n * S::KV_SLAB + kk * 16 * SLAB,
                            S::KV_SLAB), 1);
      } else {
        mma_rs<E, 1>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     desc(v_addr + kk * 16 * SLAB, S::KV_SLAB), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&kv_empty[s]);
  }

  // epilogue: o / l in E, lse = (m + log2 l) ln 2
  int64_t q_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= T) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    E* orow = o + q_base + (int64_t)row * q_rs + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack<E>(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[(int64_t)bh * T + row] = (m[r] + __log2f(l_safe)) * LN2;
  }
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hk, int T, int bh_layout, float scale,
           int causal, cudaStream_t stream) {
  constexpr int BK = FwdSmem<D>::BK;
  CUtensorMap mq, mk, mv;
  int e = make_head_map<E>(&mq, q, D, H, T, B, bh_layout, BQ);
  if (!e) e = make_head_map<E>(&mk, k, D, Hk, T, B, bh_layout, BK);
  if (!e) e = make_head_map<E>(&mv, v, D, Hk, T, B, bh_layout, BK);
  if (e) return e;
  const int bytes = FwdSmem<D>::BYTES, tiles = (T + BQ - 1) / BQ;
  if (!ptt::grid_fits(tiles, B * H))
    return static_cast<int>(cudaErrorInvalidValue);
  e = ptt::allow_smem(flash_fwd_sm90_kernel<E, D>, bytes);
  if (e) return e;
  flash_fwd_sm90_kernel<E, D><<<tiles * B * H, THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<E*>(o), lse, H, Hk, T, bh_layout, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_dim(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hk, int T, int D, int bh_layout,
               float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 64: return launch<E, 64>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                  scale, causal, s);
    case 128: return launch<E, 128>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
    case 256: return launch<E, 256>(q, k, v, o, lse, B, H, Hk, T, bh_layout,
                                    scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As flash_fwd (flash_fwd.cu) for bf16 (dtype 1) and fp16 (dtype 2) at D
// in {64, 128, 256}; any other dtype or head dim is
// cudaErrorInvalidValue.  q, k, v, o 16-byte aligned.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int Hk,
                              int T, int D, int bh_layout, float scale,
                              int causal, int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::BF16)
    return launch_dim<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, T, D,
                                     bh_layout, scale, causal, s);
  if (dtype == ptt::F16)
    return launch_dim<__half>(q, k, v, o, lse, B, H, Hk, T, D, bh_layout,
                              scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
