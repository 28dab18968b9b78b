// Flash-attention forward (causal or not, GQA), bf16 or f32 in, f32
// accumulate.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/flash_attention.py::
// _fwd_kernel (pallas_call in _flash_fwd).  Per (batch, q head) row b the
// kernel computes o = softmax(q k^T * scale) v with an online softmax and
// lse = m + log(l), reading kv head h / (H / Hk) of the same batch.
// Which calls reach it (ops/flash_attention.py SM90_RULE): f32 at D 16
// and 32; the Hopper kernel flash_fwd_sm90.cu takes bf16 and fp16 at
// every D and f32 at D 64, 128 and 256.  chip_smoke.py times it beside
// that kernel on the same inputs as its yardstick.
//
// Bound on the H100: tensor-core operations.  At B2 T2048 H16 D128 causal
// the two products are 4 * B*H * T(T+1)/2 * D = 34.4 GFLOP (about 35 us
// at 989 TFLOP/s bf16) against 34 MB of q/k/v/o (about 10 us at
// 3.35 TB/s).  Design, kept simple on purpose: one 128-thread CTA per
// (64-row q tile, q head); each of its four warps owns 16 q rows.  K and
// V tiles of 64 rows are staged in shared memory (f32 at D 256: 32-row q
// and key tiles, two warps, see ptt::tile_rows), s = q k^T and p v run
// on the tensor cores through WMMA fragments with f32 accumulators (bf16
// m16n16k16; f32 inputs as TF32 m16n16k8), and the online softmax
// (running max m, running sum l, NEG_INF masking, the l == 0 guard) runs
// in f32 registers: each lane owns half of one q row.  The k loop stops
// at the diagonal tile, and the tail past T is masked in the kernel (rows
// past T load as zeros and are never stored), so the host pads nothing.
// Head dims 16, 32, 64, 128 and 256.  No TMA, wgmma or pipelining yet:
// the loads and the products do not overlap.
#include "common.cuh"

using namespace nvcuda;

namespace {

// BQ q rows (16 a warp) and BK key rows a tile
template <typename E, int D, int BQ_ = ptt::tile_rows<E, D>(), int BK_ = BQ_>
struct FwdSmem {
  static constexpr int BQ = BQ_, BK = BK_, WARPS = BQ / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDD = D + ptt::pad<E>();   // q / k / v tiles
  static constexpr int LDP = BK + ptt::pad<E>();  // probabilities
  static constexpr int LDF = (BK > D ? BK : D) + 4;  // f32 scratch
  static constexpr int Q = 0;
  static constexpr int K = Q + ptt::align128(BQ * LDD * sizeof(E));
  static constexpr int V = K + ptt::align128(BK * LDD * sizeof(E));
  static constexpr int P = V + ptt::align128(BK * LDD * sizeof(E));
  static constexpr int F = P + ptt::align128(WARPS * 16 * LDP * sizeof(E));
  static constexpr int BYTES = F + WARPS * 16 * LDF * 4;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

template <typename E, int D>
__global__ void __launch_bounds__(FwdSmem<E, D>::THREADS)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o,
                 float* __restrict__ lse, int H, int Hk, int T,
                 int bh_layout, float scale, int causal) {
  using S = FwdSmem<E, D>;
  using row = wmma::row_major;
  using col = wmma::col_major;
  constexpr int BQ = S::BQ, BK = S::BK, THREADS = S::THREADS;
  constexpr int LDD = S::LDD, LDP = S::LDP, LDF = S::LDF, HALF = D / 2;
  constexpr int VEC = 16 / (int)sizeof(E);
  extern __shared__ __align__(128) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem + S::Q);
  E* Ks = reinterpret_cast<E*>(smem + S::K);
  E* Vs = reinterpret_cast<E*>(smem + S::V);

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - ptt::grid_tile(n_qt);  // longest causal rows first
  const int bh = ptt::grid_bh(n_qt);
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  int64_t q_rs, kv_rs;
  const int64_t q_base = ptt::head_base(b, h, H, T, D, bh_layout, &q_rs);
  const int64_t kv_base = ptt::head_base(b, hk, Hk, T, D, bh_layout, &kv_rs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  E* Pw = reinterpret_cast<E*>(smem + S::P) + warp * 16 * LDP;
  float* Fw = reinterpret_cast<float*>(smem + S::F) + warp * 16 * LDF;

  const int q0 = qt * BQ;
  ptt::load_rows<E, BQ, D, LDD, THREADS>(Qs, q + q_base, q0, T, q_rs);

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
    ptt::load_rows<E, BK, D, LDD, THREADS>(Ks, k + kv_base, j * BK, T,
                                           kv_rs);
    ptt::load_rows<E, BK, D, LDD, THREADS>(Vs, v + kv_base, j * BK, T,
                                           kv_rs);
    __syncthreads();

    // s = q_w k^T: (16, BK), f32
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      ptt::Acc<E> c;
      wmma::fill_fragment(c, 0.f);
      ptt::mma_acc<E, row, col>(c, Qs + warp * 16 * LDD, LDD,
                                Ks + n * 16 * LDD, LDD, D);
      wmma::store_matrix_sync(Fw + n * 16, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's BK / 2 columns of row r
    constexpr int COLS = BK / 2;
    float s[COLS];
    float mx = ptt::NEG_INF;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int cl = half * COLS + c;
      const int kpos = j * BK + cl;
      const bool ok = kpos < T && (!causal || kpos <= qpos);
      s[c] = ok ? Fw[r * LDF + cl] * scale : ptt::NEG_INF;
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
      Pw[r * LDP + half * COLS + c] = ptt::from_f32<E>(p);
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
      ptt::Acc<E> c;
      wmma::fill_fragment(c, 0.f);
      ptt::mma_acc<E, row, row>(c, Pw, LDP, Vs + n * 16, LDD, BK);
      wmma::store_matrix_sync(Fw + n * 16, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] += Fw[r * LDF + half * HALF + i];
    __syncwarp();  // the next tile's s overwrites the scratch
  }

  if (qpos < T) {
    const float l_safe = l == 0.f ? 1.f : l;
    E* orow = o + q_base + (int64_t)qpos * q_rs + half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; i += VEC) {
      uint4 u;
      E* e = reinterpret_cast<E*>(&u);
#pragma unroll
      for (int t = 0; t < VEC; ++t) e[t] = ptt::from_f32<E>(acc[i + t] / l_safe);
      *reinterpret_cast<uint4*>(orow + i) = u;
    }
    if (half == 0) lse[(int64_t)bh * T + qpos] = m + logf(l_safe);
  }
}

template <typename E, int D> struct Launch {
  static int run(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Hk, int T, int bh_layout,
                 float scale, int causal, cudaStream_t s) {
    using S = FwdSmem<E, D>;
    const int bytes = S::BYTES, tiles = (T + S::BQ - 1) / S::BQ;
    if (!ptt::grid_fits(tiles, B * H))
      return static_cast<int>(cudaErrorInvalidValue);
    int e = ptt::allow_smem(flash_fwd_kernel<E, D>, bytes);
    if (e) return e;
    flash_fwd_kernel<E, D><<<tiles * B * H, S::THREADS, bytes, s>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<E*>(o), lse, H, Hk, T,
        bh_layout, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q, o: (B, T, H, D) or (B*H, T, D) contiguous (bh_layout 0 / 1); k, v:
// the same with Hk heads; all of `dtype` (0 float32, 1 bfloat16, 2
// float16), D in {16, 32, 64, 128, 256}.  lse:
// (B*H, T) f32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int Hk, int T,
                         int D, int bh_layout, float scale, int causal,
                         int dtype, void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (Hk <= 0 || H % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  return ptt::dispatch_dtype_dim<Launch>(
      dtype, D, q, k, v, o, lse, B, H, Hk, T, bh_layout, scale, causal,
      static_cast<cudaStream_t>(stream));
}
