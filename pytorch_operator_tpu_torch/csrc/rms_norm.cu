// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * w over rows of length
// D, in f32 and in the JAX kernel's order, stored in x's dtype.  x is f32,
// bf16 or fp16; w is any of the three, each read in its own dtype.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/rms_norm.py::_rms_kernel
// (pallas_call in _rms_fwd).
//
// Bound on the H100: bytes.  The function reads x once and writes out once,
// 2 * N * D * sizeof(T) bytes plus D weights; at (4096, 2048) bf16 that is
// 33.6 MB, 10.0 us at 3.35 TB/s, against 34 MFLOP of f32 arithmetic.
//
// rms_norm_sm90_kernel, the kernel every route takes:
//   - Rows in registers.  A group of G warps owns a row (G = 1 up to 8 KB
//     rows: D 4096 at 16 bits, 2048 at f32), each warp a contiguous chunk
//     of at most VPL 16-byte vectors a lane, so x leaves device memory once
//     and is never read again; the sum of squares closes with warp
//     shuffles (G > 1: one f32 a warp through shared memory and a named
//     barrier of the group's warps only; no block-wide barrier after the
//     prologue).
//   - Loads that never stop.  A persistent grid (SMs x resident CTAs,
//     two of 8 warps where their shared memory fits) whose groups walk the
//     rows with a stride.  While a warp reduces, scales and stores the row
//     in its registers, its next S rows (S = 1-4, as many as fit beside
//     the weights) are in flight into a ring of slots in shared memory:
//     1-D TMA bulk copies (cp.async.bulk ... mbarrier::complete_tx) that
//     lane 0 starts, each slot completed on its own mbarrier, moved into
//     the registers when the row is done and refilled at once.  Measured
//     on an H100 at 4096 x 4096 bf16 (scripts/time_rms_norm_trees.py): a
//     double buffer in registers (two warps a row, one row in flight a
//     group while it computed) reached 78 % of the byte bound; a ring that
//     the warps read from shared memory (8 warps an SM) 68 %; this one 84 %.
//   - The weight once per CTA, converted to f32 into shared memory in the
//     prologue, while the first rows are in flight, laid out in planes of
//     float4 so that a warp's reads hit every bank once.
//   - Streaming 16-byte loads and stores (ld/st.global.cs), two rounded
//     values a cvt at 16 bits.
//   - Every N and D.  TMA bulk copies need 16-byte-aligned addresses and
//     sizes that are multiples of 16 bytes: rows that are not (x or out off
//     16 bytes, D * sizeof(T) not a multiple of 16), or whose weights and
//     slots do not fit, take the general body of the same kernel (S = 0):
//     a warp a row, scalar loads, the weight read in its own dtype, and the
//     row read a second time for the scaled store (from L1 or L2: the warp
//     has just read it).  Row offsets are 64-bit.
//
// rms_norm_rowblock_kernel is the design it replaced (one 256-thread block
// a row, a __syncthreads reduction, a second pass over the row, the weight
// in x's dtype from L2 for every row), kept as the yardstick that
// rms_norm_rowblock_fwd launches and no route reaches.
#include "common.cuh"
#include "sm90.cuh"

#include <map>
#include <mutex>
#include <tuple>

namespace {

using ptt::from_f32;
using ptt::to_f32;
using namespace ptt::sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPL = 16;              // vectors a lane holds: 8 KB a warp
constexpr int MAX_SLOTS = 4;
constexpr int HEADER = 256;          // the mbarriers, WARPS * MAX_SLOTS
// dynamic shared memory of a CTA: two a multiprocessor, or one (of the
// 227 KB a block may take, 1 KB left for the static part)
constexpr int SMEM_TWO = 114688, SMEM_ONE = 231424;

__device__ __forceinline__ float load_w(const void* w, int wdtype,
                                        int64_t j) {
  if (wdtype == ptt::F32) return static_cast<const float*>(w)[j];
  if (wdtype == ptt::BF16)
    return to_f32(static_cast<const __nv_bfloat16*>(w)[j]);
  return to_f32(static_cast<const __half*>(w)[j]);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned) by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes of T from f32 values, rounded to nearest even: one cvt a pair
// at 16 bits
template <typename T>
__device__ __forceinline__ uint4 pack_as(const float (&y)[16 / sizeof(T)]) {
  uint4 r;
  uint32_t* u = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same_v<T, float>) {
      u[k] = __float_as_uint(y[k]);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
      u[k] = *reinterpret_cast<const uint32_t*>(&p);
    } else {
      const __half2 p = __floats2half2_rn(y[2 * k], y[2 * k + 1]);
      u[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  return r;
}

// The sum over a group of G warps (named barrier 1 + the group's index),
// the same in every lane; each warp's partial goes through `part`, two
// slots a warp used in turn, so that a warp a row ahead never overwrites
// a partial that its group has not read.
__device__ __forceinline__ float group_sum(float ss, int G, float* part,
                                           int& parity) {
  ss = ptt::warp_sum(ss);
  if (G == 1) return ss;
  const int warp = threadIdx.x / 32, first = warp - warp % G;
  float* p = part + parity * WARPS;
  parity ^= 1;
  if (threadIdx.x % 32 == 0) p[warp] = ss;
  named_barrier(1 + warp / G, 32 * G);
  ss = 0.f;
  for (int g = 0; g < G; ++g) ss += p[first + g];
  return ss;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
rms_norm_sm90_kernel(const T* __restrict__ x, const void* __restrict__ w,
                     int wdtype, T* __restrict__ out, long long N, int D,
                     float eps, int G, int S) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float part[2 * WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t groups = WARPS / G;
  const int64_t stride = (int64_t)gridDim.x * groups;
  int64_t row = (int64_t)blockIdx.x * groups + warp / G;
  int parity = 0;

  if (S == 0) {  // the general body, G = 1
    for (; row < N; row += stride) {
      const T* xr = x + row * D;
      T* outr = out + row * D;
      float ss = 0.f;
      for (int j = lane; j < D; j += 32) {
        const float f = to_f32(xr[j]);
        ss += f * f;
      }
      const float inv = rsqrtf(ptt::warp_sum(ss) / D + eps);
      for (int j = lane; j < D; j += 32)
        outr[j] = from_f32<T>(to_f32(xr[j]) * inv * load_w(w, wdtype, j));
    }
    return;
  }

  // this warp's chunk of a row: vectors [c0, c0 + cv) of nv, cb bytes
  const int nv = D / E, cv = nv / G, c0 = (warp % G) * cv;
  const uint32_t cb = cv * 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * S;
  float4* ws = reinterpret_cast<float4*>(smem + HEADER);
  unsigned char* ring =
      smem + HEADER + (D * 4 + 127) / 128 * 128 + warp * S * cb;
  auto chunk = [&](int64_t r) {
    return reinterpret_cast<const uint4*>(x + r * D) + c0;
  };

  uint4 a[VPL];
  if (row < N) {
    const uint4* p = chunk(row);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (i * 32 + lane < cv) a[i] = __ldcs(p + i * 32 + lane);
  }
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    for (int s = 0; s < S && row + (s + 1) * stride < N; ++s) {
      mbar_expect_tx(&full[s], cb);
      bulk_load(ring + s * cb, chunk(row + (s + 1) * stride), cb, &full[s]);
    }
  }
  // the weight as f32 planes (plane h, vector v: the weights of elements
  // v * E + 4h .. v * E + 4h + 3), while the first rows are in flight
  float* wsf = reinterpret_cast<float*>(ws);
  for (int j = threadIdx.x; j < D; j += THREADS) {
    const int v = j / E, k = j % E;
    wsf[((k / 4) * nv + v) * 4 + k % 4] = load_w(w, wdtype, j);
  }
  __syncthreads();

  // k-th row of this warp in a; slot k % S holds row k + 1, phase k / S
  int s = 0;
  uint32_t phase = 0;
  for (; row < N; row += stride) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (i * 32 + lane < cv) {
        const T* e = reinterpret_cast<const T*>(&a[i]);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float f = to_f32(e[j]);
          ss += f * f;
        }
      }
    }
    const float inv = rsqrtf(group_sum(ss, G, part, parity) / D + eps);
    uint4* o = reinterpret_cast<uint4*>(out + row * D) + c0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = i * 32 + lane;
      if (v < cv) {
        float wf[E];
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          const float4 q = ws[h * nv + c0 + v];
          wf[4 * h] = q.x;
          wf[4 * h + 1] = q.y;
          wf[4 * h + 2] = q.z;
          wf[4 * h + 3] = q.w;
        }
        const T* e = reinterpret_cast<const T*>(&a[i]);
        float y[E];
#pragma unroll
        for (int j = 0; j < E; ++j) y[j] = to_f32(e[j]) * inv * wf[j];
        __stcs(o + v, pack_as<T>(y));
      }
    }
    if (row + stride >= N) break;
    // the next row from its slot, and the slot refilled S rows on
    mbar_wait(&full[s], phase);
    const uint4* xs = reinterpret_cast<const uint4*>(ring + s * cb);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (i * 32 + lane < cv) a[i] = xs[i * 32 + lane];
    __syncwarp();
    const int64_t ahead = row + (S + 1) * stride;
    if (lane == 0 && ahead < N) {
      fence_proxy_async();
      mbar_expect_tx(&full[s], cb);
      bulk_load(ring + s * cb, chunk(ahead), cb, &full[s]);
    }
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
}

// The yardstick: the design rms_norm_sm90_kernel replaced, weight in x's
// dtype.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rms_norm_rowblock_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int D, float eps, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* outr = out + (int64_t)blockIdx.x * D;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < D / VEC; i += THREADS) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ss = ptt::warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < WARPS ? partial[lane] : 0.f;
    v = ptt::warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / D + eps);

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = threadIdx.x; i < D / VEC; i += THREADS) {
      uint4 u = xv[i], gw = wv[i], o;
      const T* e = reinterpret_cast<const T*>(&u);
      const T* ge = reinterpret_cast<const T*>(&gw);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        oe[j] = from_f32<T>(to_f32(e[j]) * inv * to_f32(ge[j]));
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS)
      outr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// CTAs of `fn` (THREADS threads, `smem` bytes of dynamic shared memory)
// resident on one SM of the current device, times the SMs: the
// persistent grid.  Cached, since the launch is on every norm's path.
int resident_grid(const void* fn, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, fn, smem);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_ONE) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                    smem) != cudaSuccess)
    return 0;
  return cache[key] = sms * per_sm;
}

template <typename T>
int launch_sm90(const void* x, const void* w, int wdtype, void* out,
                long long N, int D, float eps, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  // G: the fewest warps (1-8) whose registers hold equal chunks of a row;
  // S: the most slots a warp (1-MAX_SLOTS) that fit beside the weights,
  // two CTAs an SM if they can; else the general body (S = 0)
  const int nv = D / E;
  int G = 1, S = 0;
  while (G < WARPS && nv > G * 32 * VPL) G *= 2;
  if (D % E == 0 && nv % G == 0 && nv <= G * 32 * VPL && aligned16(x) &&
      aligned16(out)) {
    const long long fixed = HEADER + (D * 4LL + 127) / 128 * 128;
    const long long set = (long long)WARPS * (nv / G) * 16;  // a slot each
    for (long long budget : {SMEM_TWO, SMEM_ONE}) {
      S = (int)(budget > fixed ? (budget - fixed) / set : 0);
      if (S >= 1) break;
    }
    if (S > MAX_SLOTS) S = MAX_SLOTS;
  }
  if (S == 0) G = 1;
  const int smem =
      S ? HEADER + (D * 4 + 127) / 128 * 128 + WARPS * S * (nv / G) * 16 : 0;
  const void* fn = reinterpret_cast<const void*>(&rms_norm_sm90_kernel<T>);
  const int grid = resident_grid(fn, smem);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long per_cta = WARPS / G;
  const long long need = (N + per_cta - 1) / per_cta;
  rms_norm_sm90_kernel<T><<<(unsigned)(need < grid ? need : grid), THREADS,
                            smem, s>>>(
      static_cast<const T*>(x), w, wdtype, static_cast<T*>(out), N, D, eps,
      G, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rowblock(const void* x, const void* w, void* out, long long N,
                    int D, float eps, cudaStream_t s) {
  const int vec = (D % (16 / (int)sizeof(T)) == 0) && aligned16(x) &&
                  aligned16(w) && aligned16(out);
  rms_norm_rowblock_kernel<T><<<(unsigned)N, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), D, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

bool valid_dtype(int d) {
  return d == ptt::F32 || d == ptt::BF16 || d == ptt::F16;
}

}  // namespace

// dtype, wdtype: ptt::Dtype (0 = float32, 1 = bfloat16, 2 = float16) of x
// and out, and of w.  x and out are contiguous (N, D), w is (D,).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out,
                            long long N, int D, float eps, int dtype,
                            int wdtype, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  if (!valid_dtype(dtype) || !valid_dtype(wdtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::F32)
    return launch_sm90<float>(x, w, wdtype, out, N, D, eps, s);
  if (dtype == ptt::BF16)
    return launch_sm90<__nv_bfloat16>(x, w, wdtype, out, N, D, eps, s);
  return launch_sm90<__half>(x, w, wdtype, out, N, D, eps, s);
}

// The yardstick (rms_norm_rowblock_kernel): w in x's dtype, N < 2^31.
extern "C" int rms_norm_rowblock_fwd(const void* x, const void* w, void* out,
                                     long long N, int D, float eps,
                                     int dtype, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  if (N > 0x7fffffffLL || !valid_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::F32)
    return launch_rowblock<float>(x, w, out, N, D, eps, s);
  if (dtype == ptt::BF16)
    return launch_rowblock<__nv_bfloat16>(x, w, out, N, D, eps, s);
  return launch_rowblock<__half>(x, w, out, N, D, eps, s);
}
