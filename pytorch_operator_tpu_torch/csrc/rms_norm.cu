// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * w, in f32, stored
// in x's dtype (bf16 or f32), over rows of length D.
//
// Replaces the TPU kernel pytorch_operator_tpu/ops/rms_norm.py::_rms_kernel
// (pallas_call in _rms_fwd).
//
// Bound on the H100: bytes.  The kernel reads x once and writes out once
// (2 * N * D * sizeof(T) bytes, plus D weights); at (4096, 2048) bf16 that
// is 33.6 MB, about 10 us at 3.35 TB/s, against ~0.03 GFLOP.  Design: one
// 256-thread block per row, 16-byte vector loads where D and the pointers
// allow (scalar loads otherwise, so every N and D is taken), an f32 sum of
// squares reduced across warps in shared memory, then a second pass over
// the row (a 4 KB row is still in L1/L2, so device memory sees x once)
// that scales by rsqrt and w and stores.  The TPU kernel's row-block and
// D <= 2048 limits were VMEM budgets and do not apply here.
#include "common.cuh"

namespace {

constexpr int BLOCK = 256;

using ptt::from_f32;
using ptt::to_f32;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int D, float eps, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* outr = out + (int64_t)blockIdx.x * D;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < D / VEC; i += BLOCK) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += BLOCK) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[BLOCK / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ss = ptt::warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < BLOCK / 32 ? partial[lane] : 0.f;
    v = ptt::warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / D + eps);

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = threadIdx.x; i < D / VEC; i += BLOCK) {
      uint4 u = xv[i], g = wv[i], o;
      const T* e = reinterpret_cast<const T*>(&u);
      const T* ge = reinterpret_cast<const T*>(&g);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        oe[j] = from_f32<T>(to_f32(e[j]) * inv * to_f32(ge[j]));
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += BLOCK)
      outr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and out are contiguous (N, D).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out,
                            long long N, int D, float eps, int dtype,
                            void* stream) {
  if (N <= 0 || D <= 0) return 0;
  if (N > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = (D % (16 / elem) == 0) && aligned16(x) && aligned16(w) &&
                  aligned16(out);
  if (dtype == 0)
    rms_norm_kernel<float><<<(unsigned)N, BLOCK, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), D, eps, vec);
  else
    rms_norm_kernel<__nv_bfloat16><<<(unsigned)N, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), D, eps, vec);
  return static_cast<int>(cudaGetLastError());
}
