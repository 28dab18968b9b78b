// Shared pieces of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

using namespace nvcuda;

// The JAX kernels' mask value (ops/flash_attention.py NEG_INF): large and
// finite, so exp(NEG_INF - m) is 0 and NEG_INF - NEG_INF is 0, never NaN.
constexpr float NEG_INF = -1e30f;

// The element types the flash kernels take: the C entries' `dtype`
// argument, as rms_norm_fwd's (0 = float32, 1 = bfloat16).
enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory padding of a row: 16 bytes, so consecutive rows start on
// other banks and every WMMA tile pointer stays 32-byte aligned.
template <typename E> constexpr int pad() { return 16 / (int)sizeof(E); }

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// WMMA shapes by element type: bf16 runs m16n16k16 on the bf16 tensor
// cores; f32 runs m16n16k8 in TF32 (10-bit mantissa), both with f32
// accumulators.
template <typename E> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  using In = __nv_bfloat16;
};
template <> struct Mma<float> {
  static constexpr int K = 8;
  using In = wmma::precision::tf32;
};

template <typename E>
using Acc = wmma::fragment<wmma::accumulator, 16, 16, Mma<E>::K, float>;

// c += A B over `depth`, with A (16 x depth) and B (depth x 16) in shared
// memory.  Row-major A(i, d) = a[i * lda + d], column-major a[d * lda + i];
// row-major B(d, n) = b[d * ldb + n], column-major b[n * ldb + d].
template <typename E, typename LayoutA, typename LayoutB>
__device__ __forceinline__ void mma_acc(Acc<E>& c, const E* a, int lda,
                                        const E* b, int ldb, int depth) {
  constexpr int K = Mma<E>::K;
  constexpr bool A_ROW = std::is_same<LayoutA, wmma::row_major>::value;
  constexpr bool B_ROW = std::is_same<LayoutB, wmma::row_major>::value;
#pragma unroll
  for (int d = 0; d < depth; d += K) {
    wmma::fragment<wmma::matrix_a, 16, 16, K, typename Mma<E>::In, LayoutA>
        fa;
    wmma::fragment<wmma::matrix_b, 16, 16, K, typename Mma<E>::In, LayoutB>
        fb;
    wmma::load_matrix_sync(fa, A_ROW ? a + d : a + d * lda, lda);
    wmma::load_matrix_sync(fb, B_ROW ? b + d * ldb : b + d, ldb);
    if constexpr (std::is_same<E, float>::value) {
#pragma unroll
      for (int t = 0; t < fa.num_elements; ++t)
        fa.x[t] = wmma::__float_to_tf32(fa.x[t]);
#pragma unroll
      for (int t = 0; t < fb.num_elements; ++t)
        fb.x[t] = wmma::__float_to_tf32(fb.x[t]);
    }
    wmma::mma_sync(c, fa, fb, c);
  }
}

// Copy rows [row0, row0 + ROWS) of a (T, D) matrix whose rows are
// `row_stride` elements apart into shared memory with leading dimension
// LD, 16 bytes per thread per step.  Rows at or past T are written as
// zeros, so the tail of the sequence needs no padding on the host.
template <typename E, int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_rows(E* dst, const E* src, int row0,
                                          int T_len, int64_t row_stride) {
  constexpr int VEC = 16 / (int)sizeof(E);
  constexpr int CHUNKS = D / VEC;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T_len)
      val = *reinterpret_cast<const uint4*>(
          src + (int64_t)(row0 + r) * row_stride + cc * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + cc * VEC) = val;
  }
}

// Load `n` f32 row values (lse, delta) from src[row0...] into shared
// memory, zeros at or past T.
__device__ __forceinline__ void load_row_values(float* dst, const float* src,
                                                int row0, int T_len, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    dst[t] = row0 + t < T_len ? src[row0 + t] : 0.f;
}

// Offset of row t of head h of batch b, for the two layouts the wrappers
// pass: (B, T, Hx, D) ("bthd", the model's layout) or (B * Hx, T, D)
// ("bh", flash_with_lse's layout).  Returns the offset of row 0 and sets
// the stride between consecutive rows.
__device__ __forceinline__ int64_t head_base(int b, int h, int Hx, int T,
                                             int D, int bh_layout,
                                             int64_t* row_stride) {
  if (bh_layout) {
    *row_stride = D;
    return ((int64_t)b * Hx + h) * T * D;
  }
  *row_stride = (int64_t)Hx * D;
  return ((int64_t)b * T * Hx + h) * D;
}

// Host side: run Launch<E, D>::run(args...) for the element type `dtype` and a
// head dim D in {16, 32, 64, 128}; anything else is cudaErrorInvalidValue.
template <template <typename, int> class Launch, typename... Args>
int dispatch_dtype_dim(int dtype, int D, Args... args) {
#define PTT_DIMS(TYPE)                                                   \
  switch (D) {                                                           \
    case 16: return Launch<TYPE, 16>::run(args...);                      \
    case 32: return Launch<TYPE, 32>::run(args...);                      \
    case 64: return Launch<TYPE, 64>::run(args...);                      \
    case 128: return Launch<TYPE, 128>::run(args...);                    \
  }                                                                      \
  break;
  switch (dtype) {
    case F32: PTT_DIMS(float)
    case BF16: PTT_DIMS(__nv_bfloat16)
  }
#undef PTT_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory above 48 KB must be asked for before the launch.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace ptt
