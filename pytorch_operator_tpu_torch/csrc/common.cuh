// Shared pieces of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// The JAX kernels' mask value (ops/flash_attention.py NEG_INF): large and
// finite, so exp(NEG_INF - m) is 0 and NEG_INF - NEG_INF is 0, never NaN.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [row0, row0 + ROWS) of a (T, D) bf16 matrix whose rows are
// `row_stride` elements apart into shared memory with leading dimension
// LD, 16 bytes per thread per step.  Rows at or past T are written as
// zeros, so the tail of the sequence needs no padding on the host.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int T,
                                          int64_t row_stride) {
  constexpr int CHUNKS = D / 8;  // 8 bf16 = 16 bytes
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(
          src + (int64_t)(row0 + r) * row_stride + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + cc * 8) = val;
  }
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

}  // namespace ptt
