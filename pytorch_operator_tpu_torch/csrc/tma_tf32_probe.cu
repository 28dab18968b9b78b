// Whether TMA rounds f32 to TF32 when a tensor map names the data type
// CU_TENSOR_MAP_DATA_TYPE_TFLOAT32.  The f32 Hopper kernels map their
// inputs so (sm90.cuh make_map) to give the operands wgmma reads from
// shared memory the WMMA kernels' rounding (to nearest, ties away); a
// FLOAT32 map copies the bits, and wgmma would drop the low 13 mantissa
// bits.  chip_smoke.py phase 1 copies one 8 x 32 f32 tile through shared
// memory with each type and reports what came back.  Replaces no TPU
// kernel.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt::sm90;

constexpr int COLS = 32, ROWS = 8;

__global__ void tma_tf32_probe_kernel(const __grid_constant__ CUtensorMap map,
                                      float* __restrict__ out) {
  __shared__ alignas(128) float tile[ROWS * COLS];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, sizeof(tile));
    tma_load_4d(tile, &map, &bar, 0, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < ROWS * COLS; i += blockDim.x) out[i] = tile[i];
}

}  // namespace

// Copy the ROWS x COLS f32 tile at `in` to `out` through one TMA load of
// a map of type TFLOAT32 (tf32_map 1) or FLOAT32 (0).
extern "C" int tma_tf32_probe(const float* in, float* out, int tf32_map,
                              void* stream) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[4] = {COLS, 1, ROWS, 1};
  const cuuint64_t strides[3] = {COLS * 4, COLS * 4, ROWS * COLS * 4};
  const cuuint32_t box[4] = {COLS, 1, ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(
      &map,
      tf32_map ? CU_TENSOR_MAP_DATA_TYPE_TFLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<float*>(in), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  tma_tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      map, out);
  return static_cast<int>(cudaGetLastError());
}
