// Hopper (sm_90a) building blocks of the port's flash kernels: mbarriers,
// TMA tensor loads, wgmma descriptors and instructions, warp-specialisation
// helpers, and the host-side tensor maps.
//
// The one layout every piece agrees on: a 64-column bf16 slab of a tile in
// shared memory, 128 bytes per row, 128-byte swizzled (16-byte chunk c of
// row r sits at chunk c ^ (r % 8)), slabs 1024-byte aligned.  TMA writes it
// (CU_TENSOR_MAP_SWIZZLE_128B with a 64-column box), the wgmma descriptors
// read it (layout type 1, 8-row groups 1024 bytes apart), and the
// backward's register-to-shared stores of dS^T write it by hand
// (swizzle_128b below).  A (rows, D) tile with D = 128 is two such slabs.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {
namespace sm90 {

// ---------------------------------------------------------------------------
// shared-memory addresses, barriers, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) (c < 64) in a 128-byte-swizzled bf16 slab.
__device__ __forceinline__ uint32_t swizzle_128b(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once: producers wait
// on their "empty" barriers with parity (use & 1) ^ 1, consumers on the
// "full" ones with use & 1, where `use` counts a stage's previous fills.
// A wrong parity spins forever.  The loop lives in the asm: as a C++ loop
// (with a clock and a __trap after a time limit) it made ptxas serialize
// the backward's wgmmas and spill its dK / dV accumulators at D = 128.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Grow (consumers) or shrink (producer) this warpgroup's registers.
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Load box (c0.., c1, c2.., c3) of a 4-D tensor map into shared memory at
// `dst`, completing `bytes` on `bar`.  Elements past the tensor's extent
// arrive as zeros (and still count as transaction bytes).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at byte
// address `addr`.  K-major (K contiguous): rows 8 apart are 1024 bytes
// apart (SBO); LBO is unused; one k16 step moves `addr` by 32 bytes.
// MN-major (M or N contiguous, the transpose bit set): 8-deep groups of K
// are 1024 bytes apart (SBO) and 64-wide blocks of M/N are `lbo` bytes
// apart; one k16 step moves `addr` by 2048 bytes.  Only the low word
// (start address >> 4, LBO >> 4) varies; the high word (SBO >> 4, layout
// type 1 = 128-byte swizzle) is DESC_HI for every operand here.  The
// wrappers below pack the two inside their asm, so a descriptor waiting
// for its wgmma holds one register, not two.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);
struct Desc {
  uint32_t lo;
};
__device__ __forceinline__ Desc desc(uint32_t addr, uint32_t lbo) {
  return {((addr & 0x3FFFF) >> 4) | ((lbo >> 4) & 0x3FFF) << 16};
}
__device__ __forceinline__ Desc desc_k(uint32_t addr) {
  return desc(addr, 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie accumulator registers to this point: the compiler may not move
// their reads above a wgmma_wait or their writes below a later issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 -> one register of two bf16, `lo` in the low half: the layout
// of an A fragment (and of a wgmma accumulator's column pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// m64nNk16, bf16 in, f32 accumulate.  The accumulator of a warpgroup's
// 64 x N product: thread t (warp w = t / 32, lane l) holds d[i] at
//   row 16 w + l / 4 + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 (l % 4) + i % 2.
// An A fragment in registers (k16) is that layout over 16 columns, as
// bf16 pairs: a0..a3 = columns 16 kk + {0..15} of a 64 x N accumulator
// are the pairs of d[8 kk .. 8 kk + 7].  TA / TB: 0 K-major, 1 MN-major.

// d (64 x 32, f32) (+)= A (64 x 16) B (16 x 32), A and B from shared memory
// (descriptors a, b).
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[16], Desc a, Desc b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %19, 0;\n"
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "da, db, p, 1, 1, %20, %21;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate), "n"(TA),
        "n"(TB));
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B from shared memory
// (descriptors a, b).
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], Desc a, Desc b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, %36, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate), "n"(TA),
        "n"(TB));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 pairs in registers) B (16 x 64,
// shared memory, descriptor b).
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       Desc b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "mov.b64 db, {%36, %37};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, %39;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(DESC_HI),
        "r"(accumulate), "n"(TB));
}

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), A and B from shared memory
// (descriptors a, b).
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[64], Desc a, Desc b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, %68, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
       "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
       "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
       "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
       "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
       "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
       "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate), "n"(TA),
        "n"(TB));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 pairs in registers) B (16 x 128,
// shared memory, descriptor b).
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       Desc b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "mov.b64 db, {%68, %69};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, %71;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
       "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
       "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
       "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
       "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
       "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
       "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(DESC_HI),
        "r"(accumulate), "n"(TB));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The bf16 tensor at `base` as a 4-D map (D, Hx, T, Bx), innermost first,
// read in boxes of (64, 1, rows, 1), 128-byte swizzled.  The port's two
// layouts: (B, T, Hx, D) is (D, Hx, T, B); (B*Hx, T, D) is (D, 1, T, B*Hx).
// Rows at or past T read as zeros, so the host pads nothing.
inline int make_map(CUtensorMap* map, const void* base, int D, int Hx,
                    int T, int Bx, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)T,
                              (cuuint64_t)Bx};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hx * D * 2,
                                 (cuuint64_t)T * Hx * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Map coordinates (c1, c3) of head h of batch b in either layout.
__device__ __forceinline__ int2 head_coords(int b, int h, int Hx,
                                            int bh_layout) {
  return bh_layout ? make_int2(0, b * Hx + h) : make_int2(h, b);
}

}  // namespace sm90
}  // namespace ptt
