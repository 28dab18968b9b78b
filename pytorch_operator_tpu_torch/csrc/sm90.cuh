// Hopper (sm_90a) building blocks of the port's flash kernels: mbarriers,
// TMA tensor loads, wgmma descriptors and instructions, warp-specialisation
// helpers, and the host-side tensor maps.
//
// Every piece takes the element type E of the kernel's inputs: bf16
// (__nv_bfloat16) or fp16 (__half), both 2 bytes, both multiplied by the
// same m64nNk16 shapes into f32 accumulators; or float, multiplied as TF32
// by m64nNk8 shapes (the same 32 bytes of K a step: mma_ss_tf32,
// mma_rs_tf32), where wgmma takes no transpose bit: both shared-memory
// operands are K-major, an A fragment in registers holds one value a
// register (tf32() rounds it), TMA rounds f32 to TF32 as it loads it
// (make_map), and the f32 kernels write the transposed copies they need
// themselves (transpose_tf32).
//
// The one layout every piece agrees on: a slab of a tile in shared
// memory, 128 bytes per row (64 columns of a 2-byte E, 32 of f32),
// 128-byte swizzled (16-byte chunk c of row r sits at chunk c ^ (r % 8)),
// slabs 1024-byte aligned.  TMA writes it (CU_TENSOR_MAP_SWIZZLE_128B with
// a 128-byte box), the wgmma descriptors read it (layout type 1, 8-row
// groups 1024 bytes apart), and the register-to-shared stores write it by
// hand (swizzle_128b, swizzle_128b_f32, transpose_tf32).  A (rows, D) tile
// with D = 128 is two such slabs of bf16, four of f32.
//
// A 16-bit tile at D 32 or 16 has 64- or 32-byte rows: one narrow slab,
// swizzled at its row width.  In each mode the hardware XORs address bits
// [4, 4 + b) with bits [7, 7 + b), b = 3, 2, 1 for 128-, 64- and 32-byte
// rows: chunk c of row r sits at chunk c ^ (r % 8), c ^ ((r / 2) % 4) or
// c ^ ((r / 4) % 2).  TMA writes it (make_map's row_bytes: SWIZZLE_64B /
// 32B, a box of D columns), the descriptors read it (desc_hi: layout type
// 2 / 3, 8-row groups 512 / 256 bytes apart), and a tile is aligned to
// that period.  No store writes a narrow slab by hand.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {
namespace sm90 {

// ---------------------------------------------------------------------------
// shared-memory addresses, barriers, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) (c < 64) in a 128-byte-swizzled slab of
// 2-byte elements.
__device__ __forceinline__ uint32_t swizzle_128b(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// The same for element (r, c) (c < 32) of a slab of f32.
__device__ __forceinline__ uint32_t swizzle_128b_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
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

// ---- clusters: a CTA's rank, its peer's shared memory, cluster barriers.
// Used by the f32 walk (flash_bwd_sm90.cuh) and the f32 dq kernel
// (flash_bwd_dq_sm90.cu) at D 256, two CTAs a cluster.

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of CTA `rank`'s copy of this CTA's shared
// address `addr` (a smem_u32 value).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Every thread of every CTA of the cluster: the memory operations before
// it (mbarrier initialisation, remote stores and arrivals) are visible to
// every thread after it.  A CTA must not exit while a peer may still
// write its shared memory: each ends with one.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One arrival on the mbarrier at shared::cluster address `bar` (mapa: a
// peer's), releasing this thread's earlier memory operations to the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: for a barrier whose phase a
// peer CTA completes (remote arrivals, st_async_v4's bytes), so that its
// writes before the arrival are visible after the wait.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Store four f32 at shared::cluster address `dst` (a peer's shared
// memory) and complete 16 bytes of transactions on the mbarrier at
// shared::cluster address `bar` in the same CTA as `dst`.
__device__ __forceinline__ void st_async_v4(uint32_t dst, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// The two-CTA kernels' exchange of a partial score tile (64 rows x 32
// f32 of a wgmma accumulator, summed over one CTA's half of D).
// send_partial: a consumer thread's 16 f32 into the peer's buffer at
// shared::cluster address `dst`, register 4 m + j of thread t at float
// 4 (128 m + t) + j, completing its bytes on the peer's mbarrier `bar`.
__device__ __forceinline__ void send_partial(const float (&a)[16],
                                             uint32_t dst, int tid,
                                             uint32_t bar) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    st_async_v4(dst + (128 * m + tid) * 16, a[4 * m], a[4 * m + 1],
                a[4 * m + 2], a[4 * m + 3], bar);
}

// a += the peer's partial, laid out as send_partial writes it: own +
// peer here is peer + own in the peer CTA, the same bits.
__device__ __forceinline__ void add_partial(float (&a)[16],
                                            const unsigned char* src,
                                            int tid) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 p =
        *reinterpret_cast<const float4*>(src + (128 * m + tid) * 16);
    a[4 * m] = a[4 * m] + p.x;
    a[4 * m + 1] = a[4 * m + 1] + p.y;
    a[4 * m + 2] = a[4 * m + 2] + p.z;
    a[4 * m + 3] = a[4 * m + 3] + p.w;
  }
}

// Launch `kernel` on `blocks` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory, in clusters of `ctas` consecutive
// blocks (the block index's fastest part is the cluster rank).  `args`
// are the kernel's parameters, converted to their types.
template <typename... Params>
int launch_clusters(void (*kernel)(Params...), int blocks, int threads,
                    int smem, int ctas, cudaStream_t stream,
                    std::remove_cv_t<Params>... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* params[] = {&args...};
  const int e = static_cast<int>(cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), params));
  return e ? e : static_cast<int>(cudaGetLastError());
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
// type 1 = 128-byte swizzle) is DESC_HI for every 128-byte operand.  The
// wrappers below pack the two inside their asm, so a descriptor waiting
// for its wgmma holds one register, not two; they take each operand's
// high word as a template argument (HA, HB), DESC_HI unless given.
//
// A narrow slab (rows of 64 or 32 bytes, see the header) has the high
// word desc_hi(row_bytes): SBO 8 rows (512 or 256 bytes), layout type 2
// (64-byte swizzle) or 3 (32-byte).  K-major, a k16 step moves `addr` by
// 32 bytes inside the row; MN-major, an M/N block is 32 or 16 wide and a
// k16 step moves `addr` by 16 rows.
__host__ __device__ constexpr uint32_t desc_hi(int row_bytes) {
  return ((8 * row_bytes) >> 4) |
         (uint32_t(row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3) << 30);
}
constexpr uint32_t DESC_HI = desc_hi(128);
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

// Two f32 -> one register of two E (rounded to nearest), `lo` in the low
// half: the layout of an A fragment (and of a wgmma accumulator's column
// pair).
template <typename E>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// f32 -> TF32 rounded to nearest (ties away), as the WMMA kernels'
// __float_to_tf32: the bits of an f32 whose low 13 mantissa bits are 0.
// One such register is one element of a TF32 A fragment.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// m64nNk8, TF32 in (f32 registers or shared memory read as TF32: wgmma
// ignores the low 13 mantissa bits), f32 accumulate.  The accumulator is
// laid out as at k16 (below).  An A fragment in registers (k8) gives
// thread t (warp w, lane l) a0..a3 at
//   rows 16 w + l / 4 + 8 {0, 1, 0, 1},  columns l % 4 + 4 {0, 0, 1, 1}
// of the 8 columns, where an accumulator holds columns 2 (l % 4) + {0, 1}:
// columns 8 kk .. 8 kk + 7 of a 64 x N accumulator are the A fragment
// {d[4 kk], d[4 kk + 2], d[4 kk + 1], d[4 kk + 3]} of those columns
// taken in the order [0, 2, 4, 6, 1, 3, 5, 7], so the B operand's K rows
// must come in that order too (transpose_tf32 with PERM).  No transpose
// bit: both shared-memory operands are K-major.

// d (64 x 16, f32) (+)= A (64 x 8) B (8 x 16), TF32, both K-major from
// shared memory (descriptors a, b).
__device__ __forceinline__ void mma_ss_tf32(float (&d)[8], Desc a, Desc b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %11, 0;\n"
      "mov.b64 da, {%8, %10};\nmov.b64 db, {%9, %10};\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "da, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate));
}

// d (64 x 32, f32) (+)= A (64 x 8) B (8 x 32), TF32, both K-major from
// shared memory (descriptors a, b).
__device__ __forceinline__ void mma_ss_tf32(float (&d)[16], Desc a, Desc b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %19, 0;\n"
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "da, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 8) B (8 x 64), TF32, both K-major from
// shared memory (descriptors a, b).
__device__ __forceinline__ void mma_ss_tf32(float (&d)[32], Desc a, Desc b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 8) B (8 x 128), TF32, both K-major from
// shared memory (descriptors a, b).
__device__ __forceinline__ void mma_ss_tf32(float (&d)[64], Desc a, Desc b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1;\n}\n"
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
      : "r"(a.lo), "r"(b.lo), "r"(DESC_HI), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 8, TF32 in registers: tf32()) B (8 x 64,
// K-major in shared memory, descriptor b).
__device__ __forceinline__ void mma_rs_tf32(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, Desc b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "mov.b64 db, {%36, %37};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(DESC_HI),
        "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 8, TF32 in registers: tf32()) B (8 x 128,
// K-major in shared memory, descriptor b).
__device__ __forceinline__ void mma_rs_tf32(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, Desc b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "mov.b64 db, {%68, %69};\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1;\n}\n"
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
        "r"(accumulate));
}

// m64nNk16, E (bf16 or fp16) in, f32 accumulate.  The accumulator of a
// warpgroup's 64 x N product: thread t (warp w = t / 32, lane l) holds d[i] at
//   row 16 w + l / 4 + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 (l % 4) + i % 2.
// An A fragment in registers (k16) is that layout over 16 columns, as
// E pairs: a0..a3 = columns 16 kk + {0..15} of a 64 x N accumulator
// are the pairs of d[8 kk .. 8 kk + 7].  TA / TB: 0 K-major, 1 MN-major.

// d (64 x 16, f32) (+)= A (64 x 16) B (16 x 16), A and B from shared memory
// (descriptors a, b).
#define PTT_MMA_SS_N16(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                           \
      "setp.ne.b32 p, %11, 0;\n"                                        \
      "mov.b64 da, {%8, %10};\nmov.b64 db, {%9, %14};\n"                \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32" TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7}, "                               \
      "da, db, p, 1, 1, %12, %13;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                   \
      : "r"(a.lo), "r"(b.lo), "r"(HA), "r"(accumulate), "n"(TA),        \
        "n"(TB), "r"(HB))
template <typename E, int TA, int TB, uint32_t HA = DESC_HI,
          uint32_t HB = HA>
__device__ __forceinline__ void mma_ss(float (&d)[8], Desc a, Desc b,
                                       int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_SS_N16(".f16.f16");
  else
    PTT_MMA_SS_N16(".bf16.bf16");
}
#undef PTT_MMA_SS_N16

// d (64 x 32, f32) (+)= A (64 x 16) B (16 x 32), A and B from shared memory
// (descriptors a, b).
#define PTT_MMA_SS_N32(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                           \
      "setp.ne.b32 p, %19, 0;\n"                                        \
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %22};\n"              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                         \
      "da, db, p, 1, 1, %20, %21;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])               \
      : "r"(a.lo), "r"(b.lo), "r"(HA), "r"(accumulate), "n"(TA),        \
        "n"(TB), "r"(HB))
template <typename E, int TA, int TB, uint32_t HA = DESC_HI,
          uint32_t HB = HA>
__device__ __forceinline__ void mma_ss(float (&d)[16], Desc a, Desc b,
                                       int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_SS_N32(".f16.f16");
  else
    PTT_MMA_SS_N32(".bf16.bf16");
}
#undef PTT_MMA_SS_N32

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B from shared memory
// (descriptors a, b).
#define PTT_MMA_SS_N64(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                           \
      "setp.ne.b32 p, %35, 0;\n"                                        \
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %38};\n"              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "da, db, p, 1, 1, %36, %37;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
      : "r"(a.lo), "r"(b.lo), "r"(HA), "r"(accumulate), "n"(TA),        \
        "n"(TB), "r"(HB))
template <typename E, int TA, int TB, uint32_t HA = DESC_HI,
          uint32_t HB = HA>
__device__ __forceinline__ void mma_ss(float (&d)[32], Desc a, Desc b,
                                       int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_SS_N64(".f16.f16");
  else
    PTT_MMA_SS_N64(".bf16.bf16");
}
#undef PTT_MMA_SS_N64

// d (64 x 16, f32) (+)= A (64 x 16, E pairs in registers) B (16 x 16,
// shared memory, descriptor b).
#define PTT_MMA_RS_N16(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                               \
      "setp.ne.b32 p, %14, 0;\n"                                        \
      "mov.b64 db, {%12, %13};\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32" TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7}, "                               \
      "{%8, %9, %10, %11}, db, p, 1, 1, %15;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                   \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(HB),         \
        "r"(accumulate), "n"(TB))
template <typename E, int TB, uint32_t HB = DESC_HI>
__device__ __forceinline__ void mma_rs(float (&d)[8], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       Desc b, int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_RS_N16(".f16.f16");
  else
    PTT_MMA_RS_N16(".bf16.bf16");
}
#undef PTT_MMA_RS_N16

// d (64 x 32, f32) (+)= A (64 x 16, E pairs in registers) B (16 x 32,
// shared memory, descriptor b).
#define PTT_MMA_RS_N32(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                               \
      "setp.ne.b32 p, %22, 0;\n"                                        \
      "mov.b64 db, {%20, %21};\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                         \
      "{%16, %17, %18, %19}, db, p, 1, 1, %23;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])               \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(HB),         \
        "r"(accumulate), "n"(TB))
template <typename E, int TB, uint32_t HB = DESC_HI>
__device__ __forceinline__ void mma_rs(float (&d)[16], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       Desc b, int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_RS_N32(".f16.f16");
  else
    PTT_MMA_RS_N32(".bf16.bf16");
}
#undef PTT_MMA_RS_N32

// d (64 x 64, f32) (+)= A (64 x 16, E pairs in registers) B (16 x 64,
// shared memory, descriptor b).
#define PTT_MMA_RS_N64(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                               \
      "setp.ne.b32 p, %38, 0;\n"                                        \
      "mov.b64 db, {%36, %37};\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "{%32, %33, %34, %35}, db, p, 1, 1, %39;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(HB),         \
        "r"(accumulate), "n"(TB))
template <typename E, int TB, uint32_t HB = DESC_HI>
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       Desc b, int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_RS_N64(".f16.f16");
  else
    PTT_MMA_RS_N64(".bf16.bf16");
}
#undef PTT_MMA_RS_N64

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), A and B from shared memory
// (descriptors a, b).
#define PTT_MMA_SS_N128(TY)                                             \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                           \
      "setp.ne.b32 p, %67, 0;\n"                                        \
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %70};\n"              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                         \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                         \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "da, db, p, 1, 1, %68, %69;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
       "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
       "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),              \
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
       "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),              \
       "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),              \
       "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
       "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),              \
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "r"(a.lo), "r"(b.lo), "r"(HA), "r"(accumulate), "n"(TA),        \
        "n"(TB), "r"(HB))
template <typename E, int TA, int TB, uint32_t HA = DESC_HI,
          uint32_t HB = HA>
__device__ __forceinline__ void mma_ss(float (&d)[64], Desc a, Desc b,
                                       int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_SS_N128(".f16.f16");
  else
    PTT_MMA_SS_N128(".bf16.bf16");
}
#undef PTT_MMA_SS_N128

// d (64 x 128, f32) (+)= A (64 x 16, E pairs in registers) B (16 x 128,
// shared memory, descriptor b).
#define PTT_MMA_RS_N128(TY)                                             \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                               \
      "setp.ne.b32 p, %70, 0;\n"                                        \
      "mov.b64 db, {%68, %69};\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                           \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                         \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                         \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                         \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                         \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                         \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "{%64, %65, %66, %67}, db, p, 1, 1, %71;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
       "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
       "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),              \
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
       "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),              \
       "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),              \
       "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
       "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),              \
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.lo), "r"(HB),         \
        "r"(accumulate), "n"(TB))
template <typename E, int TB, uint32_t HB = DESC_HI>
__device__ __forceinline__ void mma_rs(float (&d)[64], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       Desc b, int accumulate) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA_RS_N128(".f16.f16");
  else
    PTT_MMA_RS_N128(".bf16.bf16");
}
#undef PTT_MMA_RS_N128

// ---------------------------------------------------------------------------
// TF32 transposed copies
// ---------------------------------------------------------------------------

// The f32 kernels' three warpgroups: two consumers and a producer whose
// warp 0 issues the TMA loads and whose warps 1-3 (TF32_TRANSPOSERS
// threads) write the transposed copies.  The registers a thread of each
// holds: 128 x 56 + 256 x 224 = 64,512, the block's 384 x 168 at launch,
// which setmaxnreg only moves between warpgroups (asking for more than
// that waits forever).  At 40 for the producer transpose_tf32 spilled.
constexpr int TF32_TRANSPOSERS = 96, TF32_PRODUCER_REGS = 56,
              TF32_CONSUMER_REGS = 224;

// Row of an (R, .) tile that position p of a transposed row holds: with
// PERM, within each group of 8 positions the rows [0, 2, 4, 6, 1, 3, 5, 7]
// (the order in which a k8 A fragment taken from an accumulator holds its
// columns, above); without it, row p.
template <bool PERM> __device__ __forceinline__ int tf32_src_row(int p) {
  return PERM ? (p & ~7) + 2 * (p & 3) + ((p >> 2) & 1) : p;
}

// Write the (C, R) transpose of an (R, C) f32 tile.  `src` is the tile as
// TMA writes it (its values TF32 already: make_map): C / 32 slabs of R
// rows (R * 128 bytes each); `dst` gets R / 32 slabs of C rows (C * 128
// bytes each), so that a K-major wgmma operand over R reads it.  The work
// is (C / 32) x (R / 32) units of 32 source columns by 32 source rows;
// warp `w` of WARPS takes units w, w + WARPS, ... from unit `first` on.
// In a unit lane l owns source column 32 s + l, the destination row of
// that index, so its swizzle terms are fixed: with the rows and positions
// known at compile time, every address is a register, an XOR with a
// constant and an immediate.  An item is four 4-byte loads from one source
// column and
// one 16-byte store of four positions; a warp's loads read one 128-byte
// row and its stores spread over all banks in each quarter warp.  Two
// items' loads are in flight at a time.
template <int R, int C, bool PERM, int WARPS>
__device__ __forceinline__ void transpose_tf32(const unsigned char* src,
                                               unsigned char* dst, int w,
                                               int lane, int first = 0) {
  static_assert(R % 32 == 0 && C % 32 == 0, "whole slabs");
  constexpr int UNITS = (C / 32) * (R / 32);
  const uint32_t s0 = smem_u32(src), d0 = smem_u32(dst);
  // a row or position of residue k mod 8 takes load chunk (l / 4) ^ k and
  // store chunk l ^ k: chunk offsets lc ^ (k << 4) and dc ^ (k << 4)
  const uint32_t lc = ((lane >> 2) & 7) << 4, dc = (lane & 7) << 4;
  for (int u = (w - first % WARPS + WARPS) % WARPS; u < UNITS; u += WARPS) {
    const int sl = u % (C / 32), rb = u / (C / 32);  // slab, 32-row block
    const uint32_t sb =
        s0 + sl * (R * 128) + rb * (32 * 128) + (lane & 3) * 4;
    const uint32_t db = d0 + rb * (C * 128) + (32 * sl + lane) * 128;
#pragma unroll
    for (int p2 = 0; p2 < 8; p2 += 2) {
      uint32_t v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tf32_src_row<PERM>(4 * (p2 + h) + j);  // < 32
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(v[h][j])
                       : "r"(sb + r * 128 + (lc ^ ((r & 7) << 4))));
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         db + (dc ^ ((p2 + h) << 4))),
                     "r"(v[h][0]), "r"(v[h][1]), "r"(v[h][2]), "r"(v[h][3])
                     : "memory");
    }
  }
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

// The tensor of E at `base` as a 4-D map (D, Hx, T, Bx), innermost first,
// read in boxes of (row_bytes of columns, 1, rows, 1), swizzled at
// row_bytes: 128 (64 columns of bf16 / fp16, 32 of f32), or a narrow
// slab's 64 or 32 (a 16-bit D of 32 or 16, the header).  The port's two
// layouts: (B, T, Hx, D) is (D, Hx, T, B); (B*Hx, T, D) is (D, 1, T,
// B*Hx).  Rows at or
// past T read as zeros, so the host pads nothing.  f32 is mapped as
// TFLOAT32, whose loads round each value to TF32 (to nearest, ties away:
// cvt.rna's rounding, which chip_smoke.py phase 1 checks on the card);
// wgmma would otherwise drop the low 13 mantissa bits of what it reads.
template <typename E>
int make_map(CUtensorMap* map, const void* base, int D, int Hx, int T,
             int Bx, int rows, int row_bytes = 128) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  if (row_bytes != 128 && row_bytes != 64 && row_bytes != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr cuuint64_t ES = sizeof(E);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)T,
                              (cuuint64_t)Bx};
  const cuuint64_t strides[3] = {(cuuint64_t)D * ES, (cuuint64_t)Hx * D * ES,
                                 (cuuint64_t)T * Hx * D * ES};
  const cuuint32_t box[4] = {(cuuint32_t)(row_bytes / ES), 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  constexpr CUtensorMapDataType type =
      std::is_same_v<E, float>    ? CU_TENSOR_MAP_DATA_TYPE_TFLOAT32
      : std::is_same_v<E, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = encode(map, type, 4,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// make_map for a tensor of Hx heads in one of the port's layouts
// (bh_layout 0: (B, T, Hx, D); 1: (B*Hx, T, D)).
template <typename E>
int make_head_map(CUtensorMap* map, const void* base, int D, int Hx, int T,
                  int B, int bh_layout, int rows, int row_bytes = 128) {
  return bh_layout
             ? make_map<E>(map, base, D, 1, T, B * Hx, rows, row_bytes)
             : make_map<E>(map, base, D, Hx, T, B, rows, row_bytes);
}

// Map coordinates (c1, c3) of head h of batch b in either layout.
__device__ __forceinline__ int2 head_coords(int b, int h, int Hx,
                                            int bh_layout) {
  return bh_layout ? make_int2(0, b * Hx + h) : make_int2(h, b);
}

}  // namespace sm90
}  // namespace ptt
