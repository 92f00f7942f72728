// Hopper (sm_90a) building blocks for the kernels of this directory: tensor
// maps, TMA loads, stores and reduce-adds, mbarriers, wgmma shared-memory
// descriptors and products, and register reallocation between warpgroups.
// Each wraps one or two PTX instructions; the comment above each names them.
//
// Shared tiles use the 128-byte swizzle throughout: a TMA box is 64 bf16
// values (128 bytes) wide, and eight of its rows form one 1024-byte swizzle
// atom. A tile must start on a 1024-byte boundary for the wgmma descriptor
// (whose base-offset field is left 0) to see the layout TMA wrote.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// -- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once with cudaGetDriverEntryPoint (its
// by-version form from CUDA 12.5), so the library needs no link against
// libcuda. nullptr if missing.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A tensor map over a bf16 tensor (B, S, heads, D) whose last dim is
// contiguous, seen as 4-d (D, heads, S, B) with the given element strides of
// heads, S and B. A box is 64 columns of one head and `rows` positions of S,
// stored 128-byte swizzled; rows past S read as zeros, and a store skips
// them. TMA needs a 16-byte aligned base and strides in bytes that are
// multiples of 16.
inline bool encode_bf16_rows(CUtensorMap* map, const void* base, int B, int S,
                             int heads, int D, long long stride_b,
                             long long stride_s, long long stride_h,
                             int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_h * 2,
                                 (cuuint64_t)stride_s * 2,
                                 (cuuint64_t)stride_b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same over an fp32 tensor (B, S, heads, D): a box is 32 columns (128
// bytes) of one head and `rows` positions of S, 128-byte swizzled. Used as
// the target of tma_reduce_add_4d, which skips rows past S.
inline bool encode_f32_rows(CUtensorMap* map, const void* base, int B, int S,
                            int heads, int D, long long stride_b,
                            long long stride_s, long long stride_h,
                            int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_h * 4,
                                 (cuuint64_t)stride_s * 4,
                                 (cuuint64_t)stride_b * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over n contiguous fp32 values seen as one dimension, a box
// being `box` values (at most 256), not swizzled. A box may start at any
// element; values past n read as zeros. This reads per-row statistics of
// any length S at an arbitrary offset, where a 2-d map would need S * 4
// bytes to be a multiple of 16.
inline bool encode_f32_flat(CUtensorMap* map, const void* base, long long n,
                            int box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // none for one dimension
  const cuuint32_t box_dims[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<void*>(base), dims, strides, box_dims, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -- device: addresses, mbarriers, TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier.init: a barrier whose phase completes after `count` arrivals
// (and, once armed with expect_tx, the bytes it waits for).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// fence.mbarrier_init: make the inits visible to the async proxy (TMA)
// before any thread uses the barriers (follow with __syncthreads()).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbarrier.arrive.expect_tx: arrive once and add `bytes` to the transfer
// count the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// mbarrier.arrive: one arrival on the current phase.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// mbarrier.try_wait.parity in a loop: wait until the phase of parity
// `parity` has completed. A barrier starts in phase 0; its parity flips each
// time a phase completes, so a ring's waiter flips its parity every lap.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// cp.async.bulk.tensor.4d: one TMA box at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory at `dst`; completion is counted in
// bytes on `bar`. Issued by one thread.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// cp.async.bulk.tensor.1d: one box of a 1-d tensor map starting at element
// c0, into shared memory at `dst` (128-byte aligned); completion is counted
// in bytes on `bar`. Issued by one thread.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// cp.async.bulk.tensor.4d (shared to global): one TMA box from shared
// memory at `src` to coordinates (c0, c1, c2, c3); the parts of the box
// outside the tensor are not written. Issued by one thread, after
// fence_proxy_async, and tracked as a bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cp.reduce.async.bulk.tensor.4d (shared to global, add): one TMA box of
// fp32 from shared memory at `src` added element by element into the tensor
// at coordinates (c0, c1, c2, c3); the parts of the box outside the tensor
// are skipped. Each element's add is atomic, but the order of the adds from
// different blocks is not fixed. Issued by one thread after
// fence_proxy_async, tracked as a bulk group like tma_store_4d.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cp.async.bulk.commit_group: close the bulk stores issued so far into one
// group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// cp.async.bulk.wait_group.read N: wait until at most N groups still read
// their shared source (it may then be overwritten).
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// cp.async.bulk.wait_group N: wait until at most N groups are unfinished
// (their writes done), e.g. before the block exits.
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// fence.proxy.async: make the threads' shared-memory writes visible to the
// async proxy (a TMA store that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// fence.proxy.async.global: order the thread's global accesses through the
// generic proxy (a flag) with those through the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ld.relaxed.gpu: a counter in global memory that other blocks add to.
__device__ __forceinline__ int ld_relaxed_gpu(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// red.relaxed.gpu.add: add to a counter in global memory, no value back.
__device__ __forceinline__ void red_add_relaxed_gpu(int* p, int v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// st.shared.b32 at a shared-memory address.
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t value) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(value)
               : "memory");
}

// st.shared.v2.f32: two floats at an 8-byte aligned shared-memory address.
__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float x,
                                                float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// ld.shared.f32 at a shared-memory address.
__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// ld.shared.b32 at a shared-memory address.
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// -- device: warpgroups --------------------------------------------------------

// setmaxnreg.dec / .inc: a warpgroup gives registers back to the SM's pool,
// or takes them, so that producer and consumer warpgroups of one block can
// hold different numbers. All four warps of the warpgroup execute it.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// bar.sync / bar.arrive on a named barrier (ids 1-15; 0 is
// __syncthreads()) that completes when `kThreads` threads have reached it:
// some waiting (sync), the others passing through (arrive). Two warpgroups
// pass a turn back and forth with a pair of them.
template <int kThreads>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
template <int kThreads>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// wgmma.fence: order the warpgroup's register writes (accumulators, a
// register A operand) before the wgmma that reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// wgmma.commit_group: close the wgmmas issued so far into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wgmma.wait_group N: wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An empty asm that claims to rewrite a register: the compiler may not move
// reads or writes of it across this point. After wgmma_wait, it keeps an
// accumulator's uses after the wait and a register A operand alive until
// the product that reads it has finished.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

// The 64-bit shared-memory descriptor of a wgmma operand stored with the
// 128-byte swizzle (layout type 1 in bits 62-63), start address in bits
// 0-13, leading byte offset in 16-29, stride byte offset in 32-45, each in
// 16-byte units.
// - K-major (rows of the operand's M or N index, K contiguous: Q and K
//   for Q K^T): stride = 1024 bytes from one 8-row atom to the next; the
//   leading offset is unused (1). A k-step of 16 values inside the 128-byte
//   row moves the start by 32 bytes.
// - MN-major (rows of K, the N index contiguous: V for P V, read with the
//   transpose-B immediate; or the M index contiguous, dS for dS K in the
//   backward, read with the transpose-A immediate): stride = 1024 bytes from
//   one group of 8 K rows to the next; leading = the bytes from one
//   64-column box of N (or M) to the next, unused when there is one.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t box_bytes) {
  return desc_sw128(addr, box_bytes, 1024);
}

// -- device: wgmma.mma_async, bf16 in, fp32 accumulate -------------------------
//
// The accumulator of m64nN: warp w of the warpgroup holds rows 16w .. 16w+15;
// lane (g = lane / 4, t = lane % 4) holds d[4j + 0, 1] at row g, columns
// 8j + 2t + {0, 1} and d[4j + 2, 3] at row g + 8, the same columns: the
// m16n8k16 C fragment, once per 8 columns. A register A operand is the
// m16n8k16 A fragment of the warp's 16 rows. scale_d = 0 overwrites D.
// kTrans* = 0 reads the operand K-major, 1 MN-major.

// eight "+f" operands, d[i] .. d[i + 7]
#define HOPPER_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128) = A B (+ D): A (64 x 16) and B (16 x 128) in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D (64 x 128) = A B (+ D): A (64 x 16) in registers, B (16 x 128) in
// shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t* a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(kTransB));
}

// D (64 x 64) = A B (+ D): A (64 x 16) and B (16 x 64) in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D (64 x 64) = A B (+ D): A (64 x 16) in registers, B (16 x 64) in shared
// memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t* a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(kTransB));
}

#undef HOPPER_D8

}  // namespace hopper
