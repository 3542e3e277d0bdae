// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// 128-byte-swizzled shared-memory tiles, wgmma matrix descriptors,
// mbarriers, TMA tile loads and the host's tensor maps for them, and the
// bf16 and int8 wgmma shapes the kernels issue.
//
// Tiles. Every operand tile in shared memory is a stack of 128-byte rows
// (64 bf16), 1024-byte aligned, with 16-byte chunk c of row r stored at
// r * 128 + ((c ^ (r % 8)) * 16): the layout CUDA's 128-byte swizzle mode
// gives and wgmma's SWIZZLE_128B descriptors read.
//  * K-major operand (the product's depth contiguous in a row: q and k rows
//    of attention, x rows of a GEMM): rows are M or N, 8-row groups 1024
//    bytes apart (SBO); a k16 step advances the start address by 32 bytes.
//  * MN-major operand (N contiguous in a row: v rows [key][d], weight rows
//    [k][n]), read with the transpose flag: rows are K, 8-row groups 1024
//    bytes apart (SBO), 64-wide N atoms LBO bytes apart; a k16 step advances
//    the start address by 16 rows (2048 bytes).
// Accumulators (m64nN, f32): thread (warp w, lane l) holds rows 16w + l/4
// and 16w + l/4 + 8, columns 8j + 2(l%4) and +1, as d[4j..4j+3] =
// (row, c), (row, c+1), (row+8, c), (row+8, c+1). A from registers (m64k16
// bf16) takes the same rows: a[i] = bf16x2 of d[2i], d[2i+1] of the 16
// columns of that k16 step, so a softmax tile becomes an A operand in place.
// int8 (s8 x s8 -> s32): a 128-byte row holds 128 int8 of depth; wgmma
// takes no transpose flag for s8, so both operands are K-major tiles as
// above, and a k32 step advances the start address by 32 bytes. The s32
// accumulators lie as the f32 ones.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// MN-major descriptors: bytes between 64-wide N atoms (LBO) and between
// 8-row K groups (SBO), CUTLASS's canonical SW128 MN-major layout
constexpr uint32_t kSbo = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// SWIZZLE_128B wgmma descriptor at shared address `saddr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// mbarriers in shared memory (one arrival each here) and TMA tile loads
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box at (c0 innermost, c1) of a 2-d tensor map -> shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// the same for the box at (c0, c1, c2) of a 3-d tensor map
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Host: cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point query (no link against libcuda); null if it is missing.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess) return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// Host: a tensor map of `rank` dimensions over `base`: dims[0] innermost
// and contiguous (elements), strides[i] the bytes between steps of
// dims[i + 1], boxes of box[] elements; reads past the dims are zeros.
inline bool make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle) {
  const auto encode = tensor_map_encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode && encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Host: a 2-d row-major [rows, cols] map with (box_cols, box_rows) boxes
inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rows, int cols,
                        int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return make_tensor_map(map, type, 2, base, dims, strides, box, swizzle);
}

// generic-proxy writes (st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
// issue / wait, which it cannot see
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<uint32_t*>(&p);
}

#define TVC_F8(i)                                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory;
// TB = 1: B MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : TVC_F8(0), TVC_F8(8), TVC_F8(16), TVC_F8(24)
      : "l"(da), "l"(db), "r"(acc), "n"(TB)
      : "memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], both from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : TVC_F8(0), TVC_F8(8), TVC_F8(16), TVC_F8(24), TVC_F8(32), TVC_F8(40), TVC_F8(48), TVC_F8(56)
      : "l"(da), "l"(db), "r"(acc), "n"(TB)
      : "memory");
}

// D[64 x 192] (+)= A[64 x 16] . B[16 x 192], both from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n192_ss(float (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, %99;\n}\n"
      : TVC_F8(0), TVC_F8(8), TVC_F8(16), TVC_F8(24), TVC_F8(32), TVC_F8(40), TVC_F8(48), TVC_F8(56),
        TVC_F8(64), TVC_F8(72), TVC_F8(80), TVC_F8(88)
      : "l"(da), "l"(db), "r"(acc), "n"(TB)
      : "memory");
}

// D[64 x 256] (+)= A[64 x 16] . B[16 x 256], both from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : TVC_F8(0), TVC_F8(8), TVC_F8(16), TVC_F8(24), TVC_F8(32), TVC_F8(40), TVC_F8(48), TVC_F8(56),
        TVC_F8(64), TVC_F8(72), TVC_F8(80), TVC_F8(88), TVC_F8(96), TVC_F8(104), TVC_F8(112), TVC_F8(120)
      : "l"(da), "l"(db), "r"(acc), "n"(TB)
      : "memory");
}

// D[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (shared)
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : TVC_F8(0), TVC_F8(8), TVC_F8(16), TVC_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1)
      : "memory");
}

// D[64 x 32] += A[64 x 16] (registers) . B[16 x 32] (shared)
template <int TB>
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
      : TVC_F8(0), TVC_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1)
      : "memory");
}

#undef TVC_F8

#define TVC_R8(i)                                                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), \
      "+r"(d[i + 7])

// D[64 x 128] (+)= A[64 x 32] . B[32 x 128], int8 from shared memory, both
// K-major, s32 sums
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : TVC_R8(0), TVC_R8(8), TVC_R8(16), TVC_R8(24), TVC_R8(32), TVC_R8(40), TVC_R8(48), TVC_R8(56)
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// D[64 x 256] (+)= A[64 x 32] . B[32 x 256], int8 from shared memory, both
// K-major, s32 sums
__device__ __forceinline__ void wgmma_m64n256k32_s8(int32_t (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : TVC_R8(0), TVC_R8(8), TVC_R8(16), TVC_R8(24), TVC_R8(32), TVC_R8(40), TVC_R8(48), TVC_R8(56),
        TVC_R8(64), TVC_R8(72), TVC_R8(80), TVC_R8(88), TVC_R8(96), TVC_R8(104), TVC_R8(112), TVC_R8(120)
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

#undef TVC_R8

}  // namespace hopper
