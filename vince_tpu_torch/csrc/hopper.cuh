// Hopper building blocks shared by the port's tensor-core kernels (K2, K3):
// mbarriers, TMA tile loads, wgmma descriptors and the one wgmma shape the
// kernels issue, and the host-side encoding of a TMA tensor map.
//
// Shared-memory layouts the kernels give wgmma:
//  - "chunk-major" (no swizzle): an [R rows, K] bf16 tile stored as K/8 chunks
//    of 8 channels, each chunk R rows of 16 bytes, so chunk j of row r lies
//    at (j * R + r) * 16. Its 8 x 16-byte core matrices are 128 contiguous
//    bytes, so wgmma reads it as A K-major (rows = M; start + 16 * shift for a
//    tile that begins `shift` rows lower, any shift) and as A or B MN-major
//    (channels = M or N, rows = K).
//  - TMA's 128-byte swizzle of a [rows, 64] bf16 box: K-major, 1024-byte
//    aligned, one k16 step = 32 bytes further.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

// y * a rounded, then + b rounded: no fma, as the plain versions compute it,
// so that x̂ rounds to the same bf16 (an fma flips a bf16 rounding now and then)
__device__ __forceinline__ float affine_relu(float y, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(y, a), b), 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------------
// the box at (c0 innermost, c1) of a 2-D tensor map into shared memory; the
// barrier counts its bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- fences and barriers ------------------------------------------------------
// this thread's generic-proxy writes to shared memory become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// registers per thread of this warpgroup from here on: the producer gives
// registers back, the consumers take them (the kernel's paths must not rejoin)
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma --------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr uint32_t LAYOUT_NONE = 0;   // chunk-major, no swizzle
constexpr uint32_t LAYOUT_SW128 = 1;  // TMA's 128-byte swizzle

// matrix descriptor: start address, leading and stride byte offsets (as
// CUTLASS's make_gmma_desc sets them for the layout), layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major chunk-major tile with R rows: chunks R * 16 bytes apart (LBO), 8-row
// core matrices 128 bytes apart (SBO)
__device__ __forceinline__ uint64_t desc_kmajor_chunks(uint32_t addr, int rows) {
  return make_desc(addr, rows * 16, 128, LAYOUT_NONE);
}

// the same tile read MN-major (channels = M or N, rows = K): 8-channel chunks
// R * 16 bytes apart (SBO), 8-row groups 128 bytes apart (LBO)
__device__ __forceinline__ uint64_t desc_mnmajor_chunks(uint32_t addr, int rows) {
  return make_desc(addr, 128, rows * 16, LAYOUT_NONE);
}

// K-major [rows, 64] bf16 box with TMA's 128-byte swizzle: 8-row groups 1024
// bytes apart
__device__ __forceinline__ uint64_t desc_kmajor_sw128(uint32_t addr) {
  return make_desc(addr, 16, 1024, LAYOUT_SW128);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 accumulators in registers;
// TA/TB: 1 where the operand is MN-major in shared memory, 0 where K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// accumulator element i of an m64nN tile lies at row (warp % 4) * 16 +
// lane / 4 + 8 * ((i / 2) % 2), column (i / 4) * 8 + (lane % 4) * 2 + i % 2

}  // namespace hopper

// ---- host: TMA tensor maps ------------------------------------------------------
namespace hopper_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (so the build needs no link against it)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// map of a row-major [rows, cols] bf16 matrix (cols contiguous, 16-byte
// aligned rows) in boxes of [box_rows, 64] with the 128-byte swizzle; rows
// past the end read as zeros. Returns a cudaError_t value.
inline int map_bf16_sw128(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {cols * 2};
  cuuint32_t box[2] = {64, box_rows};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper_host
