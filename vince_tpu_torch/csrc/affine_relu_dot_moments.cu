// Fused BN-apply + ReLU + 1x1 dot + input moments (K2), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel vince_tpu/ops/pallas/folded_dot_kernel.py
// (_pallas_impl / _kernel). For y [M, C] bf16, a, b [C] f32 and W [C, F] bf16:
//     xh32 = relu(a * y + b)          (f32, never written to device memory)
//     out  = bf16(xh @ W)             xh = bf16(xh32), f32 accumulation
//     s1   = sum_rows xh32            (from the f32 xh, before rounding)
//     s2   = xh^T xh                  (bf16 xh, f32 accumulation)
//
// What bounds it on the H100: bytes at stages 2 and 3, operations at stage 4.
// At the ResNet50 sites the output [M, F] bf16 is 4x the input; e.g. stage 2
// (M=100352, C=128, F=512) moves 129 MB for 16 GFLOP, so 3.35 TB/s, not the
// 989 TFLOP/s bf16 rate, sets the least time. The design keeps xh out of
// device memory and feeds the tensor cores through WMMA bf16 fragments
// (mma.sync) read from shared memory; wgmma and TMA come later.
//
// Design. On the TPU the grid runs in order and carries s1 and s2 across row
// blocks in VMEM. Here blocks run in parallel, and s2 is up to [512, 512] f32,
// too large to keep per block. So the work is three launches:
//   1. main: one CTA per (64 rows, 128 output columns) applies the affine +
//      ReLU into shared memory and runs its slice of the main dot. W's slice
//      streams through shared memory in 32-row slabs, three in a cp.async
//      pipeline, so that the eight warps share each slab (reading W fragments
//      straight from L2 made every warp fetch them again and left the kernel
//      bound by L2 traffic). The CTAs of the first column slice also write
//      their column sums of the f32 xh (s1 partials). Splitting F over the
//      grid keeps the SMs busy at stage 4 (98 row blocks, F=2048), at the cost
//      of re-reading each y row block F/128 times, from L2;
//   2. moments: s2 is tiled into 128 x 128 blocks (upper triangle only, the
//      matrix is symmetric) and each tile is split over M; a CTA recomputes
//      xh for its two column strips, 64 rows at a time, and accumulates
//      xh_i^T xh_j. The next rows' y is loaded into registers while the tensor
//      cores work on the current ones;
//   3. reduce: sums the partials of s1 and s2 in a fixed order.
// Partials plus a second pass, not float atomics, so that s1 and s2 are
// bitwise reproducible from run to run; the scratch is at most a few MB per
// site. Moments re-read y once per column strip; at these shapes y fits in
// the 50 MB L2. Rows past M are masked to xh = 0. F must be a multiple of
// 128, C a multiple of 128 up to 1024 (the [64, C] block of xh fits in shared
// memory), and y, W and out 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int MAIN_ROWS = 64;
constexpr int MAIN_FCHUNK = 128;
constexpr int MAIN_STAGE_LD = MAIN_FCHUNK + 4;
constexpr int KSLAB = 32;               // W rows per shared-memory slab
constexpr int NSTAGE = 3;               // slabs in flight or in use
constexpr int WS_LD = MAIN_FCHUNK + 8;  // padded slab row (bf16)
constexpr int TILE = 128;     // s2 tile edge
constexpr int MOM_ROWS = 64;  // rows per step of the moments loop
constexpr int MOM_LD = TILE + 8;
constexpr int MOM_STAGE_LD = TILE + 4;
constexpr int MOM_VECS = MOM_ROWS * TILE / 8 / THREADS;  // 8-column vectors per thread

// y * a rounded, then + b rounded: no fma, as the plain version computes it,
// so that xh rounds to the same bf16 (an fma flips a bf16 rounding now and
// then, which moves s2 by up to ~1e-4 of its largest entry at small M)
__device__ __forceinline__ float affine_relu(float y, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(y, a), b), 0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [k0, k0 + KSLAB) of W's column slice [f0, f0 + 128) into ws, one group
__device__ __forceinline__ void load_w_slab(const __nv_bfloat16* __restrict__ w,
                                            __nv_bfloat16* ws, int k0, int f0, int F) {
  for (int v = threadIdx.x; v < KSLAB * MAIN_FCHUNK / 8; v += THREADS) {
    int r = v / (MAIN_FCHUNK / 8);
    int c = (v % (MAIN_FCHUNK / 8)) * 8;
    cp_async16(ws + r * WS_LD + c, w + (size_t)(k0 + r) * F + f0 + c);
  }
  cp_async_commit();
}

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// bytes of the main kernel's shared memory regions for a given C
__host__ __device__ inline size_t main_union_bytes(int C) {
  size_t xs = sizeof(__nv_bfloat16) * MAIN_ROWS * (C + 8);
  size_t stage = sizeof(float) * MAIN_ROWS * MAIN_STAGE_LD;
  return round128(xs > stage ? xs : stage);
}
constexpr size_t MAIN_WS_BYTES = round128(sizeof(__nv_bfloat16) * NSTAGE * KSLAB * WS_LD);
constexpr size_t MAIN_RED_BYTES = sizeof(float) * THREADS * 8;  // (THREADS / (C/8)) * C

// ---- 1. main: out and s1 partials -------------------------------------------
__global__ void __launch_bounds__(THREADS)
ardm_main_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ a,
                 const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ s1_part,
                 int M, int C, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = C + 8;
  const size_t ub = main_union_bytes(C);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][C+8]
  float* stage = reinterpret_cast<float*>(smem_raw);  // [64][132], after the dot
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw + ub);  // [3][32][136]
  float* red = reinterpret_cast<float*>(smem_raw + ub + MAIN_WS_BYTES);

  const int row0 = blockIdx.x * MAIN_ROWS;
  const int f0 = blockIdx.y * MAIN_FCHUNK;
  const int nslab = C / KSLAB;
  // the first slabs are in flight during the affine pass; an empty group
  // where there is no slab keeps the count of groups the same for every C
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < nslab)
      load_w_slab(w, ws + p * KSLAB * WS_LD, p * KSLAB, f0, F);
    else
      cp_async_commit();
  }

  // each thread keeps one column group of 8 for all its rows; where THREADS
  // is not a multiple of the C / 8 groups (C = 384, 640, 768, 896), the
  // threads past nphase * groups sit out this pass
  const int groups = C / 8;
  const int g = threadIdx.x % groups;
  const int phase = threadIdx.x / groups;
  const int nphase = THREADS / groups;

  if (phase < nphase) {
    float a8[8], b8[8], sum8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      a8[e] = a[g * 8 + e];
      b8[e] = b[g * 8 + e];
      sum8[e] = 0.f;
    }
    for (int r = phase; r < MAIN_ROWS; r += nphase) {
      int gr = row0 + r;
      __align__(16) __nv_bfloat16 xv[8];
      if (gr < M) {
        uint4 raw = *reinterpret_cast<const uint4*>(y + (size_t)gr * C + g * 8);
        const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = affine_relu(__bfloat162float(yv[e]), a8[e], b8[e]);
          sum8[e] += v;
          xv[e] = __float2bfloat16(v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(xs + r * ldx + g * 8) = *reinterpret_cast<uint4*>(xv);
    }
    // s1: fixed-order sum over the phases that share a column group
#pragma unroll
    for (int e = 0; e < 8; ++e) red[phase * C + g * 8 + e] = sum8[e];
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float acc = 0.f;
      for (int p = 0; p < nphase; ++p) acc += red[p * C + c];
      s1_part[(size_t)blockIdx.x * C + c] = acc;
    }
  }

  const int warp = threadIdx.x / 32;
  const int rw = warp % 4;         // 16-row group
  const int cg = (warp / 4) * 4;   // first of four 16-column fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<NSTAGE - 2>();  // slab s has landed
    __syncthreads();
    // refill the buffer that every warp finished reading in step s - 1
    const int next = s + NSTAGE - 1;
    if (next < nslab)
      load_w_slab(w, ws + (next % NSTAGE) * KSLAB * WS_LD, next * KSLAB, f0, F);
    else
      cp_async_commit();
    const __nv_bfloat16* slab = ws + (s % NSTAGE) * KSLAB * WS_LD;
#pragma unroll
    for (int kk = 0; kk < KSLAB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, xs + rw * 16 * ldx + s * KSLAB + kk, ldx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, slab + kk * WS_LD + (cg + j) * 16, WS_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();
  // every warp is past its last read of xs: stage the tile over it
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(stage + rw * 16 * MAIN_STAGE_LD + (cg + j) * 16, acc[j],
                            MAIN_STAGE_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < MAIN_ROWS * MAIN_FCHUNK / 8; idx += THREADS) {
    int r = idx / (MAIN_FCHUNK / 8);
    int c = (idx % (MAIN_FCHUNK / 8)) * 8;
    int gr = row0 + r;
    if (gr < M) {
      const float* src = stage + r * MAIN_STAGE_LD + c;
      __align__(16) __nv_bfloat162 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
      *reinterpret_cast<uint4*>(out + (size_t)gr * F + f0 + c) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---- 2. moments: s2 tile partials -------------------------------------------
// Each thread owns MOM_VECS vectors of 8 columns of a MOM_ROWS x TILE strip;
// its column is the same for all of them (THREADS is a multiple of TILE / 8).
struct StripRegs {
  uint4 raw[MOM_VECS];
};

__device__ __forceinline__ void fetch_strip(const __nv_bfloat16* __restrict__ y,
                                            StripRegs& regs, int r0, int col0, int r_end,
                                            int C) {
#pragma unroll
  for (int i = 0; i < MOM_VECS; ++i) {
    int v = threadIdx.x + i * THREADS;
    int gr = r0 + v / (TILE / 8);
    int c = (v % (TILE / 8)) * 8;
    regs.raw[i] = gr < r_end ? *reinterpret_cast<const uint4*>(y + (size_t)gr * C + col0 + c)
                             : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_strip(const StripRegs& regs, const float* __restrict__ a,
                                            const float* __restrict__ b, __nv_bfloat16* dst,
                                            int r0, int col0, int r_end) {
  const int c = (threadIdx.x % (TILE / 8)) * 8;  // the same for every vector
  float a8[8], b8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    a8[e] = __ldg(a + col0 + c + e);
    b8[e] = __ldg(b + col0 + c + e);
  }
#pragma unroll
  for (int i = 0; i < MOM_VECS; ++i) {
    int r = (threadIdx.x + i * THREADS) / (TILE / 8);
    __align__(16) __nv_bfloat16 xv[8];
    const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&regs.raw[i]);
    bool valid = r0 + r < r_end;  // rows past r_end belong to the next split
#pragma unroll
    for (int e = 0; e < 8; ++e)
      xv[e] = __float2bfloat16(valid ? affine_relu(__bfloat162float(yv[e]), a8[e], b8[e])
                                     : 0.f);
    *reinterpret_cast<uint4*>(dst + r * MOM_LD + c) = *reinterpret_cast<uint4*>(xv);
  }
}

__global__ void __launch_bounds__(THREADS)
ardm_moments_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ s2_part, int M,
                    int C, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xi = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][136]
  __nv_bfloat16* xj = xi + MOM_ROWS * MOM_LD;                      // [64][136]
  float* stage = reinterpret_cast<float*>(smem_raw);  // [128][132], after the loop

  // blockIdx.x enumerates the upper-triangle tile pairs (ti <= tj)
  const int T = C / TILE;
  int ti = 0, rem = blockIdx.x;
  while (rem >= T - ti) {
    rem -= T - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);

  const int warp = threadIdx.x / 32;  // owns output rows [16*warp, 16*warp+16)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  StripRegs ri, rj;
  fetch_strip(y, ri, r_begin, ti * TILE, r_end, C);
  if (!diag) fetch_strip(y, rj, r_begin, tj * TILE, r_end, C);
  for (int r0 = r_begin; r0 < r_end; r0 += MOM_ROWS) {
    __syncthreads();  // the previous rows are consumed
    store_strip(ri, a, b, xi, r0, ti * TILE, r_end);
    if (!diag) store_strip(rj, a, b, xj, r0, tj * TILE, r_end);
    __syncthreads();
    if (r0 + MOM_ROWS < r_end) {  // next rows in flight during the products
      fetch_strip(y, ri, r0 + MOM_ROWS, ti * TILE, r_end, C);
      if (!diag) fetch_strip(y, rj, r0 + MOM_ROWS, tj * TILE, r_end, C);
    }
    const __nv_bfloat16* xjs = diag ? xi : xj;
#pragma unroll
    for (int k = 0; k < MOM_ROWS; k += 16) {
      // A = xi^T: element (m, k) = xi[k][m] -> column-major view of xi
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, xi + k * MOM_LD + warp * 16, MOM_LD);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, xjs + k * MOM_LD + j * 16, MOM_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();  // every warp is past its last read of xi and xj
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * MOM_STAGE_LD + j * 16, acc[j],
                            MOM_STAGE_LD, wmma::mem_row_major);
  __syncthreads();
  float* dst = s2_part + (size_t)split * C * C;
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    int r = idx / TILE, c = idx % TILE;
    dst[(size_t)(ti * TILE + r) * C + tj * TILE + c] = stage[r * MOM_STAGE_LD + c];
  }
  if (!diag) {
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      int c = idx / TILE, r = idx % TILE;
      dst[(size_t)(tj * TILE + c) * C + ti * TILE + r] = stage[r * MOM_STAGE_LD + c];
    }
  }
}

// ---- 3. reduce: fixed-order sums of the partials -----------------------------
__global__ void ardm_reduce_kernel(const float* __restrict__ s1_part,
                                   const float* __restrict__ s2_part,
                                   float* __restrict__ s1, float* __restrict__ s2,
                                   int C, int n1, int n2) {
  const size_t cc = (size_t)C * C;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < cc + C;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (e < cc) {
      for (int p = 0; p < n2; ++p) acc += s2_part[(size_t)p * cc + e];
      s2[e] = acc;
    } else {
      size_t c = e - cc;
      for (int p = 0; p < n1; ++p) acc += s1_part[(size_t)p * C + c];
      s1[c] = acc;
    }
  }
}

}  // namespace

// y [M, C] bf16, a, b [C] f32, w [C, F] bf16, all contiguous. Outputs out
// [M, F] bf16, s1 [C] f32, s2 [C, C] f32. Scratch s1_part [ceil(M/64), C] and
// s2_part [msplit, C, C] f32, with msplit * rows_per_split >= M,
// rows_per_split a multiple of 64.
extern "C" int vince_affine_relu_dot_moments_bf16(
    const void* y, const float* a, const float* b, const void* w, void* out,
    float* s1, float* s2, float* s1_part, float* s2_part, int M, int C, int F,
    int msplit, int rows_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M <= 0 || C <= 0 || F <= 0 || C % TILE || F % MAIN_FCHUNK || C > 1024 ||
      rows_per_split % MOM_ROWS || (long long)msplit * rows_per_split < M)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);

  const int nblk = (M + MAIN_ROWS - 1) / MAIN_ROWS;
  size_t main_smem = main_union_bytes(C) + MAIN_WS_BYTES + MAIN_RED_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ardm_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)main_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 main_grid(nblk, F / MAIN_FCHUNK);
  ardm_main_kernel<<<main_grid, THREADS, main_smem, stream>>>(
      yb, a, b, wb, static_cast<__nv_bfloat16*>(out), s1_part, M, C, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int T = C / TILE;
  size_t strips = sizeof(__nv_bfloat16) * 2 * MOM_ROWS * MOM_LD;
  size_t mstage = sizeof(float) * TILE * MOM_STAGE_LD;
  size_t mom_smem = strips > mstage ? strips : mstage;
  err = cudaFuncSetAttribute(ardm_moments_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mom_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 mgrid(T * (T + 1) / 2, msplit);
  ardm_moments_kernel<<<mgrid, THREADS, mom_smem, stream>>>(yb, a, b, s2_part, M, C,
                                                           rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  size_t total = (size_t)C * C + C;
  int rblocks = (int)((total + THREADS - 1) / THREADS);
  ardm_reduce_kernel<<<rblocks, THREADS, 0, stream>>>(s1_part, s2_part, s1, s2, C, nblk,
                                                      msplit);
  return (int)cudaGetLastError();
}
