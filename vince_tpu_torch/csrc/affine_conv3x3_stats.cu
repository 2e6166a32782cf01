// Fused BN-apply + ReLU + 3x3 convolution + batch-statistic sums (K3), CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel vince_tpu/ops/pallas/conv_bn_kernel.py
// (_pallas_impl / _kernel). For y_prev [N, H, W, C] bf16, a, b [C] f32 and the
// filter [3, 3, C, F] bf16 (given as the matrix [9C, Fp], Fp = F padded with
// zero columns to a multiple of 128):
//     xh = bf16(relu(a * y_prev + b))      (never written to device memory)
//     y  = bf16(conv3x3(xh, filter))       stride 1, zero padding 1, f32 sums
//     s1 = sum_{n,h,w} y                   of the stored (rounded) y, in f32
//     s2 = sum_{n,h,w} y^2
//
// What bounds it on the H100: operations. 2*9*C*F per output pixel against
// 2(C + F) bytes is far above the card's ~295 bf16 operations per byte at the
// ResNet50 sites (C = F >= 128), so the tensor cores set the least time.
//
// Design. The TPU kernel takes whole images per grid step and carries s1 and
// s2 across the sequential grid. Here a CTA owns a tile of `th` rows by `tw`
// columns of one image and 128 output features. It is an implicit GEMM: for
// each chunk of 128 input channels the tile's halo, (th+2) x (tw+2) pixels,
// goes through the affine + ReLU into shared memory once, stored row by row at
// the padded width pw = tw + 2. An output position p = hl * pw + wl then finds
// its tap (ky, kx) at halo row p + ky * pw + kx, a constant shift, so each of
// the nine taps is a plain [positions x 128] @ [128 x 128] product whose A
// fragments are read from the halo at that shift (WMMA bf16, mma.sync). The
// two padding columns of every row are computed and thrown away, which keeps
// the A tile a constant-stride matrix. The filter streams through shared
// memory in 32-row slabs, three in a cp.async pipeline. The f32 tile is
// staged in shared memory, rounded to bf16 and stored, and the CTA's column
// sums of the rounded values go to per-CTA partials; a second kernel adds the
// partials in a fixed order, so s1 and s2 are bitwise reproducible (no float
// atomics). C must be a multiple of 128; any N, H, W, F launches (F that is
// not a multiple of 8 takes scalar stores). wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int CK = 128;       // input channels per halo chunk
constexpr int LDA = CK + 16;  // halo row (bf16): 288 bytes, so every row is 32-byte aligned
constexpr int BN = 128;       // output features per CTA
constexpr int KSLAB = 32;     // filter rows per shared-memory slab
constexpr int NSTAGE = 3;     // slabs in flight or in use
constexpr int WS_LD = BN + 8;
constexpr int MAX_POS = 128;  // output positions per CTA: 8 row tiles of 16
constexpr int STAGE_LD = BN + 4;
constexpr int PHASES = THREADS / (BN / 8);  // row phases of the epilogue
constexpr int SLABS_PER_CHUNK = 9 * CK / KSLAB;

// y * a rounded, then + b rounded: no fma, as the plain version computes it
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

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

constexpr size_t WS_BYTES = round128(sizeof(__nv_bfloat16) * NSTAGE * KSLAB * WS_LD);
constexpr size_t RED_BYTES = sizeof(float) * 2 * PHASES * BN;

__host__ __device__ inline int halo_rows(int row_tiles, int pw) {
  return row_tiles * 16 + 2 * pw + 2;  // the last row tile's farthest tap
}

// bytes of the region shared by (halo + filter slabs) and the f32 output tile
__host__ __device__ inline size_t union_bytes(int row_tiles, int pw) {
  size_t in = round128(sizeof(__nv_bfloat16) * halo_rows(row_tiles, pw) * LDA) + WS_BYTES;
  size_t stage = sizeof(float) * row_tiles * 16 * STAGE_LD;
  return round128(in > stage ? in : stage);
}

// grid: x = (image, row band, column tile), y = slice of 128 output features
__global__ void __launch_bounds__(THREADS)
acs_main_kernel(const __nv_bfloat16* __restrict__ y_prev, const float* __restrict__ a,
                const float* __restrict__ b, const __nv_bfloat16* __restrict__ kmat,
                __nv_bfloat16* __restrict__ y, float* __restrict__ s1_part,
                float* __restrict__ s2_part, int H, int W, int C, int F, int Fp, int th,
                int tw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int pw = tw + 2;
  const int npos = th * pw;
  const int row_tiles = (npos + 15) / 16;
  const int nrows = halo_rows(row_tiles, pw);
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [nrows][LDA]
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + round128(sizeof(__nv_bfloat16) * nrows * LDA));  // [3][32][136]
  float* stage = reinterpret_cast<float*>(smem_raw);  // [row_tiles*16][132], after the dots
  float* red = reinterpret_cast<float*>(smem_raw + union_bytes(row_tiles, pw));

  const int bands = (H + th - 1) / th;
  const int ctiles = (W + tw - 1) / tw;
  int bid = blockIdx.x;
  const int w0 = (bid % ctiles) * tw;
  bid /= ctiles;
  const int h0 = (bid % bands) * th;
  const int n = bid / bands;
  const int f0 = blockIdx.y * BN;
  const __nv_bfloat16* image = y_prev + (size_t)n * H * W * C;

  const int nslab = (C / CK) * SLABS_PER_CHUNK;
  // slab s: rows [ks*32, ks*32+32) of tap `tap` of channel chunk `chunk`
  auto load_slab = [&](int s) {
    const int chunk = s / SLABS_PER_CHUNK;
    const int tap = (s % SLABS_PER_CHUNK) / (CK / KSLAB);
    const int ks = s % (CK / KSLAB);
    const __nv_bfloat16* src =
        kmat + (size_t)(tap * C + chunk * CK + ks * KSLAB) * Fp + f0;
    __nv_bfloat16* dst = ws + (s % NSTAGE) * KSLAB * WS_LD;
    for (int v = threadIdx.x; v < KSLAB * BN / 8; v += THREADS) {
      int r = v / (BN / 8);
      int c = (v % (BN / 8)) * 8;
      cp_async16(dst + r * WS_LD + c, src + (size_t)r * Fp + c);
    }
    cp_async_commit();
  };
  // an empty group where there is no slab keeps the count of groups the same
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < nslab)
      load_slab(p);
    else
      cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;        // row tiles wm and wm + 4
  const int wn = (warp / 4) * 4;  // first of four 16-column tiles
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int s = 0; s < nslab; ++s) {
    const int chunk = s / SLABS_PER_CHUNK;
    const int tap = (s % SLABS_PER_CHUNK) / (CK / KSLAB);
    const int ks = s % (CK / KSLAB);
    if (s % SLABS_PER_CHUNK == 0) {
      __syncthreads();  // every warp is past the previous chunk's halo
      // xh of this chunk's 128 channels over the halo; zero outside the image
      // (the convolution pads xh, not y_prev) and in the rows past the halo
      const int c = chunk * CK + (threadIdx.x % (CK / 8)) * 8;
      float a8[8], b8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a8[e] = __ldg(a + c + e);
        b8[e] = __ldg(b + c + e);
      }
      for (int row = threadIdx.x / (CK / 8); row < nrows; row += THREADS / (CK / 8)) {
        const int gh = h0 - 1 + row / pw;
        const int gw = w0 - 1 + row % pw;
        __align__(16) __nv_bfloat16 xv[8];
        if (row < (th + 2) * pw && gh >= 0 && gh < H && gw >= 0 && gw < W) {
          uint4 raw = *reinterpret_cast<const uint4*>(image + ((size_t)gh * W + gw) * C + c);
          const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            xv[e] = __float2bfloat16(affine_relu(__bfloat162float(yv[e]), a8[e], b8[e]));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = __float2bfloat16(0.f);
        }
        *reinterpret_cast<uint4*>(halo + row * LDA + (threadIdx.x % (CK / 8)) * 8) =
            *reinterpret_cast<uint4*>(xv);
      }
    }
    cp_async_wait<NSTAGE - 2>();  // slab s has landed
    __syncthreads();              // ... and the halo is written
    // refill the buffer that every warp finished reading in step s - 1
    if (s + NSTAGE - 1 < nslab)
      load_slab(s + NSTAGE - 1);
    else
      cp_async_commit();
    const __nv_bfloat16* slab = ws + (s % NSTAGE) * KSLAB * WS_LD;
    const int shift = (tap / 3) * pw + tap % 3;
#pragma unroll
    for (int kk = 0; kk < KSLAB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (wm + 4 * i < row_tiles)
          wmma::load_matrix_sync(
              fa[i], halo + ((wm + 4 * i) * 16 + shift) * LDA + ks * KSLAB + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, slab + kk * WS_LD + (wn + j) * 16, WS_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (wm + 4 * i < row_tiles) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last read of the halo and the slabs
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (wm + 4 * i < row_tiles)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(stage + (wm + 4 * i) * 16 * STAGE_LD + (wn + j) * 16,
                                acc[i][j], STAGE_LD, wmma::mem_row_major);
  __syncthreads();

  // round, store, and sum the rounded values: a thread keeps one group of 8
  // features for the positions of its phase
  const int fg = threadIdx.x % (BN / 8);
  const int phase = threadIdx.x / (BN / 8);
  const int f = f0 + fg * 8;
  float sum8[8], sq8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum8[e] = sq8[e] = 0.f;
  for (int p = phase; p < npos; p += PHASES) {
    const int wl = p % pw;
    const int gh = h0 + p / pw;
    const int gw = w0 + wl;
    if (wl >= tw || gh >= H || gw >= W) continue;  // a padding column or past the image
    const float* src = stage + p * STAGE_LD + fg * 8;
    __align__(16) __nv_bfloat16 yv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      yv[e] = __float2bfloat16(src[e]);
      float v = __bfloat162float(yv[e]);
      sum8[e] += v;
      sq8[e] += v * v;
    }
    __nv_bfloat16* dst = y + (((size_t)n * H + gh) * W + gw) * F + f;
    if (F % 8 == 0) {
      if (f < F) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(yv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (f + e < F) dst[e] = yv[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[phase * BN + fg * 8 + e] = sum8[e];
    red[(PHASES + phase) * BN + fg * 8 + e] = sq8[e];
  }
  __syncthreads();
  if (threadIdx.x < BN) {  // fixed-order sum over the phases
    float t1 = 0.f, t2 = 0.f;
    for (int p = 0; p < PHASES; ++p) {
      t1 += red[p * BN + threadIdx.x];
      t2 += red[(PHASES + p) * BN + threadIdx.x];
    }
    s1_part[(size_t)blockIdx.x * Fp + f0 + threadIdx.x] = t1;
    s2_part[(size_t)blockIdx.x * Fp + f0 + threadIdx.x] = t2;
  }
}

// fixed-order sums of the per-CTA partials: 8 segments per feature, then the 8
constexpr int RED_SEGS = 8;

__global__ void __launch_bounds__(THREADS)
acs_reduce_kernel(const float* __restrict__ s1_part, const float* __restrict__ s2_part,
                  float* __restrict__ s1, float* __restrict__ s2, int F, int Fp, int nparts) {
  __shared__ float red[2][RED_SEGS][32];
  const int fl = threadIdx.x % 32;
  const int seg = threadIdx.x / 32;
  const int f = blockIdx.x * 32 + fl;
  const int per = (nparts + RED_SEGS - 1) / RED_SEGS;
  float t1 = 0.f, t2 = 0.f;
  if (f < F) {
    const int end = min(nparts, (seg + 1) * per);
    for (int p = seg * per; p < end; ++p) {
      t1 += s1_part[(size_t)p * Fp + f];
      t2 += s2_part[(size_t)p * Fp + f];
    }
  }
  red[0][seg][fl] = t1;
  red[1][seg][fl] = t2;
  __syncthreads();
  if (seg == 0 && f < F) {
    t1 = t2 = 0.f;
    for (int g = 0; g < RED_SEGS; ++g) {
      t1 += red[0][g][fl];
      t2 += red[1][g][fl];
    }
    s1[f] = t1;
    s2[f] = t2;
  }
}

}  // namespace

// y_prev [N, H, W, C] bf16, a, b [C] f32, kmat [9C, Fp] bf16 (row (ky*3+kx)*C + c;
// Fp = F rounded up to a multiple of 128, the added columns zero), all
// contiguous. Outputs y [N, H, W, F] bf16, s1, s2 [F] f32. Scratch s1_part,
// s2_part [N * ceil(H/th) * ceil(W/tw), Fp] f32. th x tw is a CTA's tile of
// output pixels, th * (tw + 2) <= 128.
extern "C" int vince_affine_conv3x3_stats_bf16(
    const void* y_prev, const float* a, const float* b, const void* kmat, void* y, float* s1,
    float* s2, float* s1_part, float* s2_part, int N, int H, int W, int C, int F, int Fp,
    int th, int tw, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % CK || Fp % BN || Fp < F ||
      th <= 0 || tw <= 0 || (long long)th * (tw + 2) > MAX_POS)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y_prev) % 16 || reinterpret_cast<uintptr_t>(kmat) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long nparts = (long long)N * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  if (nparts > 2147483647LL || Fp / BN > 65535) return (int)cudaErrorInvalidValue;
  const int row_tiles = (th * (tw + 2) + 15) / 16;
  const size_t smem = union_bytes(row_tiles, tw + 2) + RED_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      acs_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nparts, Fp / BN);
  acs_main_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(y_prev), a, b, static_cast<const __nv_bfloat16*>(kmat),
      static_cast<__nv_bfloat16*>(y), s1_part, s2_part, H, W, C, F, Fp, th, tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  acs_reduce_kernel<<<(F + 31) / 32, THREADS, 0, stream>>>(s1_part, s2_part, s1, s2, F, Fp,
                                                           (int)nparts);
  return (int)cudaGetLastError();
}
