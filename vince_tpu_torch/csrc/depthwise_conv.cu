// Stride-1 depthwise k x k convolution (K4), k in {3, 5}, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel vince_tpu/ops/pallas/depthwise_kernel.py
// (_dw_pallas / _dw_kernel). For x [N, H, W, C] and w [k, k, 1, C], both bf16
// (or both f32), with zero padding (k-1)/2 on every side:
//     out[n, h, w, c] = round( sum_{i, j} f32(xp[n, h+i, w+j, c]) * f32(w[i, j, c]) )
// with the k*k products and the sum in f32, taken row-major (i, then j), and
// one rounding to the output type. The backward's dx is this same kernel on
// the output cotangent with the filter flipped in both spatial dimensions.
//
// Rounding. Every product is rounded (__fmul_rn) and then added (__fadd_rn),
// with no fma contraction and in the plain PyTorch version's order, so the
// kernel equals that version bit for bit (up to the sign of a zero). An fma
// would halve the arithmetic but lands now and then on the other side of a
// bf16 rounding boundary.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (4 bytes in bf16) for 2 k*k f32 operations, far below the card's
// operations per byte; the design reads every input row once per row band
// instead of k times.
//
// Design. The TPU kernel holds a whole padded image in VMEM and sweeps the
// taps over it. Here a thread owns VEC neighbouring channels of one output
// column and walks down a band of rows. For every input row it loads the k
// neighbouring columns once and adds that row's k products into k rolling
// accumulators, one for each output row that the input row touches; the
// accumulator whose last tap row this was is stored, and the others move up.
// An output row therefore still receives its taps in the order i = 0..k-1,
// j = 0..k-1. The k*k weights of the thread's channels stay in registers.
// A CTA is a tile of `tcv` channel vectors (the fast thread index, so that a
// warp reads contiguous channels) by 256 / tcv columns; the column taps of
// neighbouring threads hit L1. The grid covers (image, row band) x channel
// slices x column tiles, so any N, H, W, C launches. Ragged edges are masked.
// VEC is 2 where C is even, else 1 (4 channels a thread made the k = 3 sites
// slower and leaves no registers for k = 5's 25 weights per channel). The
// next row's loads are issued before the current row's arithmetic. Flat
// offsets are size_t.
//
// The filter gradient (dw_wgrad_kernel, below) takes the place of the k*k
// shifted multiply-reduces that the JAX VJP leaves to XLA (_wgrad in the same
// file): dw[i, j, c] = sum_{n, h, w} round(xp[n, h+i, w+j, c] * g[n, h, w, c]),
// each product rounded to the tensors' type as there, the sum in f32. It
// walks the rows the same way with a rolling window of k rows of g, keeps the
// k*k sums of its channels in registers, adds the CTA's columns in shared
// memory in a fixed order and writes one partial per (image, row band); a
// second kernel adds the partials in a fixed order (no float atomics, so dw is
// bitwise reproducible). It reads x and g once instead of k*k times. For
// k = 3 a thread takes 4 channels where C % 4 = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (VEC == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else if constexpr (VEC == 2) {
    float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// A thread's K column taps around its column: the offset of each from the
// start of a row of one image, and whether it lies inside the image. They do
// not change from row to row, so the row loop adds one stride to one pointer.
template <int K>
struct ColumnTaps {
  int off[K];  // within one row: below 2^31, checked at the entry points
  bool inside[K];
  __device__ __forceinline__ ColumnTaps(int col, int W, int C) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int cc = col + j - (K - 1) / 2;
      inside[j] = cc >= 0 && cc < W;
      off[j] = cc * C;
    }
  }
};

// the taps of the row that starts at `row`; zero outside the image
template <typename T, int K, int VEC>
__device__ __forceinline__ void load_taps(const T* row, const ColumnTaps<K>& col_taps,
                                          float (&taps)[K][VEC]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (col_taps.inside[j]) {
      load_vec<VEC>(row + col_taps.off[j], taps[j]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) taps[j][e] = 0.f;
    }
  }
}

// grid: x = image * bands + band, y = channel slice, z = column tile
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
          int H, int W, int C, int tcv, int band_rows) {
  constexpr int P = (K - 1) / 2;
  const int bands = (H + band_rows - 1) / band_rows;
  const int n = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int cv = blockIdx.y * tcv + threadIdx.x % tcv;
  const int col = blockIdx.z * (THREADS / tcv) + threadIdx.x / tcv;
  const int c0 = cv * VEC;
  if (c0 >= C || col >= W) return;  // the kernel has no barrier
  const int h0 = band * band_rows;
  const int h1 = min(H, h0 + band_rows);

  float wk[K][K][VEC];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) load_vec<VEC>(w + (size_t)(i * K + j) * C + c0, wk[i][j]);

  const size_t image = (size_t)n * H * W * C;
  const T* xn = x + image + c0;
  T* on = out + image + c0;

  // acc[i]: the output row for which the current input row is tap row i
  float acc[K][VEC];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  // rows before the image add nothing, so the walk starts at the first real
  // row; the next row's taps are loaded before this row's arithmetic, which
  // keeps two rows of loads in flight
  const int r_lo = max(h0 - P, 0);
  const int r_hi = min(h1 + P, H);
  const ColumnTaps<K> col_taps(col, W, C);
  const ptrdiff_t row_stride = (ptrdiff_t)W * C;
  const T* next_row = xn + r_lo * row_stride;  // the row to load next
  T* done_out = on + (r_lo - P) * row_stride + (ptrdiff_t)col * C;  // output row r - P
  float cur[K][VEC], nxt[K][VEC];
  load_taps<T, K, VEC>(next_row, col_taps, cur);
  for (int r = r_lo; r < h1 + P; ++r) {
    next_row += row_stride;
    if (r + 1 < r_hi) load_taps<T, K, VEC>(next_row, col_taps, nxt);
    if (r < r_hi) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int h = r - i + P;  // the output row of slot i
        if (h >= h0 && h < h1) {
#pragma unroll
          for (int j = 0; j < K; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(cur[j][e], wk[i][j][e]));
        }
      }
    }
    // output row r - P had its last tap row in r
    if (r - P >= h0 && r - P < h1) store_vec<VEC>(done_out, acc[K - 1]);
    done_out += row_stride;
#pragma unroll
    for (int i = K - 1; i > 0; --i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = acc[i - 1][e];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[0][e] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) cur[j][e] = nxt[j][e];
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, void* out, int N, int H, int W, int C,
                   int vec, int tcv, int band_rows, cudaStream_t stream) {
  const int cvn = C / vec;
  const int bands = (H + band_rows - 1) / band_rows;
  const int tw = THREADS / tcv;
  const long long gx = (long long)N * bands;
  const int gy = (cvn + tcv - 1) / tcv, gz = (W + tw - 1) / tw;
  if (gx > 2147483647LL || gy > 65535 || gz > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, gy, gz);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (vec == 2)
    dw_kernel<T, K, 2><<<grid, THREADS, 0, stream>>>(xt, wt, ot, H, W, C, tcv, band_rows);
  else
    dw_kernel<T, K, 1><<<grid, THREADS, 0, stream>>>(xt, wt, ot, H, W, C, tcv, band_rows);
  return cudaGetLastError();
}

// ---- filter gradient ---------------------------------------------------------
// the product as the tensors' type holds it, widened again
template <typename T>
__device__ __forceinline__ float rounded_product(float a, float b) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(__fmul_rn(a, b)));
  } else {
    return __fmul_rn(a, b);
  }
}

// grid: x = image * bands + band, y = channel slice; the CTA loops over its
// column tiles. part [gridDim.x, K*K, C] f32.
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(THREADS)
dw_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                int H, int W, int C, int tcv, int band_rows) {
  constexpr int P = (K - 1) / 2;
  constexpr int TAPS = K * K * VEC;
  extern __shared__ float red[];  // [TAPS][THREADS]
  const int bands = (H + band_rows - 1) / band_rows;
  const int n = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int tw = THREADS / tcv;
  const int c0 = (blockIdx.y * tcv + threadIdx.x % tcv) * VEC;
  const int h0 = band * band_rows;
  const int h1 = min(H, h0 + band_rows);

  float acc[K][K][VEC];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][j][e] = 0.f;

  if (c0 < C) {
    const size_t image = (size_t)n * H * W * C;
    const T* xn = x + image + c0;
    const T* gn = g + image + c0;
    for (int col = threadIdx.x / tcv; col < W; col += tw) {
      // gwin[i]: g's row r - i + P at this column, zero outside the band
      float gwin[K][VEC];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) gwin[i][e] = 0.f;
      // x's row r meets g's rows r - P .. r + P; g's rows outside the band
      // are another CTA's, so only x's rows h0 - P .. h1 - 1 + P matter, and
      // those outside the image are zero. The next step's loads go out
      // before this step's arithmetic.
      const int r_lo = max(h0 - P, 0);
      const int r_hi = min(h1 + P, H);
      const ColumnTaps<K> col_taps(col, W, C);
      const ptrdiff_t row_stride = (ptrdiff_t)W * C;
      const T* gcol = gn + (ptrdiff_t)col * C;
      float cur[K][VEC], nxt[K][VEC], gnew[VEC], gnxt[VEC];
#pragma unroll
      for (int i = 1; i < K; ++i) {  // g's rows r_lo - i + P that lie in the band
        const int h = r_lo - i + P;
        if (h >= h0 && h < h1) load_vec<VEC>(gcol + h * row_stride, gwin[i]);
      }
      const T* next_row = xn + r_lo * row_stride;        // x's row to load next
      const T* next_g = gcol + (r_lo + P) * row_stride;  // g's row to load next
      load_taps<T, K, VEC>(next_row, col_taps, cur);
#pragma unroll
      for (int e = 0; e < VEC; ++e) gnew[e] = gnxt[e] = 0.f;
      if (r_lo + P < h1) load_vec<VEC>(next_g, gnew);
      for (int r = r_lo; r < r_hi; ++r) {
        next_row += row_stride;
        next_g += row_stride;
        if (r + 1 < r_hi) {
          load_taps<T, K, VEC>(next_row, col_taps, nxt);
          if (r + 1 + P < h1) {
            load_vec<VEC>(next_g, gnxt);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) gnxt[e] = 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) gwin[0][e] = gnew[e];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int h = r - i + P;  // the row of g that meets x's row r at tap row i
          if (h >= h0 && h < h1) {
#pragma unroll
            for (int j = 0; j < K; ++j)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[i][j][e] += rounded_product<T>(cur[j][e], gwin[i][e]);
          }
        }
#pragma unroll
        for (int i = K - 1; i > 0; --i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) gwin[i][e] = gwin[i - 1][e];
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) cur[j][e] = nxt[j][e];
#pragma unroll
        for (int e = 0; e < VEC; ++e) gnew[e] = gnxt[e];
      }
    }
  }

  // the CTA's columns, added in a fixed order
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[((i * K + j) * VEC + e) * THREADS + threadIdx.x] = acc[i][j][e];
  __syncthreads();
  for (int o = threadIdx.x; o < TAPS * tcv; o += THREADS) {
    const int t = o / tcv;
    const int cvl = o % tcv;
    const int c = (blockIdx.y * tcv + cvl) * VEC + t % VEC;
    if (c >= C) continue;
    float sum = 0.f;
    for (int wl = 0; wl < tw; ++wl) sum += red[t * THREADS + wl * tcv + cvl];
    part[((size_t)blockIdx.x * K * K + t / VEC) * C + c] = sum;
  }
}

// dw[o] = the partials of output o (a tap and a channel) in a fixed order:
// 8 segments per output, then the 8
constexpr int RED_SEGS = 8;

__global__ void __launch_bounds__(THREADS)
dw_wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int outputs,
                       int nparts) {
  __shared__ float red[RED_SEGS][32];
  const int ol = threadIdx.x % 32;
  const int seg = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + ol;
  const int per = (nparts + RED_SEGS - 1) / RED_SEGS;
  float t = 0.f;
  if (o < outputs) {
    const int end = min(nparts, (seg + 1) * per);
    for (int p = seg * per; p < end; ++p) t += part[(size_t)p * outputs + o];
  }
  red[seg][ol] = t;
  __syncthreads();
  if (seg == 0 && o < outputs) {
    t = 0.f;
    for (int s = 0; s < RED_SEGS; ++s) t += red[s][ol];
    dw[o] = t;
  }
}

template <typename T, int K, int VEC>
cudaError_t launch_wgrad_vec(const T* x, const T* g, float* part, int H, int W, int C,
                             int tcv, int band_rows, dim3 grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * K * K * VEC * THREADS;
  cudaError_t err = cudaFuncSetAttribute(dw_wgrad_kernel<T, K, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dw_wgrad_kernel<T, K, VEC><<<grid, THREADS, smem, stream>>>(x, g, part, H, W, C, tcv,
                                                              band_rows);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_wgrad(const void* x, const void* g, float* part, float* dw, int N, int H,
                         int W, int C, int vec, int tcv, int band_rows, cudaStream_t stream) {
  const int cvn = C / vec;
  const long long nparts = (long long)N * ((H + band_rows - 1) / band_rows);
  const int gy = (cvn + tcv - 1) / tcv;
  if (nparts > 2147483647LL || gy > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nparts, gy);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (K == 3) {
    if (vec == 4)
      err = launch_wgrad_vec<T, K, 4>(xt, gt, part, H, W, C, tcv, band_rows, grid, stream);
  }
  if (vec == 2)
    err = launch_wgrad_vec<T, K, 2>(xt, gt, part, H, W, C, tcv, band_rows, grid, stream);
  else if (vec == 1)
    err = launch_wgrad_vec<T, K, 1>(xt, gt, part, H, W, C, tcv, band_rows, grid, stream);
  if (err != cudaSuccess) return err;
  const int outputs = K * K * C;
  dw_wgrad_reduce_kernel<<<(outputs + 31) / 32, THREADS, 0, stream>>>(part, dw, outputs,
                                                                      (int)nparts);
  return cudaGetLastError();
}

}  // namespace

// vec channels per thread: 1, 2 or (the filter gradient for k = 3 only) 4,
// dividing C; the pointers aligned to vec elements
static bool bad_arguments(int N, int H, int W, int C, int k, int vec, int max_vec, int tcv,
                          int band_rows) {
  return N <= 0 || H <= 0 || W <= 0 || C <= 0 || (k != 3 && k != 5) || H < k || W < k ||
         (long long)(W + k) * C > 2147483647LL ||  // ColumnTaps' offsets are ints
         (vec != 1 && vec != 2 && vec != 4) || vec > max_vec || C % vec || tcv <= 0 ||
         tcv > THREADS || (tcv & (tcv - 1)) || band_rows <= 0;
}

static bool misaligned(const void* p, int vec, int is_bf16) {
  return reinterpret_cast<uintptr_t>(p) % (vec * (is_bf16 ? 2 : 4)) != 0;
}

// x, out [N, H, W, C] and w [k, k, 1, C], contiguous, all bf16 (is_bf16 != 0)
// or all f32. tcv: channel vectors per CTA, a power of two up to 256;
// band_rows: output rows each CTA walks down.
extern "C" int vince_depthwise_conv(const void* x, const void* w, void* out, int N, int H,
                                    int W, int C, int k, int is_bf16, int vec, int tcv,
                                    int band_rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_arguments(N, H, W, C, k, vec, 2, tcv, band_rows)) return (int)cudaErrorInvalidValue;
  if (misaligned(x, vec, is_bf16) || misaligned(w, vec, is_bf16) ||
      misaligned(out, vec, is_bf16))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err;
  if (is_bf16)
    err = k == 3
              ? launch<__nv_bfloat16, 3>(x, w, out, N, H, W, C, vec, tcv, band_rows, stream)
              : launch<__nv_bfloat16, 5>(x, w, out, N, H, W, C, vec, tcv, band_rows, stream);
  else
    err = k == 3 ? launch<float, 3>(x, w, out, N, H, W, C, vec, tcv, band_rows, stream)
                 : launch<float, 5>(x, w, out, N, H, W, C, vec, tcv, band_rows, stream);
  return (int)err;
}

// x, g [N, H, W, C] contiguous, both bf16 (is_bf16 != 0) or both f32; dw
// [k, k, 1, C] f32. Scratch part [N * ceil(H / band_rows), k * k, C] f32.
extern "C" int vince_depthwise_wgrad(const void* x, const void* g, float* part, float* dw,
                                     int N, int H, int W, int C, int k, int is_bf16, int vec,
                                     int tcv, int band_rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_arguments(N, H, W, C, k, vec, k == 3 ? 4 : 2, tcv, band_rows))
    return (int)cudaErrorInvalidValue;
  if (misaligned(x, vec, is_bf16) || misaligned(g, vec, is_bf16))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err;
  if (is_bf16)
    err = k == 3 ? launch_wgrad<__nv_bfloat16, 3>(x, g, part, dw, N, H, W, C, vec, tcv,
                                                  band_rows, stream)
                 : launch_wgrad<__nv_bfloat16, 5>(x, g, part, dw, N, H, W, C, vec, tcv,
                                                  band_rows, stream);
  else
    err = k == 3
              ? launch_wgrad<float, 3>(x, g, part, dw, N, H, W, C, vec, tcv, band_rows, stream)
              : launch_wgrad<float, 5>(x, g, part, dw, N, H, W, C, vec, tcv, band_rows, stream);
  return (int)err;
}
