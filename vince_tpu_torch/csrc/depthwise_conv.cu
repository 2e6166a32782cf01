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
// Rounding. The plain PyTorch version rounds each product and then the sum,
// in f32, tap after tap. The f32 product of two bf16 values is exact (two
// 8-bit significands), so for bf16 tensors one fused multiply-add per tap
// gives the same bits with half the instructions (measured: 18% less time
// over the twelve sites of EfficientNet-B0, the k = 5 sites 20-25%); for f32
// tensors the product is rounded (__fmul_rn) and then added (__fadd_rn). In
// both types, with the plain version's order of taps, out and dx equal that
// version bit for bit (up to the sign of a zero).
//
// What bounds it on the H100: the rate of instructions and their latency, not
// bytes. An element costs 4 bytes of traffic in bf16 but k*k f32 operations,
// and a kernel whose threads fetch their own taps from device memory spends
// more instructions on addresses, predicates and narrow loads than on
// arithmetic.
// The design therefore takes the address work out of the inner loop and
// shares every fetched value between several outputs:
//   - A CTA owns a chunk of channels, a tile of columns and a band of rows of
//     a few images. It copies each input row of its tile (with the k-1 halo
//     columns) into a ring of row buffers in shared memory with cp.async, 16
//     bytes a thread where C allows, a few rows ahead of the arithmetic
//     (commit_group / wait_group). Columns outside the image, channels past
//     C and images past N are zero-filled by the copy's source size. What a
//     thread copies is fixed for the whole walk, so its offsets are computed
//     once. Each input element leaves device memory once per CTA.
//   - A thread owns CPT channels (2 where C is even) of COLS neighbouring
//     output columns. Per input row it reads COLS + k - 1 values from shared
//     memory, widens each once and adds the row's products into k rolling
//     accumulators per column, one for each output row that the input row
//     touches; the accumulator whose last tap row this was is stored and
//     starts the next output row (the walk is unrolled k rows deep, so no
//     accumulator moves). An output still receives its taps in the order
//     i = 0..k-1, j = 0..k-1.
//   - The chunk's k*k weights are staged once per CTA through shared memory
//     with the same 16-byte copies and held in registers.
//   - On small maps a CTA walks `slots` images side by side (they fill the
//     thread block where one image has too few columns) and `images` images
//     in all, one batch of slots after another through the same ring, so the
//     weights, the pipeline's fill and the CTA's launch are paid once for
//     all of them.
// The tile (chunk, columns per thread, column groups, slots, images per CTA,
// rows per band, pixel pitch) is chosen by
// ops/kernels/depthwise_kernel.py::_tiling and passed to the entry points,
// which check it. Any N, H >= k, W >= k, C launches: C that is no multiple
// of a 16-byte vector takes the same kernel with copies of one thread's
// channels (4 or 8 bytes by cp.async; a single bf16 channel, which cp.async
// cannot copy, by a plain load and store).
//
// The filter gradient (dw_wgrad_kernel, below) takes the place of the k*k
// shifted multiply-reduces that the JAX VJP leaves to XLA (_wgrad in the same
// file): dw[i, j, c] = sum_{n, h, w} round(xp[n, h+i, w+j, c] * g[n, h, w, c]),
// each product rounded to the tensors' type as there, the sum in f32. It
// stages x (with halo) and g through the same ring, walks the rows the same
// way with a rolling window of k rows of g in registers, and keeps the k*k
// sums of its channels in registers. The product of two bf16 values is exact
// in f32, so one packed bf16 multiply (__hmul2) is that rounded product for
// two channels in one instruction; each half is widened by a shift or a mask
// and added in f32. A CTA walks several images and all rows of its band
// before it adds its threads' sums in shared memory in a fixed order and
// writes one partial, so the partials stay a small fraction of x and g; a
// second kernel adds the partials in a fixed order (no float atomics, so dw
// is bitwise reproducible).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // bytes a CTA can use on sm_90
constexpr int STAGES = 4;           // row buffers in the ring: 3 rows in flight

// The tile, as depthwise_kernel._tiling chose it, and what follows from it.
struct Geometry {
  int N, H, W, C;
  int chunk;      // channels per CTA
  int pitch;      // elements between neighbouring staged pixels, >= chunk
  int groups;     // column groups per slot, each of COLS columns
  int slots;      // images walked side by side
  int images;     // images per CTA, walked in batches of `slots`
  int band_rows;  // output rows per CTA
  // derived by fill()
  int pairs;      // threads along the channels: chunk / CPT
  int tw, twh;    // output columns per CTA, and with the halo
  int chunks, coltiles, bands, igroups;
  int threads;
};

// ---- values as the tensors hold them, CPT channels of one pixel --------------
template <typename T, int CPT>
struct Lane;

template <>
struct Lane<__nv_bfloat16, 2> {
  using raw = __nv_bfloat162;
  static __device__ __forceinline__ void widen(raw v, float (&f)[2]) {
    const uint32_t bits = *reinterpret_cast<const uint32_t*>(&v);
    f[0] = __uint_as_float(bits << 16);
    f[1] = __uint_as_float(bits & 0xffff0000u);
  }
  static __device__ __forceinline__ raw narrow(const float (&f)[2]) {
    return __floats2bfloat162_rn(f[0], f[1]);
  }
  // round_bf16(a * b) for both channels: the f32 product of two bf16 values
  // is exact, so the packed multiply's one rounding is the only one
  static __device__ __forceinline__ raw product(raw a, raw b) { return __hmul2(a, b); }
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using raw = __nv_bfloat16;
  static __device__ __forceinline__ void widen(raw v, float (&f)[1]) {
    f[0] = __bfloat162float(v);
  }
  static __device__ __forceinline__ raw narrow(const float (&f)[1]) {
    return __float2bfloat16(f[0]);
  }
  static __device__ __forceinline__ raw product(raw a, raw b) { return __hmul(a, b); }
};

template <>
struct Lane<float, 2> {
  using raw = float2;
  static __device__ __forceinline__ void widen(raw v, float (&f)[2]) {
    f[0] = v.x;
    f[1] = v.y;
  }
  static __device__ __forceinline__ raw narrow(const float (&f)[2]) {
    return make_float2(f[0], f[1]);
  }
  static __device__ __forceinline__ raw product(raw a, raw b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
};

template <>
struct Lane<float, 1> {
  using raw = float;
  static __device__ __forceinline__ void widen(raw v, float (&f)[1]) { f[0] = v; }
  static __device__ __forceinline__ raw narrow(const float (&f)[1]) { return f[0]; }
  static __device__ __forceinline__ raw product(raw a, raw b) { return __fmul_rn(a, b); }
};

// acc + tap * weight as the plain version rounds it: the product, then the sum.
// For bf16 tensors the product is exact and the fused form is the same value.
template <typename T>
__device__ __forceinline__ float add_tap(float acc, float tap, float weight) {
  if constexpr (sizeof(T) == 2) {
    return fmaf(tap, weight, acc);
  } else {
    return __fadd_rn(acc, __fmul_rn(tap, weight));
  }
}

// ---- staging copies ----------------------------------------------------------
// VB bytes from device to shared memory, or VB zero bytes where !ok (the
// source is then not read)
template <int VB>
__device__ __forceinline__ void stage_copy(void* dst, const void* src, bool ok) {
  if constexpr (VB >= 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = ok ? VB : 0;
    if constexpr (VB == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
                   : "memory");
    else if constexpr (VB == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(bytes)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
                   : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// One thread's share of the copies of one staged row of `px` pixels per slot:
// at most NLD vectors of VC channels, the same ones for every row of the
// walk, so where each comes from and goes to is worked out once.
template <int NLD>
struct RowCopies {
  int dst[NLD];        // element offset in the row buffer; -1: no copy
  long long src[NLD];  // element offset from the same row of the first slot's image; -1: zeros
  int slot[NLD];       // which of the side-by-side images
  __device__ __forceinline__ RowCopies(const Geometry& g, int px, int halo, int col0, int c0,
                                       int vc) {
    const int vpp = g.chunk / vc;  // vectors per pixel
    const int nvec = g.slots * px * vpp;
#pragma unroll
    for (int m = 0; m < NLD; ++m) {
      const int v = threadIdx.x + m * g.threads;
      dst[m] = -1;
      src[m] = -1;
      slot[m] = 0;
      if (v < nvec) {
        const int q = v % vpp, p = (v / vpp) % px, s = v / (vpp * px);
        const int col = col0 + p - halo, c = c0 + q * vc;
        dst[m] = (s * px + p) * g.pitch + q * vc;
        if (col >= 0 && col < g.W && c < g.C) src[m] = ((long long)s * g.H * g.W + col) * g.C + c;
        slot[m] = s;
      }
    }
  }
  // one row of the first `nslots` side-by-side images into the row buffer
  // `buf`, from `row`, which points at that row of the first of them; zeros
  // for the other slots and where !row_ok (`row` is then not read)
  template <typename T, int VB>
  __device__ __forceinline__ void start(T* buf, const T* row, int nslots, bool row_ok) const {
#pragma unroll
    for (int m = 0; m < NLD; ++m) {
      if (dst[m] >= 0) {
        const bool ok = row_ok && src[m] >= 0 && slot[m] < nslots;
        stage_copy<VB>(buf + dst[m], row + (ok ? src[m] : 0), ok);
      }
    }
  }
};

// which part of the tensors a CTA owns
struct Block {
  int c0, col0, h0, h1, n0, n_end, part;
  __device__ __forceinline__ Block(const Geometry& g) {
    int b = blockIdx.x;
    c0 = (b % g.chunks) * g.chunk;
    b /= g.chunks;
    part = b;  // everything but the chunk: the filter gradient's partial
    col0 = (b % g.coltiles) * g.tw;
    b /= g.coltiles;
    h0 = (b % g.bands) * g.band_rows;
    h1 = min(g.H, h0 + g.band_rows);
    n0 = (b / g.bands) * g.images;
    n_end = min(g.N, n0 + g.images);
  }
};

// ---- forward and dgrad -------------------------------------------------------
// grid: x = chunk + chunks * (column tile + coltiles * (band + bands * image group));
// threads = slots * groups * pairs, a channel pair the fast index.
// shared memory: ring [STAGES][slots * twh * pitch], weights [K * K][chunk].
template <typename T, int K, int COLS, int CPT, int VB>
__global__ void __launch_bounds__(MAX_THREADS, 2)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
          const Geometry g) {
  using L = Lane<T, CPT>;
  using raw = typename L::raw;
  constexpr int P = (K - 1) / 2;
  constexpr int VC = VB / (int)sizeof(T);
  constexpr int NLD = ((COLS + K - 1) * CPT + VC - 1) / VC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Block blk(g);
  const int stage_elems = g.slots * g.twh * g.pitch;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* wsm = ring + (size_t)STAGES * stage_elems;

  const int pair = threadIdx.x % g.pairs;
  const int grp = threadIdx.x / g.pairs;
  const int slot = grp / g.groups;
  const int ocol0 = blk.col0 + (grp % g.groups) * COLS;  // the thread's first output column
  const int c = blk.c0 + pair * CPT;
  const bool active = c < g.C;
  const int tap0 = (slot * g.twh + (grp % g.groups) * COLS) * g.pitch + pair * CPT;

  const int r_lo = max(blk.h0 - P, 0);
  const int r_hi = min(blk.h1 + P, g.H);
  const int batches = (blk.n_end - blk.n0 + g.slots - 1) / g.slots;

  const ptrdiff_t row_stride = (ptrdiff_t)g.W * g.C;

  // the weights of the chunk, zeros past C
  for (int v = threadIdx.x; v < K * K * (g.chunk / VC); v += g.threads) {
    const int t = v / (g.chunk / VC), cc = (v % (g.chunk / VC)) * VC;
    const bool ok = blk.c0 + cc < g.C;
    stage_copy<VB>(wsm + t * g.chunk + cc, ok ? w + (size_t)t * g.C + blk.c0 + cc : w, ok);
  }
  commit_copies();

  // the producer's position: the next row to copy, of which batch, into which buffer
  const RowCopies<NLD> copies(g, g.twh, P, blk.col0, blk.c0, VC);
  int p_batch = 0, p_row = r_lo, p_buf = 0;
  auto copy_next_row = [&]() {
    if (p_batch < batches) {
      const int n_first = blk.n0 + p_batch * g.slots;
      copies.template start<T, VB>(ring + (size_t)p_buf * stage_elems,
                                   x + ((ptrdiff_t)n_first * g.H + p_row) * row_stride,
                                   blk.n_end - n_first, true);
      if (++p_row == r_hi) {
        p_row = r_lo;
        ++p_batch;
      }
      p_buf = p_buf + 1 == STAGES ? 0 : p_buf + 1;
    }
    commit_copies();  // an empty group keeps the count of groups per step fixed
  };
  for (int s = 0; s < STAGES - 1; ++s) copy_next_row();

  wait_copies<STAGES - 1>();  // the weights' group is the oldest
  __syncthreads();
  float wk[K][K][CPT];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      L::widen(*reinterpret_cast<const raw*>(wsm + (i * K + j) * g.chunk + pair * CPT), wk[i][j]);

  int c_buf = 0;
  for (int batch = 0; batch < batches; ++batch) {
    const int n = blk.n0 + batch * g.slots + slot;
    // the columns this thread stores: none for a lane past C or an image past N
    const int ncols = active && n < blk.n_end ? min(COLS, g.W - ocol0) : 0;
    // acc[a]: one open output row each. An output row keeps its accumulator
    // from its first tap row to its last; the walk is unrolled K rows deep so
    // that which accumulator meets which tap row is known at compile time
    // (phase ph, tap row i: accumulator (ph - i + P) mod K) and none moves.
    float acc[K][COLS][CPT];
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int q = 0; q < COLS; ++q)
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[a][q][e] = 0.f;
    // output row r - P at the thread's first column
    T* done = out + (((ptrdiff_t)n * g.H + (r_lo - P)) * g.W + ocol0) * g.C + c;

    // rows before the image add nothing, so the walk starts at the first real
    // row; after the last real row the k-1 open output rows are still stored
    for (int r0 = r_lo; r0 < blk.h1 + P; r0 += K) {
#pragma unroll
      for (int ph = 0; ph < K; ++ph) {
        const int r = r0 + ph;
        if (r >= blk.h1 + P) break;
        if (r < r_hi) {
          wait_copies<STAGES - 2>();  // this thread's share of row r has landed
          __syncthreads();            // everyone's has, and row r-1's buffer is free
          copy_next_row();
          const T* taps = ring + (size_t)c_buf * stage_elems + tap0;
          c_buf = c_buf + 1 == STAGES ? 0 : c_buf + 1;
          float cur[COLS + K - 1][CPT];
#pragma unroll
          for (int t = 0; t < COLS + K - 1; ++t)
            L::widen(*reinterpret_cast<const raw*>(taps + t * g.pitch), cur[t]);
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const int h = r - i + P;  // the output row that takes row r as tap row i
            if (h >= blk.h0 && h < blk.h1) {
#pragma unroll
              for (int q = 0; q < COLS; ++q)
#pragma unroll
                for (int j = 0; j < K; ++j)
#pragma unroll
                  for (int e = 0; e < CPT; ++e) {
                    float& a = acc[(ph - i + P + K) % K][q][e];
                    a = add_tap<T>(a, cur[q + j][e], wk[i][j][e]);
                  }
            }
          }
        }
        // output row r - P had its last tap row (K - 1) in r
        if (r - P >= blk.h0 && r - P < blk.h1) {
#pragma unroll
          for (int q = 0; q < COLS; ++q)
            if (q < ncols)
              *reinterpret_cast<raw*>(done + (ptrdiff_t)q * g.C) =
                  L::narrow(acc[(ph + 1 + P) % K][q]);
        }
        done += row_stride;
#pragma unroll
        for (int q = 0; q < COLS; ++q)
#pragma unroll
          for (int e = 0; e < CPT; ++e) acc[(ph + 1 + P) % K][q][e] = 0.f;
      }
    }
  }
  wait_copies<0>();
}

// ---- filter gradient ---------------------------------------------------------
// The same grid and threads. A step of the walk stages x's row r (with halo)
// and g's row r + P; shared memory: ring [STAGES][slots * (twh + tw) * pitch],
// used again at the end for the CTA's reduce [K * K * CPT][threads] f32.
// part [parts, K * K, C] f32, one partial per (column tile, band, image group).
template <typename T, int K, int COLS, int CPT, int VB>
__global__ void __launch_bounds__(MAX_THREADS, 2)
dw_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ part,
                const Geometry g) {
  using L = Lane<T, CPT>;
  using raw = typename L::raw;
  constexpr int P = (K - 1) / 2;
  constexpr int VC = VB / (int)sizeof(T);
  constexpr int NLDX = ((COLS + K - 1) * CPT + VC - 1) / VC;
  constexpr int NLDG = (COLS * CPT + VC - 1) / VC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Block blk(g);
  const int x_elems = g.slots * g.twh * g.pitch;
  const int stage_elems = x_elems + g.slots * g.tw * g.pitch;
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int pair = threadIdx.x % g.pairs;
  const int grp = threadIdx.x / g.pairs;
  const int slot = grp / g.groups;
  const int cg = grp % g.groups;
  const int tap0 = (slot * g.twh + cg * COLS) * g.pitch + pair * CPT;
  const int g0 = x_elems + (slot * g.tw + cg * COLS) * g.pitch + pair * CPT;

  // x's row r meets g's rows r - P .. r + P. g's rows outside the band are
  // another CTA's, so the walk goes over x's rows h0 - P .. h1 - 1 + P; those
  // outside the image only move g's window.
  const int r_lo = blk.h0 - P;
  const int r_hi = min(blk.h1 + P, g.H);
  const int batches = (blk.n_end - blk.n0 + g.slots - 1) / g.slots;

  const ptrdiff_t row_stride = (ptrdiff_t)g.W * g.C;
  const RowCopies<NLDX> x_copies(g, g.twh, P, blk.col0, blk.c0, VC);
  const RowCopies<NLDG> g_copies(g, g.tw, 0, blk.col0, blk.c0, VC);
  int p_batch = 0, p_row = r_lo, p_buf = 0;
  auto copy_next_rows = [&]() {
    if (p_batch < batches) {
      T* buf = ring + (size_t)p_buf * stage_elems;
      const int n_first = blk.n0 + p_batch * g.slots;
      const ptrdiff_t first = ((ptrdiff_t)n_first * g.H + p_row) * row_stride;
      x_copies.template start<T, VB>(buf, x + first, blk.n_end - n_first, p_row >= 0);
      g_copies.template start<T, VB>(buf + x_elems, gy + first + P * row_stride,
                                     blk.n_end - n_first, p_row + P < blk.h1);
      if (++p_row == r_hi) {
        p_row = r_lo;
        ++p_batch;
      }
      p_buf = p_buf + 1 == STAGES ? 0 : p_buf + 1;
    }
    commit_copies();
  };
  for (int s = 0; s < STAGES - 1; ++s) copy_next_rows();

  float acc[K][K][CPT];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[i][j][e] = 0.f;

  int c_buf = 0;
  for (int batch = 0; batch < batches; ++batch) {
    // gwin[i]: g's row r - i + P at the thread's columns; rows outside the
    // band are never multiplied
    raw gwin[K][COLS] = {};
    for (int r = r_lo; r < r_hi; ++r) {
      wait_copies<STAGES - 2>();
      __syncthreads();
      copy_next_rows();
      const T* buf = ring + (size_t)c_buf * stage_elems;
      c_buf = c_buf + 1 == STAGES ? 0 : c_buf + 1;
#pragma unroll
      for (int i = K - 1; i > 0; --i)
#pragma unroll
        for (int q = 0; q < COLS; ++q) gwin[i][q] = gwin[i - 1][q];
#pragma unroll
      for (int q = 0; q < COLS; ++q)
        gwin[0][q] = *reinterpret_cast<const raw*>(buf + g0 + q * g.pitch);
      if (r < 0) continue;
      raw cur[COLS + K - 1];
#pragma unroll
      for (int t = 0; t < COLS + K - 1; ++t)
        cur[t] = *reinterpret_cast<const raw*>(buf + tap0 + t * g.pitch);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int h = r - i + P;  // the row of g that meets x's row r at tap row i
        if (h >= blk.h0 && h < blk.h1) {
#pragma unroll
          for (int j = 0; j < K; ++j)
#pragma unroll
            for (int q = 0; q < COLS; ++q) {
              float prod[CPT];
              L::widen(L::product(cur[q + j], gwin[i][q]), prod);
#pragma unroll
              for (int e = 0; e < CPT; ++e) acc[i][j][e] += prod[e];
            }
        }
      }
    }
  }

  // the CTA's threads, added in a fixed order, in the ring's memory
  wait_copies<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [K * K * CPT][threads]
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        red[((i * K + j) * CPT + e) * g.threads + threadIdx.x] = acc[i][j][e];
  __syncthreads();
  const int ngrp = g.slots * g.groups;
  for (int o = threadIdx.x; o < K * K * CPT * g.pairs; o += g.threads) {
    const int t = o / g.pairs;
    const int pl = o % g.pairs;
    const int c = blk.c0 + pl * CPT + t % CPT;
    if (c >= g.C) continue;
    float sum = 0.f;
    for (int gi = 0; gi < ngrp; ++gi) sum += red[t * g.threads + gi * g.pairs + pl];
    part[((size_t)blk.part * K * K + t / CPT) * g.C + c] = sum;
  }
}

// dw[o] = the partials of output o (a tap and a channel) in a fixed order:
// 8 segments per output, then the 8
constexpr int RED_SEGS = 8;

__global__ void __launch_bounds__(MAX_THREADS)
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

// ---- launches ----------------------------------------------------------------
struct Launch {
  const void *a, *b;  // x and w, or x and g
  void* out;          // out, or the partials
  Geometry g;
  size_t smem;
  bool wgrad;
  cudaStream_t stream;
};

template <typename T, int K, int COLS, int CPT, int VB>
cudaError_t run(const Launch& l) {
  const T* a = static_cast<const T*>(l.a);
  const T* b = static_cast<const T*>(l.b);
  // fill() checked that the product fits
  const unsigned grid =
      (unsigned)((long long)l.g.chunks * l.g.coltiles * l.g.bands * l.g.igroups);
  if (l.wgrad) {
    auto kernel = dw_wgrad_kernel<T, K, COLS, CPT, VB>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)l.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, l.g.threads, l.smem, l.stream>>>(a, b, static_cast<float*>(l.out), l.g);
  } else {
    auto kernel = dw_kernel<T, K, COLS, CPT, VB>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)l.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, l.g.threads, l.smem, l.stream>>>(a, b, static_cast<T*>(l.out), l.g);
  }
  return cudaGetLastError();
}

// 16-byte copies with 2 or 4 columns a thread (k = 3: also 8, where k = 5 has
// no registers left); narrower copies (one thread's channels) with 2 columns
template <typename T, int K>
cudaError_t dispatch(const Launch& l, int cols, int cpt, int vb) {
  constexpr int E = (int)sizeof(T);
  if constexpr (K == 3) {
    if (vb == 16 && cpt == 2 && cols == 8) return run<T, K, 8, 2, 16>(l);
  }
  if (vb == 16 && cpt == 2 && cols == 4) return run<T, K, 4, 2, 16>(l);
  if (vb == 16 && cpt == 2 && cols == 2) return run<T, K, 2, 2, 16>(l);
  if (vb == 2 * E && cpt == 2 && cols == 2) return run<T, K, 2, 2, 2 * E>(l);
  if (vb == E && cpt == 1 && cols == 2) return run<T, K, 2, 1, E>(l);
  return cudaErrorInvalidValue;
}

// Fill in what follows from the tile and check it against the card's limits;
// the bytes of shared memory, or -1 for a tile the kernels do not take.
long long fill(Geometry& g, int k, int esize, int cols, int cpt, int vb, bool wgrad) {
  if (g.N <= 0 || g.H < k || g.W < k || g.C <= 0 || (k != 3 && k != 5)) return -1;
  if ((long long)(g.W + k) * g.C > 2147483647LL) return -1;  // RowCopies' offsets are ints
  if ((cpt != 1 && cpt != 2) || vb % (cpt * esize) || g.C % (vb / esize)) return -1;
  const int vc = vb / esize;
  if (g.chunk <= 0 || g.chunk % vc || g.pitch < g.chunk || g.pitch % vc) return -1;
  if (g.groups <= 0 || g.slots <= 0 || g.images <= 0 || g.band_rows <= 0) return -1;
  g.pairs = g.chunk / cpt;
  g.tw = g.groups * cols;
  g.twh = g.tw + k - 1;
  g.threads = g.slots * g.groups * g.pairs;
  if (g.threads > MAX_THREADS) return -1;
  g.chunks = (g.C + g.chunk - 1) / g.chunk;
  g.coltiles = (g.W + g.tw - 1) / g.tw;
  g.bands = (g.H + g.band_rows - 1) / g.band_rows;
  g.igroups = (g.N + g.images - 1) / g.images;
  if ((long long)g.chunks * g.coltiles * g.bands * g.igroups > 2147483647LL) return -1;
  long long smem;
  if (wgrad) {
    smem = (long long)STAGES * g.slots * (g.twh + g.tw) * g.pitch * esize;
    const long long reduce = 4LL * k * k * cpt * g.threads;
    if (reduce > smem) smem = reduce;
  } else {
    smem = ((long long)STAGES * g.slots * g.twh * g.pitch + (long long)k * k * g.chunk) * esize;
  }
  return smem <= SMEM_LIMIT ? smem : -1;
}

bool misaligned(const void* p, int vb) { return reinterpret_cast<uintptr_t>(p) % vb != 0; }

}  // namespace

// x, out [N, H, W, C] and w [k, k, 1, C], contiguous, all bf16 (is_bf16 != 0)
// or all f32, aligned to vec_bytes. The tile, from depthwise_kernel._tiling:
// cols columns and cpt channels per thread, copies of vec_bytes, chunk
// channels per CTA at a pitch of `pitch` elements per staged pixel, `groups`
// column groups by `slots` images side by side, `images` images and band_rows
// output rows per CTA.
extern "C" int vince_depthwise_conv(const void* x, const void* w, void* out, int N, int H,
                                    int W, int C, int k, int is_bf16, int cols, int cpt,
                                    int vec_bytes, int chunk, int pitch, int groups, int slots,
                                    int images, int band_rows, void* stream_ptr) {
  Launch l{x, w, out, {N, H, W, C, chunk, pitch, groups, slots, images, band_rows},
           0, false, static_cast<cudaStream_t>(stream_ptr)};
  const long long smem = fill(l.g, k, is_bf16 ? 2 : 4, cols, cpt, vec_bytes, false);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (misaligned(x, vec_bytes) || misaligned(w, vec_bytes) || misaligned(out, vec_bytes))
    return (int)cudaErrorMisalignedAddress;
  l.smem = (size_t)smem;
  cudaError_t err;
  if (is_bf16)
    err = k == 3 ? dispatch<__nv_bfloat16, 3>(l, cols, cpt, vec_bytes)
                 : dispatch<__nv_bfloat16, 5>(l, cols, cpt, vec_bytes);
  else
    err = k == 3 ? dispatch<float, 3>(l, cols, cpt, vec_bytes)
                 : dispatch<float, 5>(l, cols, cpt, vec_bytes);
  return (int)err;
}

// x, g [N, H, W, C] contiguous, both bf16 (is_bf16 != 0) or both f32; dw
// [k, k, 1, C] f32. Scratch part [parts, k * k, C] f32 with parts = column
// tiles * bands * image groups of the tile.
extern "C" int vince_depthwise_wgrad(const void* x, const void* g, float* part, float* dw,
                                     int N, int H, int W, int C, int k, int is_bf16, int cols,
                                     int cpt, int vec_bytes, int chunk, int pitch, int groups,
                                     int slots, int images, int band_rows, void* stream_ptr) {
  Launch l{x, g, part, {N, H, W, C, chunk, pitch, groups, slots, images, band_rows},
           0, true, static_cast<cudaStream_t>(stream_ptr)};
  const long long smem = fill(l.g, k, is_bf16 ? 2 : 4, cols, cpt, vec_bytes, true);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (misaligned(x, vec_bytes) || misaligned(g, vec_bytes)) return (int)cudaErrorMisalignedAddress;
  l.smem = (size_t)smem;
  cudaError_t err;
  if (is_bf16)
    err = k == 3 ? dispatch<__nv_bfloat16, 3>(l, cols, cpt, vec_bytes)
                 : dispatch<__nv_bfloat16, 5>(l, cols, cpt, vec_bytes);
  else
    err = k == 3 ? dispatch<float, 3>(l, cols, cpt, vec_bytes)
                 : dispatch<float, 5>(l, cols, cpt, vec_bytes);
  if (err != cudaSuccess) return (int)err;
  const int outputs = k * k * C;
  const int nparts = l.g.coltiles * l.g.bands * l.g.igroups;
  dw_wgrad_reduce_kernel<<<(outputs + 31) / 32, MAX_THREADS, 0, l.stream>>>(part, dw, outputs,
                                                                            nparts);
  return (int)cudaGetLastError();
}
