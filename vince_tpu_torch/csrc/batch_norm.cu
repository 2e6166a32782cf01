// Train- and eval-mode BatchNorm over the last dimension, with the residual add
// and the ReLU fused in, forward and backward; CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's nn.BatchNorm
// (vince_tpu/models/resnet.py), which XLA fuses into its neighbours. The
// port's counterpart was composed PyTorch float32 passes (~10 forward and ~15
// backward passes over each activation, f32 copies of it saved for the
// backward). Over x viewed as [M, C], in float32:
//     mean = sum(x) / M,  var = max(sum(x^2) / M - mean^2, 0)
//     y = round((x - mean) * (rsqrt(var + eps) * w) + b)   [+ residual] [relu]
// with y rounded to the output type before the residual is added (flax's
// module, then `+ residual` and relu, round so). The backward, with g' the
// gradient masked by the saved output (y > 0) where the ReLU was fused:
//     dbias = sum(g'),  S2 = sum(g' (x - mean)),  dweight = S2 * rsqrt(var + eps)
//     dx = a g' - a sum(g') / M - (x - mean) a r^2 S2 / M   (a = r w, r = rsqrt(var + eps);
//          the last term only where var's clamp passed, as autograd gives it)
//
// What bounds it on the H100: bytes. A pass does ~1-4 float operations per
// element against 2-4 bytes of it (~0 operations per byte), so the card's
// 3.35 TB/s is the limit and the only gain is to move fewer bytes. The design
// reads and writes each tensor once per pass and keeps the intermediates
// (x̂, the f32 copies, the masked gradient where no residual needs it) out of
// device memory: forward, one read of x for the statistics and one read of x
// (and the residual) and one write of y; backward, one read of g, x and the
// output for the sums and one read of them and one write of dx (the masked g'
// is written once only where a fused residual needs it as its gradient).
//
// Design:
// - Layout. A CTA of 256 threads covers a tile of up to 32 channel vectors
//   (16-byte vectors: 8 bf16 or 4 f32 channels; 1 channel where C or an
//   address does not allow them) and 256 / tile rows at a time, and walks a
//   slab of rows; neighbouring threads read neighbouring 16 bytes of a row, so
//   a warp reads 512 contiguous bytes. The wrapper sizes each kernel's grid
//   (batch_norm_kernel.layout) to one wave of the CTAs the SMs hold at once
//   (vince_bn_ctas_per_sm: 2-8 an SM by the kernel's registers), over slabs
//   of rows and channel tiles; each thread keeps its channels' per-channel
//   constants in registers and loads several rows before it uses them.
// - Sums without atomics. Each thread sums its rows in float32 registers; a
//   CTA adds its threads' sums in shared memory in a fixed order and writes
//   them to a [slabs, 2, C] scratch; a second launch adds the slabs in a
//   fixed order (8 warps each sum every 8th slab, then the 8 sums in turn).
//   Every sum has a fixed order, so a call, a second call and a CUDA graph's
//   replay give the same bits.
// - Across processes (--sync-bn) the wrapper sums the [2, C] moments, and in
//   the backward the [2, C] gradient sums, over the group between the
//   launches: the finishing kernels run once more on the summed values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VEC = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// V elements of T as one aligned access (16 bytes at V = 8 bf16 or 4 f32)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(pk.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// A thread's place in the layout: its channel vector and first row, the rows
// a pass covers, and its slab's rows.
struct Place {
  int cv;         // channel vector (channels cv * V ... cv * V + V - 1)
  int lr;         // row lane
  int R;          // rows a pass covers
  long long r0;   // the slab's first row
  long long r1;   // past the slab's last row
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(long long M, int C, int tile, int slab_rows) {
  Place p;
  p.R = THREADS / tile;
  const int lc = threadIdx.x % tile;
  p.lr = threadIdx.x / tile;
  p.cv = blockIdx.y * tile + lc;
  p.r0 = (long long)blockIdx.x * slab_rows;
  p.r1 = min(M, p.r0 + slab_rows);
  p.active = p.lr < p.R && p.cv < C / V;
  return p;
}

// Partial sums of x and x^2 of a slab of rows, per channel: parts[slab][0|1][C].
template <typename Tin, int V>
__global__ void __launch_bounds__(THREADS)
    bn_stats_kernel(const Tin* __restrict__ x, float* __restrict__ parts, long long M, int C,
                    int tile, int slab_rows) {
  __shared__ float red[2 * THREADS * MAX_VEC];
  const Place p = place<V>(M, C, tile, slab_rows);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (p.active) {
    const Tin* base = x + (long long)p.cv * V;
    long long r = p.r0 + p.lr;
    constexpr int U = 4;  // rows loaded before they are summed
    for (; r + (U - 1) * (long long)p.R < p.r1; r += U * (long long)p.R) {
      float v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) load<Tin, V>(base + (r + u * (long long)p.R) * C, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += v[u][i];
          s2[i] = fmaf(v[u][i], v[u][i], s2[i]);
        }
    }
    for (; r < p.r1; r += p.R) {
      float v[V];
      load<Tin, V>(base + r * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    }
  }
  // the CTA's row lanes, added in order
  const int width = tile * V;  // channels of the tile
  const int lc = threadIdx.x % tile;
  if (p.lr < p.R) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[p.lr * width + lc * V + i] = s1[i];
      red[(p.R + p.lr) * width + lc * V + i] = s2[i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * width; j += THREADS) {
    const int k = j / width, col = j % width;
    float s = 0.f;
    for (int l = 0; l < p.R; ++l) s += red[(k * p.R + l) * width + col];
    const int c = blockIdx.y * width + col;
    if (c < C) parts[((long long)blockIdx.x * 2 + k) * C + c] = s;
  }
}

// The slabs' sums of a block's 32 channels, added in a fixed order: each of
// 8 warps sums every 8th slab (neighbouring lanes read neighbouring channels),
// then one warp adds the 8 groups. True in the threads that hold a channel's
// (s1, s2).
constexpr int FIN_CH = 32, FIN_GROUPS = THREADS / FIN_CH;

__device__ __forceinline__ bool sum_slabs(const float* __restrict__ parts, int G, int C,
                                          int& c, float& s1, float& s2) {
  __shared__ float red[2][FIN_GROUPS][FIN_CH];
  const int j = threadIdx.x % FIN_CH, q = threadIdx.x / FIN_CH;
  c = blockIdx.x * FIN_CH + j;
  float a = 0.f, b = 0.f;
  if (c < C)
    for (int g = q; g < G; g += FIN_GROUPS) {
      a += parts[(2LL * g) * C + c];
      b += parts[(2LL * g + 1) * C + c];
    }
  red[0][q][j] = a;
  red[1][q][j] = b;
  __syncthreads();
  if (q != 0 || c >= C) return false;
  s1 = s2 = 0.f;
  for (int k = 0; k < FIN_GROUPS; ++k) {
    s1 += red[0][k][j];
    s2 += red[1][k][j];
  }
  return true;
}

// The statistics from the slabs' sums over n rows: mean, var (clamped) and
// t = E[x^2] - mean^2 (before the clamp, for the backward's mask), or the
// moments (mean, E[x^2]) alone, for a sum across processes.
__global__ void __launch_bounds__(THREADS)
    bn_finish_kernel(const float* __restrict__ parts, int G, int C, float n,
                     float* __restrict__ mean, float* __restrict__ var, float* __restrict__ t,
                     float* __restrict__ moments) {
  int c;
  float s1, s2;
  if (!sum_slabs(parts, G, C, c, s1, s2)) return;
  const float m1 = __fdiv_rn(s1, n), m2 = __fdiv_rn(s2, n);
  if (moments) {
    moments[c] = m1;
    moments[C + c] = m2;
  }
  if (mean) {
    const float d = __fsub_rn(m2, __fmul_rn(m1, m1));
    mean[c] = m1;
    var[c] = d < 0.f ? 0.f : d;
    t[c] = d;
  }
}

// y = round((x - mean) * (rsqrt(var + eps) * w) + b) [+ residual] [relu]
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(THREADS)
    bn_apply_kernel(const Tin* __restrict__ x, const Tout* __restrict__ res, Tout* __restrict__ y,
                    const float* __restrict__ mean, const float* __restrict__ var,
                    const float* __restrict__ w, const float* __restrict__ b, float eps, int relu,
                    long long M, int C, int tile, int slab_rows) {
  const Place p = place<V>(M, C, tile, slab_rows);
  if (!p.active) return;
  float mu[V], a[V], bb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = p.cv * V + i;
    mu[i] = mean[c];
    a[i] = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), w[c]);
    bb[i] = b[c];
  }
  const long long off = (long long)p.cv * V;
  constexpr int U = 2;
  long long r = p.r0 + p.lr;
  auto row = [&](const float (&xv)[V], const float (&rv)[V], long long at) {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      o[i] = __fadd_rn(__fmul_rn(__fsub_rn(xv[i], mu[i]), a[i]), bb[i]);
      if (res) o[i] = __fadd_rn(to_f(from_f<Tout>(o[i])), rv[i]);
      if (relu) o[i] = o[i] < 0.f ? 0.f : o[i];
    }
    store<Tout, V>(y + at, o);
  };
  for (; r + (U - 1) * (long long)p.R < p.r1; r += U * (long long)p.R) {
    float xv[U][V], rv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long at = (r + u * (long long)p.R) * C + off;
      load<Tin, V>(x + at, xv[u]);
      if (res) load<Tout, V>(res + at, rv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) row(xv[u], rv[u], (r + u * (long long)p.R) * C + off);
  }
  for (; r < p.r1; r += p.R) {
    float xv[V], rv[V];
    load<Tin, V>(x + r * C + off, xv);
    if (res) load<Tout, V>(res + r * C + off, rv);
    row(xv, rv, r * C + off);
  }
}

// Partial sums of g' and g' (x - mean) of a slab of rows, g' = g masked by the
// saved output (z <= 0 gives 0) where z is given; g' written to gres where
// given (the fused residual's gradient).
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(THREADS)
    bn_grad_stats_kernel(const Tout* __restrict__ g, const Tin* __restrict__ x,
                         const Tout* __restrict__ z, const float* __restrict__ mean,
                         float* __restrict__ parts, Tout* __restrict__ gres, long long M, int C,
                         int tile, int slab_rows) {
  __shared__ float red[2 * THREADS * MAX_VEC];
  const Place p = place<V>(M, C, tile, slab_rows);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (p.active) {
    float mu[V];
#pragma unroll
    for (int i = 0; i < V; ++i) mu[i] = mean[p.cv * V + i];
    const long long off = (long long)p.cv * V;
    auto row = [&](const float (&gv)[V], const float (&xv)[V], const float (&zv)[V],
                   long long at) {
      float gp[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        gp[i] = (z && zv[i] <= 0.f) ? 0.f : gv[i];
        s1[i] += gp[i];
        s2[i] = fmaf(gp[i], __fsub_rn(xv[i], mu[i]), s2[i]);
      }
      if (gres) store<Tout, V>(gres + at, gp);
    };
    constexpr int U = 2;
    long long r = p.r0 + p.lr;
    for (; r + (U - 1) * (long long)p.R < p.r1; r += U * (long long)p.R) {
      float gv[U][V], xv[U][V], zv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long at = (r + u * (long long)p.R) * C + off;
        load<Tout, V>(g + at, gv[u]);
        load<Tin, V>(x + at, xv[u]);
        if (z) load<Tout, V>(z + at, zv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) row(gv[u], xv[u], zv[u], (r + u * (long long)p.R) * C + off);
    }
    for (; r < p.r1; r += p.R) {
      float gv[V], xv[V], zv[V];
      const long long at = r * C + off;
      load<Tout, V>(g + at, gv);
      load<Tin, V>(x + at, xv);
      if (z) load<Tout, V>(z + at, zv);
      row(gv, xv, zv, at);
    }
  }
  const int width = tile * V;
  const int lc = threadIdx.x % tile;
  if (p.lr < p.R) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[p.lr * width + lc * V + i] = s1[i];
      red[(p.R + p.lr) * width + lc * V + i] = s2[i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * width; j += THREADS) {
    const int k = j / width, col = j % width;
    float s = 0.f;
    for (int l = 0; l < p.R; ++l) s += red[(k * p.R + l) * width + col];
    const int c = blockIdx.y * width + col;
    if (c < C) parts[((long long)blockIdx.x * 2 + k) * C + c] = s;
  }
}

// The gradient sums S1 = sum(g'), S2 = sum(g' (x - mean)) of the slabs; then
// where asked: the sums themselves (for a sum across processes), dweight =
// S2 r and dbias = S1, and dx's per-channel coefficients (k, c2, c0) with
// dx = k g' + c2 (x - mean) + c0. t (the statistics' E[x^2] - mean^2 before
// the clamp) is null in eval mode: then dx = a g'.
__global__ void __launch_bounds__(THREADS)
    bn_grad_finish_kernel(const float* __restrict__ parts, int G, int C,
                          const float* __restrict__ var, const float* __restrict__ t,
                          const float* __restrict__ w, float eps, float n,
                          float* __restrict__ sums, float* __restrict__ dw,
                          float* __restrict__ db, float* __restrict__ coef) {
  int c;
  float s1, s2;
  if (!sum_slabs(parts, G, C, c, s1, s2)) return;
  if (sums) {
    sums[c] = s1;
    sums[C + c] = s2;
  }
  const float r = rsqrtf(__fadd_rn(var[c], eps));
  const float a = __fmul_rn(r, w[c]);
  if (dw) dw[c] = __fmul_rn(s2, r);
  if (db) db[c] = s1;
  if (coef) {
    float c2 = 0.f, c0 = 0.f;
    if (t) {
      c0 = -__fdiv_rn(__fmul_rn(a, s1), n);
      // var = max(t, 0) passes its gradient where t >= 0 (torch.clamp's rule)
      if (t[c] >= 0.f) c2 = -__fdiv_rn(__fmul_rn(__fmul_rn(a, __fmul_rn(r, r)), s2), n);
    }
    coef[c] = a;
    coef[C + c] = c2;
    coef[2 * C + c] = c0;
  }
}

// dx = k g' + c2 (x - mean) + c0, g' = g masked by z where z is given
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(THREADS)
    bn_grad_apply_kernel(const Tout* __restrict__ g, const Tout* __restrict__ z,
                         const Tin* __restrict__ x, const float* __restrict__ mean,
                         const float* __restrict__ coef, Tin* __restrict__ dx, long long M, int C,
                         int tile, int slab_rows) {
  const Place p = place<V>(M, C, tile, slab_rows);
  if (!p.active) return;
  float mu[V], k[V], c2[V], c0[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = p.cv * V + i;
    mu[i] = mean[c];
    k[i] = coef[c];
    c2[i] = coef[C + c];
    c0[i] = coef[2 * C + c];
  }
  const long long off = (long long)p.cv * V;
  auto row = [&](const float (&gv)[V], const float (&xv)[V], const float (&zv)[V],
                 long long at) {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gp = (z && zv[i] <= 0.f) ? 0.f : gv[i];
      o[i] = fmaf(k[i], gp, fmaf(c2[i], __fsub_rn(xv[i], mu[i]), c0[i]));
    }
    store<Tin, V>(dx + at, o);
  };
  constexpr int U = 2;
  long long r = p.r0 + p.lr;
  for (; r + (U - 1) * (long long)p.R < p.r1; r += U * (long long)p.R) {
    float gv[U][V], xv[U][V], zv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long at = (r + u * (long long)p.R) * C + off;
      load<Tout, V>(g + at, gv[u]);
      load<Tin, V>(x + at, xv[u]);
      if (z) load<Tout, V>(z + at, zv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) row(gv[u], xv[u], zv[u], (r + u * (long long)p.R) * C + off);
  }
  for (; r < p.r1; r += p.R) {
    float gv[V], xv[V], zv[V];
    const long long at = r * C + off;
    load<Tout, V>(g + at, gv);
    load<Tin, V>(x + at, xv);
    if (z) load<Tout, V>(z + at, zv);
    row(gv, xv, zv, at);
  }
}

// L<Tin, Tout, V>::run(args...) for the dtype codes (1 bf16, 0 f32) and the
// vector width: 8 for bf16 in and out, 4, or 1
template <template <typename, typename, int> class L, typename... A>
int dispatch(int in_bf16, int out_bf16, int vec, A... args) {
  if (vec == 8) {
    if (in_bf16 && out_bf16) return L<bf16, bf16, 8>::run(args...);
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 4) {
    if (in_bf16) return out_bf16 ? L<bf16, bf16, 4>::run(args...) : L<bf16, float, 4>::run(args...);
    return out_bf16 ? L<float, bf16, 4>::run(args...) : L<float, float, 4>::run(args...);
  }
  if (vec == 1) {
    if (in_bf16) return out_bf16 ? L<bf16, bf16, 1>::run(args...) : L<bf16, float, 1>::run(args...);
    return out_bf16 ? L<float, bf16, 1>::run(args...) : L<float, float, 1>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Tin, typename Tout, int V>
struct Stats {
  static int run(dim3 grid, cudaStream_t stream, const void* x, float* parts, int M, int C,
                 int tile, int slab_rows) {
    bn_stats_kernel<Tin, V><<<grid, THREADS, 0, stream>>>(static_cast<const Tin*>(x), parts, M, C,
                                                          tile, slab_rows);
    return (int)cudaGetLastError();
  }
};

template <typename Tin, typename Tout, int V>
struct Apply {
  static int run(dim3 grid, cudaStream_t stream, const void* x, const void* res, void* y,
                 const float* mean, const float* var, const float* w, const float* b, float eps,
                 int relu, int M, int C, int tile, int slab_rows) {
    bn_apply_kernel<Tin, Tout, V><<<grid, THREADS, 0, stream>>>(
        static_cast<const Tin*>(x), static_cast<const Tout*>(res), static_cast<Tout*>(y), mean,
        var, w, b, eps, relu, M, C, tile, slab_rows);
    return (int)cudaGetLastError();
  }
};

template <typename Tin, typename Tout, int V>
struct GradStats {
  static int run(dim3 grid, cudaStream_t stream, const void* g, const void* x, const void* z,
                 const float* mean, float* parts, void* gres, int M, int C, int tile,
                 int slab_rows) {
    bn_grad_stats_kernel<Tin, Tout, V><<<grid, THREADS, 0, stream>>>(
        static_cast<const Tout*>(g), static_cast<const Tin*>(x), static_cast<const Tout*>(z),
        mean, parts, static_cast<Tout*>(gres), M, C, tile, slab_rows);
    return (int)cudaGetLastError();
  }
};

template <typename Tin, typename Tout, int V>
struct GradApply {
  static int run(dim3 grid, cudaStream_t stream, const void* g, const void* z, const void* x,
                 const float* mean, const float* coef, void* dx, int M, int C, int tile,
                 int slab_rows) {
    bn_grad_apply_kernel<Tin, Tout, V><<<grid, THREADS, 0, stream>>>(
        static_cast<const Tout*>(g), static_cast<const Tout*>(z), static_cast<const Tin*>(x), mean,
        coef, static_cast<Tin*>(dx), M, C, tile, slab_rows);
    return (int)cudaGetLastError();
  }
};

// the CTAs of a kernel that an SM holds at once (registers, shared memory,
// threads): the wrapper sizes each persistent grid to one such wave
template <typename Tin, typename Tout, int V>
struct Occupancy {
  static int run(int kind) {
    int n = 0;
    cudaError_t err =
        kind == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bn_stats_kernel<Tin, V>,
                                                                    THREADS, 0)
        : kind == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, bn_apply_kernel<Tin, Tout, V>, THREADS, 0)
        : kind == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, bn_grad_stats_kernel<Tin, Tout, V>, THREADS, 0)
        : kind == 3 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, bn_grad_apply_kernel<Tin, Tout, V>, THREADS, 0)
                    : cudaErrorInvalidValue;
    return err == cudaSuccess ? n : -(int)err;
  }
};

bool aligned(const void* ptr, int bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// the layout's grid, or (0, 0) for a layout that does not cover [M, C] once
dim3 grid_of(int M, int C, int vec, int tile, int slabs, int slab_rows) {
  if (M <= 0 || C <= 0 || C % vec || tile <= 0 || tile > THREADS || slabs <= 0 ||
      slab_rows <= 0 || (long long)slabs * slab_rows < M ||
      (long long)(slabs - 1) * slab_rows >= M)
    return dim3(0, 0);
  const int nvec = C / vec;
  const int ctiles = (nvec + tile - 1) / tile;
  if (ctiles > 65535 || tile * vec > THREADS * MAX_VEC) return dim3(0, 0);
  return dim3(slabs, ctiles);
}

}  // namespace

// x [M, C] (bf16 if in_bf16, else f32), row-major; parts [slabs, 2, C] f32.
extern "C" int vince_bn_stats(const void* x, float* parts, int M, int C, int in_bf16, int vec,
                              int tile, int slabs, int slab_rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = grid_of(M, C, vec, tile, slabs, slab_rows);
  if (grid.x == 0 || !aligned(x, vec * (in_bf16 ? 2 : 4))) return (int)cudaErrorInvalidValue;
  return dispatch<Stats>(in_bf16, in_bf16, vec, grid, stream, x, parts, M, C, tile, slab_rows);
}

// parts [G, 2, C] f32 sums over n rows -> mean, var, t [C] (all or none) and
// moments [2, C] (or null).
extern "C" int vince_bn_finish(const float* parts, int G, int C, float n, float* mean, float* var,
                               float* t, float* moments, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (G <= 0 || C <= 0 || !(n > 0.f) || (!mean != !var) || (!mean != !t))
    return (int)cudaErrorInvalidValue;
  bn_finish_kernel<<<(C + FIN_CH - 1) / FIN_CH, THREADS, 0, stream>>>(parts, G, C, n, mean, var,
                                                                     t, moments);
  return (int)cudaGetLastError();
}

// x [M, C] in, res (or null) and y [M, C] out; mean, var, w, b [C] f32.
extern "C" int vince_bn_apply(const void* x, const void* res, void* y, const float* mean,
                              const float* var, const float* w, const float* b, float eps,
                              int relu, int M, int C, int in_bf16, int out_bf16, int vec, int tile,
                              int slabs, int slab_rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = grid_of(M, C, vec, tile, slabs, slab_rows);
  const int in_b = vec * (in_bf16 ? 2 : 4), out_b = vec * (out_bf16 ? 2 : 4);
  if (grid.x == 0 || !aligned(x, in_b) || !aligned(res, out_b) || !aligned(y, out_b))
    return (int)cudaErrorInvalidValue;
  return dispatch<Apply>(in_bf16, out_bf16, vec, grid, stream, x, res, y, mean, var, w, b, eps,
                        relu, M, C, tile, slab_rows);
}

// g, z (or null), gres (or null) [M, C] in the output's type, x [M, C] in the
// input's; mean [C]; parts [slabs, 2, C] f32.
extern "C" int vince_bn_grad_stats(const void* g, const void* x, const void* z, const float* mean,
                                   float* parts, void* gres, int M, int C, int in_bf16,
                                   int out_bf16, int vec, int tile, int slabs, int slab_rows,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = grid_of(M, C, vec, tile, slabs, slab_rows);
  const int in_b = vec * (in_bf16 ? 2 : 4), out_b = vec * (out_bf16 ? 2 : 4);
  if (grid.x == 0 || !aligned(x, in_b) || !aligned(g, out_b) || !aligned(z, out_b) ||
      !aligned(gres, out_b))
    return (int)cudaErrorInvalidValue;
  return dispatch<GradStats>(in_bf16, out_bf16, vec, grid, stream, g, x, z, mean, parts, gres, M,
                            C, tile, slab_rows);
}

// parts [G, 2, C]; var, w [C]; t [C] or null (eval mode); n the rows of the
// statistics (over every process); outputs sums [2, C], dw, db [C], coef
// [3, C], each or null.
extern "C" int vince_bn_grad_finish(const float* parts, int G, int C, const float* var,
                                    const float* t, const float* w, float eps, float n,
                                    float* sums, float* dw, float* db, float* coef,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (G <= 0 || C <= 0 || !(n > 0.f)) return (int)cudaErrorInvalidValue;
  bn_grad_finish_kernel<<<(C + FIN_CH - 1) / FIN_CH, THREADS, 0, stream>>>(
      parts, G, C, var, t, w, eps, n, sums, dw, db, coef);
  return (int)cudaGetLastError();
}

// g, z (or null) [M, C] in the output's type; x, dx [M, C] in the input's;
// mean [C]; coef [3, C].
extern "C" int vince_bn_grad_apply(const void* g, const void* z, const void* x, const float* mean,
                                   const float* coef, void* dx, int M, int C, int in_bf16,
                                   int out_bf16, int vec, int tile, int slabs, int slab_rows,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = grid_of(M, C, vec, tile, slabs, slab_rows);
  const int in_b = vec * (in_bf16 ? 2 : 4), out_b = vec * (out_bf16 ? 2 : 4);
  if (grid.x == 0 || !aligned(x, in_b) || !aligned(dx, in_b) || !aligned(g, out_b) ||
      !aligned(z, out_b))
    return (int)cudaErrorInvalidValue;
  return dispatch<GradApply>(in_bf16, out_bf16, vec, grid, stream, g, z, x, mean, coef, dx, M, C,
                            tile, slab_rows);
}

// CTAs of 256 threads an SM holds at once of kernel ``kind`` (0 statistics,
// 1 apply, 2 gradient sums, 3 gradient apply) for the types and vector width;
// a negative CUDA error on failure.
extern "C" int vince_bn_ctas_per_sm(int kind, int in_bf16, int out_bf16, int vec) {
  if (kind < 0 || kind > 3 || !(vec == 1 || vec == 4 || (vec == 8 && in_bf16 && out_bf16)))
    return -(int)cudaErrorInvalidValue;
  return dispatch<Occupancy>(in_bf16, out_bf16, vec, kind);
}
