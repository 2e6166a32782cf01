// Streamed queue log-sum-exp for multi-pair InfoNCE (K1), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel vince_tpu/ops/pallas/infonce_kernel.py
// (_pallas_queue_logsumexp / _kernel). Per query row i it computes
//     m_i = max_n q_i.k_n / tau
//     S_i = sum_n exp(q_i.k_n / tau - m_i)
//     W_i = sum_n exp(q_i.k_n / tau - m_i) * k_n
// without writing the [B, K] logits to device memory.
//
// What bounds it on the H100: the work is 4*B*K*D float32 operations (the
// logits product and the exp-weighted key sum), done on the CUDA cores in
// float32 as the TPU kernel does (it casts both inputs to f32). At the slice's
// shape (B=128, K=65536, D=128) that is 4.3 GFLOP against 32 MB of queue, so
// the float32 rate (67 TFLOP/s), not memory, is the bound: the kernel has to
// keep the FMA pipes busy, and everything else (the online max and the exps,
// barriers, the key loads) has to stay small beside the FMAs or hide behind
// them. Next to the FMA pipes, shared memory holds the products back: an SM
// delivers 128 bytes a cycle to its lanes, a warp's 16-byte load takes four
// of those cycles even when its lanes share the address, and at the full FMA
// rate the lanes need a float of operand per four FMAs. The logits loop below
// loads 12 float4 a lane per 128 FMAs (two thirds of the FMA rate at most),
// the W loop 4 per 64 (at the edge); the register tiles are as large as the
// 64 W accumulators leave room for (PERF.md has the measurements).
//
// Design: flash attention's forward pass in float32 on the CUDA cores.
// - Work split. A CTA owns a block of BM rows (all 128 rows of the step, so
//   the queue is read once) and one chunk of the queue's 64-key tiles; the
//   wrapper sizes the chunks for one CTA per SM. q stays in shared memory for
//   the whole chunk; the key tiles come through a two-deep cp.async ring, so
//   tile t+1 loads while tile t is computed. Ragged keys and features are
//   zero-filled by the copies (4-byte copies where rows are not 16-byte
//   aligned) and masked keys get -inf logits.
// - Registers. Each of the 256 threads owns RI rows (ty + 16 i) against 4 keys
//   (tx + 16 j) of the logits tile, read as float4 along D from padded rows,
//   and the same RI rows against 4*DJ features of W, so that a row's rescale
//   factor is already in the registers of every thread that scales its W. Per
//   four features of D a thread loads RI + 4 float4 for 16 RI FMAs; per key of
//   the W product RI / 4 + DJ float4 (p and key) for 4 RI DJ FMAs.
// - Online max. The 16 lanes that share a row reduce its tile max by
//   shuffles; p = exp2(x log2e - m log2e) is one FMA and one MUFU a logit;
//   each lane keeps its own partial row sum (summed over the 16 lanes once,
//   at the end). p goes to shared memory key-major, a thread's RI rows side by
//   side, so that the W product reads them as float4.
// - Combine. Each CTA writes its chunk's (m, S, W); a second kernel merges
//   the chunks with the exp(m_c - M) rescaling, 8 warps a row over 32
//   features, each warp summing a fixed set of chunks in order. Every sum has
//   a fixed order, so two calls give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // queue keys per tile
constexpr int THREADS = 256;  // 16 row groups (ty) x 16 key / feature groups (tx)
constexpr int COMBINE_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of the partial kernel for RI rows a thread and D <= 64 DJ
constexpr int smem_bytes(int ri, int dj) {
  return 4 * (16 * ri * (64 * dj + 4) + 2 * BN * (64 * dj + 4) + BN * (16 * ri + 4));
}

__device__ __forceinline__ float exp2_approx(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok, bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
}

// rows [first, first + rows) of src [*, D] into dst [rows][DP + 4], by cp.async;
// rows at or past `end` and columns at or past D are zero-filled
template <int DP>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int first,
                                          int end, int rows, int D, bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {  // 16-byte copies: D % 4 == 0 and src 16-byte aligned
    for (int idx = threadIdx.x; idx < rows * (DP / 4); idx += THREADS) {
      const int r = idx / (DP / 4), c = idx % (DP / 4) * 4, gr = first + r;
      const bool ok = gr < end && c < D;
      copy_async(dst + r * LD + c, ok ? src + (size_t)gr * D + c : src, ok, true);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP, gr = first + r;
      const bool ok = gr < end && c < D;
      copy_async(dst + r * LD + c, ok ? src + (size_t)gr * D + c : src, ok, false);
    }
  }
  asm volatile("cp.async.commit_group;" ::);
}

// One CTA: rows [blockIdx.x BM, + BM) against the key tiles of chunk
// blockIdx.y; writes the chunk's m, S (m_part/s_part [B, nchunks]) and W
// (w_part [nchunks, B, D]).
template <int RI, int DJ>  // RI rows a thread (BM = 16 RI rows a CTA); D <= 64 DJ
__global__ void __launch_bounds__(THREADS, 1)
qlse_partial_kernel(const float* __restrict__ q, const float* __restrict__ queue,
                    float* __restrict__ m_part, float* __restrict__ s_part,
                    float* __restrict__ w_part, int B, int K, int D, float inv_temp,
                    int tiles_per_chunk, int vec) {
  constexpr int BM = 16 * RI;
  constexpr int DP = 64 * DJ;  // feature width in shared memory, zero-padded
  constexpr int LD = DP + 4;   // padded row stride: a quarter-warp's float4 reads of 8
                               // consecutive rows fall on distinct banks
  constexpr int LDP = BM + 4;  // the same for the rows of p
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [BM][LD]
  float* k_s = q_s + BM * LD;    // two tiles [BN][LD]
  float* p_s = k_s + 2 * BN * LD;  // [BN][LDP]: p of key n for row ty + 16 i at ty RI + i

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM;
  const int chunk = blockIdx.y, nchunks = gridDim.y;
  const int key_begin = chunk * tiles_per_chunk * BN;
  const int key_end = min(K, key_begin + tiles_per_chunk * BN);
  const int ntiles = (key_end - key_begin + BN - 1) / BN;
  const float c_exp = inv_temp * LOG2E;

  load_rows<DP>(q, q_s, row0, B, BM, D, vec);
  load_rows<DP>(queue, k_s, key_begin, key_end, BN, D, vec);

  float m_run[RI], s_run[RI];  // s_run: this lane's keys only, until the end
  float4 w_acc[RI][DJ];        // rows ty + 16 i, features 64 jj + 4 tx .. + 3
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = -INFINITY;
    s_run[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) w_acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < ntiles; ++t) {
    const float* kt = k_s + (t % 2) * BN * LD;
    const int k0 = key_begin + t * BN;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // tile t (and q) landed; every thread is done with tile t - 1
    if (t + 1 < ntiles)
      load_rows<DP>(queue, k_s + ((t + 1) % 2) * BN * LD, k0 + BN, key_end, BN, D, vec);

    // raw logits q.k of rows ty + 16 i against keys tx + 16 j
    float acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* qrow = q_s + ty * LD;
    const float* krow = kt + tx * LD;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(krow + 16 * j * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + 16 * i * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = fmaf(qv.x, kv[j].x, acc[i][j]);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          acc[i][j] = fmaf(qv.w, kv[j].w, a);
        }
      }
    }

    // online max and exps; the tile's rescale factor of each row stays in
    // registers for this thread's part of W
    const bool ragged = k0 + BN > key_end;
    float scale[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      if (ragged) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j >= key_end) acc[i][j] = -INFINITY;
      }
      float tmax = fmaxf(fmaxf(acc[i][0], acc[i][1]), fmaxf(acc[i][2], acc[i][3]));
      // the 16 lanes that share a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run[i], tmax * inv_temp);  // inv_temp > 0 keeps the order
      // m_new is -inf only while every key so far was masked (no chunk holds
      // such a tile, but -inf - -inf must not give NaN); an unchanged max
      // scales by exactly 1
      const bool none = m_new == -INFINITY;
      const float mb = none ? 0.f : m_new * LOG2E;
      scale[i] = none ? 1.f : exp2_approx((m_run[i] - m_new) * LOG2E);
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = exp2_approx(fmaf(acc[i][j], c_exp, -mb));
      s_run[i] = fmaf(s_run[i], scale[i], (p[0] + p[1]) + (p[2] + p[3]));
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = p[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < RI; i += 4)
        *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * LDP + ty * RI + i) =
            make_float4(acc[i][j], acc[i + 1][j], acc[i + 2][j], acc[i + 3][j]);
    __syncthreads();  // p of the whole tile in shared memory

    // W = W * scale + p @ keys, over the tile's keys
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        w_acc[i][jj].x *= scale[i];
        w_acc[i][jj].y *= scale[i];
        w_acc[i][jj].z *= scale[i];
        w_acc[i][jj].w *= scale[i];
      }
    const float* prow = p_s + ty * RI;
    const float* kcol = kt + 4 * tx;
#pragma unroll 8
    for (int n = 0; n < BN; ++n) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(prow + n * LDP + i);
        pv[i] = v.x, pv[i + 1] = v.y, pv[i + 2] = v.z, pv[i + 3] = v.w;
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(kcol + n * LD + 64 * jj);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          w_acc[i][jj].x = fmaf(pv[i], kv.x, w_acc[i][jj].x);
          w_acc[i][jj].y = fmaf(pv[i], kv.y, w_acc[i][jj].y);
          w_acc[i][jj].z = fmaf(pv[i], kv.z, w_acc[i][jj].z);
          w_acc[i][jj].w = fmaf(pv[i], kv.w, w_acc[i][jj].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    // the row's sum over its 16 lanes; a butterfly gives every lane the same bits
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s_run[i] += __shfl_xor_sync(0xffffffffu, s_run[i], off);
    const int gr = row0 + ty + 16 * i;
    if (gr >= B) continue;
    if (tx == 0) {
      m_part[(size_t)gr * nchunks + chunk] = m_run[i];
      s_part[(size_t)gr * nchunks + chunk] = s_run[i];
    }
    float* wrow = w_part + ((size_t)chunk * B + gr) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = 64 * jj + 4 * tx;
      if (vec && d < D) {
        *reinterpret_cast<float4*>(wrow + d) = w_acc[i][jj];
      } else {
        const float wv[4] = {w_acc[i][jj].x, w_acc[i][jj].y, w_acc[i][jj].z, w_acc[i][jj].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) wrow[d + e] = wv[e];
      }
    }
  }
}

// CTA (row, 32 features): M = max_c m_c, S = sum_c exp(m_c - M) S_c, W likewise.
// Warp w sums chunks w, w + 8, ... in order; the warps' sums are added in order.
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
qlse_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ s_part,
                    const float* __restrict__ w_part, float* __restrict__ m,
                    float* __restrict__ s, float* __restrict__ w, int B, int D, int nchunks) {
  extern __shared__ float scale_s[];  // [nchunks]
  __shared__ float part_s[COMBINE_WARPS][32];
  __shared__ float max_s[COMBINE_WARPS];
  const int row = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* mrow = m_part + (size_t)row * nchunks;
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) mx = fmaxf(mx, mrow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) max_s[warp] = mx;
  __syncthreads();
  mx = max_s[0];
#pragma unroll
  for (int i = 1; i < COMBINE_WARPS; ++i) mx = fmaxf(mx, max_s[i]);
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) scale_s[c] = expf(mrow[c] - mx);
  __syncthreads();

  const int d = blockIdx.y * 32 + lane;
  float acc = 0.f;
  if (d < D) {
    const float* wp = w_part + (size_t)row * D + d;
#pragma unroll 8
    for (int c = warp; c < nchunks; c += COMBINE_WARPS)
      acc = fmaf(scale_s[c], wp[(size_t)c * B * D], acc);
  }
  part_s[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = part_s[0][lane];
#pragma unroll
  for (int i = 1; i < COMBINE_WARPS; ++i) acc += part_s[i][lane];
  if (d < D) w[(size_t)row * D + d] = acc;
  if (blockIdx.y == 0) {
    const float* srow = s_part + (size_t)row * nchunks;
    float sum = 0.f;
    for (int c = lane; c < nchunks; c += 32) sum = fmaf(scale_s[c], srow[c], sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m[row] = mx;
      s[row] = sum;
    }
  }
}

template <int RI, int DJ>
cudaError_t launch_partial(const float* q, const float* queue, float* m_part, float* s_part,
                           float* w_part, int B, int K, int D, float inv_temp, int nchunks,
                           int tiles_per_chunk, int vec, cudaStream_t stream) {
  constexpr int smem = smem_bytes(RI, DJ);
  static const cudaError_t attr = cudaFuncSetAttribute(
      qlse_partial_kernel<RI, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((B + 16 * RI - 1) / (16 * RI), nchunks);
  qlse_partial_kernel<RI, DJ><<<grid, THREADS, smem, stream>>>(
      q, queue, m_part, s_part, w_part, B, K, D, inv_temp, tiles_per_chunk, vec);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the partial kernel at feature width D (the wrapper's
// schedule holds its own count equal to this one).
extern "C" int vince_queue_logsumexp_smem_bytes(int D) {
  return D <= 64 ? smem_bytes(8, 1) : D <= 128 ? smem_bytes(8, 2) : smem_bytes(4, 4);
}

// q [B, D], queue [K, D] float32, row-major and contiguous. Outputs m [B],
// s [B], w [B, D]; scratch m_part/s_part [B, nchunks], w_part [nchunks, B, D].
// Chunk c covers queue tiles [c * tiles_per_chunk, (c + 1) * tiles_per_chunk)
// of 64 keys; the chunks must cover every tile and none may be empty. Rows go
// in blocks of 128 (64 for D > 128). D <= 256.
extern "C" int vince_queue_logsumexp_f32(const float* q, const float* queue, float* m, float* s,
                                         float* w, float* m_part, float* s_part, float* w_part,
                                         int B, int K, int D, float inv_temp, int nchunks,
                                         int tiles_per_chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long tiles = (K + (long)BN - 1) / BN;
  if (B <= 0 || K <= 0 || D <= 0 || D > 256 || nchunks <= 0 || tiles_per_chunk <= 0 ||
      (long)nchunks * tiles_per_chunk < tiles || (long)(nchunks - 1) * tiles_per_chunk >= tiles)
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(queue) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w_part) % 16 == 0;
  cudaError_t err =
      D <= 64    ? launch_partial<8, 1>(q, queue, m_part, s_part, w_part, B, K, D, inv_temp,
                                        nchunks, tiles_per_chunk, vec, stream)
      : D <= 128 ? launch_partial<8, 2>(q, queue, m_part, s_part, w_part, B, K, D, inv_temp,
                                        nchunks, tiles_per_chunk, vec, stream)
                 : launch_partial<4, 4>(q, queue, m_part, s_part, w_part, B, K, D, inv_temp,
                                        nchunks, tiles_per_chunk, vec, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (D + 31) / 32);
  qlse_combine_kernel<<<grid, 32 * COMBINE_WARPS, sizeof(float) * nchunks, stream>>>(
      m_part, s_part, w_part, m, s, w, B, D, nchunks);
  return (int)cudaGetLastError();
}
