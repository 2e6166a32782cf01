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
// the float32 rate (67 TFLOP/s), not memory, is the bound.
//
// Design. On the TPU one core walks the queue block after block and carries
// (m, S, W) in VMEM. Here a grid over row blocks alone would be one CTA at
// B=128, so the queue is split into chunks across CTAs: CTA (r, c) streams the
// key tiles of chunk c for row block r with the same online rescaling and
// writes partial (m, S, W). A second small kernel merges the chunks with the
// exp(m_c - M) rescaling. Ragged B, K and D are masked, so every shape with
// D <= 256 launches. Each thread holds a 4x4 block of logits and a 4 x D/16
// block of W in registers; q and key tiles sit in padded shared memory and are
// read as float4, so that shared-memory loads do not outnumber the FMAs they
// feed (with scalar reads the kernel was bound by them, not by the FMA rate).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // queue keys per tile
constexpr int THREADS = 256;  // 16 x 16

template <int JJ>  // D <= 64 * JJ
__global__ void __launch_bounds__(THREADS)
qlse_partial_kernel(const float* __restrict__ q, const float* __restrict__ queue,
                    float* __restrict__ m_part, float* __restrict__ s_part,
                    float* __restrict__ w_part, int B, int K, int D,
                    float inv_temp, int tiles_per_chunk) {
  constexpr int DP = 64 * JJ;  // feature width in shared memory, zero-padded
  constexpr int LD = DP + 4;   // padded stride: the float4 reads of one quarter-warp
                               // (keys 16 apart, or consecutive) fall on distinct banks
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [BM][LD]
  float* k_s = q_s + BM * LD;      // [BN][LD]
  float* p_s = k_s + BN * LD;      // [BM][BN + 1]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM;
  const int chunk = blockIdx.y;
  const int key_begin = chunk * tiles_per_chunk * BN;
  const int key_end = min(K, key_begin + tiles_per_chunk * BN);

  // rows of q (and below, keys of the queue) into shared memory; columns past
  // D and rows past the end are zero
  auto load_rows = [&](const float* __restrict__ src, float* dst, int first, int end,
                       int rows) {
    // float4 loads where every row starts on a 16-byte boundary
    const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    for (int idx = threadIdx.x; idx < rows * (DP / 4); idx += THREADS) {
      int r = idx / (DP / 4), d = (idx % (DP / 4)) * 4;
      int gr = first + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < end) {
        const float* p = src + (size_t)gr * D + d;
        if (vec && d < D) {
          v = *reinterpret_cast<const float4*>(p);
        } else {
          if (d < D) v.x = p[0];
          if (d + 1 < D) v.y = p[1];
          if (d + 2 < D) v.z = p[2];
          if (d + 3 < D) v.w = p[3];
        }
      }
      *reinterpret_cast<float4*>(dst + r * LD + d) = v;
    }
  };
  load_rows(q, q_s, row0, B, BM);

  float m_run[4], s_run[4];
  float4 w_acc[4][JJ];  // rows ty + 16 i, features 64 jj + 4 tx .. + 3
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    s_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JJ; ++j) w_acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int dend = (D + 3) & ~3;

  for (int k0 = key_begin; k0 < key_end; k0 += BN) {
    __syncthreads();  // previous tile fully consumed (and q_s written)
    load_rows(queue, k_s, k0, key_end, BN);
    __syncthreads();

    // logits of rows ty + 16 i against keys tx + 16 j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < dend; d += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = fmaf(av[i].x, bv[j].x, acc[i][j]);
          t = fmaf(av[i].y, bv[j].y, t);
          t = fmaf(av[i].z, bv[j].z, t);
          acc[i][j] = fmaf(av[i].w, bv[j].w, t);
        }
    }

    float scale[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool valid = k0 + tx + 16 * j < key_end;
        acc[i][j] = valid ? acc[i][j] * inv_temp : -INFINITY;
        tmax = fmaxf(tmax, acc[i][j]);
      }
      // the 16 threads sharing a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      float m_new = fmaxf(m_run[i], tmax);  // finite: every tile holds a valid key
      scale[i] = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(acc[i][j] - m_new);  // exp(-inf) = 0 on masked keys
        p_s[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      s_run[i] = s_run[i] * scale[i] + psum;
      m_run[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JJ; ++j) {
        w_acc[i][j].x *= scale[i];
        w_acc[i][j].y *= scale[i];
        w_acc[i][j].z *= scale[i];
        w_acc[i][j].w *= scale[i];
      }
    for (int c = 0; c < BN; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (BN + 1) + c];
#pragma unroll
      for (int j = 0; j < JJ; ++j) {
        float4 kv = *reinterpret_cast<const float4*>(k_s + c * LD + 64 * j + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w_acc[i][j].x = fmaf(pv[i], kv.x, w_acc[i][j].x);
          w_acc[i][j].y = fmaf(pv[i], kv.y, w_acc[i][j].y);
          w_acc[i][j].z = fmaf(pv[i], kv.z, w_acc[i][j].z);
          w_acc[i][j].w = fmaf(pv[i], kv.w, w_acc[i][j].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gr = row0 + ty + 16 * i;
    if (gr >= B) continue;
    size_t base = (size_t)chunk * B + gr;
    if (tx == 0) {
      m_part[base] = m_run[i];
      s_part[base] = s_run[i];
    }
#pragma unroll
    for (int j = 0; j < JJ; ++j) {
      const float wv[4] = {w_acc[i][j].x, w_acc[i][j].y, w_acc[i][j].z, w_acc[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int d = 64 * j + 4 * tx + e;
        if (d < D) w_part[base * D + d] = wv[e];
      }
    }
  }
}

// One CTA per row: M = max_c m_c, S = sum_c exp(m_c - M) S_c, W likewise.
__global__ void qlse_combine_kernel(const float* __restrict__ m_part,
                                    const float* __restrict__ s_part,
                                    const float* __restrict__ w_part,
                                    float* __restrict__ m, float* __restrict__ s,
                                    float* __restrict__ w, int B, int D,
                                    int nchunks) {
  const int row = blockIdx.x;
  float mx = -INFINITY;
  for (int c = 0; c < nchunks; ++c) mx = fmaxf(mx, m_part[(size_t)c * B + row]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      size_t base = (size_t)c * B + row;
      acc += expf(m_part[base] - mx) * w_part[base * D + d];
    }
    w[(size_t)row * D + d] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      size_t base = (size_t)c * B + row;
      acc += expf(m_part[base] - mx) * s_part[base];
    }
    m[row] = mx;
    s[row] = acc;
  }
}

template <int JJ>
cudaError_t launch_partial(const float* q, const float* queue, float* m_part,
                           float* s_part, float* w_part, int B, int K, int D,
                           float inv_temp, int nchunks, int tiles_per_chunk,
                           cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)(BM + BN) * (64 * JJ + 4) + BM * (BN + 1));
  cudaError_t err = cudaFuncSetAttribute(
      qlse_partial_kernel<JJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + BM - 1) / BM, nchunks);
  qlse_partial_kernel<JJ><<<grid, THREADS, smem, stream>>>(
      q, queue, m_part, s_part, w_part, B, K, D, inv_temp, tiles_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// q [B, D], queue [K, D] float32, row-major and contiguous. Outputs m [B],
// s [B], w [B, D]; scratch m_part/s_part [nchunks, B], w_part [nchunks, B, D].
// Chunk c covers queue tiles [c * tiles_per_chunk, (c + 1) * tiles_per_chunk)
// of 64 keys; the caller picks nchunks so that no chunk is empty. D <= 256.
extern "C" int vince_queue_logsumexp_f32(const float* q, const float* queue,
                                         float* m, float* s, float* w,
                                         float* m_part, float* s_part,
                                         float* w_part, int B, int K, int D,
                                         float inv_temp, int nchunks,
                                         int tiles_per_chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || K <= 0 || D <= 0 || D > 256 || nchunks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      D <= 128 ? launch_partial<2>(q, queue, m_part, s_part, w_part, B, K, D,
                                   inv_temp, nchunks, tiles_per_chunk, stream)
               : launch_partial<4>(q, queue, m_part, s_part, w_part, B, K, D,
                                    inv_temp, nchunks, tiles_per_chunk, stream);
  if (err != cudaSuccess) return (int)err;
  qlse_combine_kernel<<<B, 128, 0, stream>>>(m_part, s_part, w_part, m, s, w, B, D,
                                             nchunks);
  return (int)cudaGetLastError();
}
