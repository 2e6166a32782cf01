// Fused BN-apply + ReLU + 3x3 convolution + batch-statistic sums (K3), CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel vince_tpu/ops/pallas/conv_bn_kernel.py
// (_pallas_impl / _kernel). For y_prev [N, H, W, C] bf16, a, b [C] f32 and the
// filter [3, 3, C, F] bf16 (given as the matrix kt [F, 9C], row f holding
// column (ky * 3 + kx) * C + c):
//     xh = bf16(relu(a * y_prev + b))      (never written to device memory)
//     y  = bf16(conv3x3(xh, filter))       stride 1, zero padding 1, f32 sums
//     s1 = sum_{n,h,w} y                   of the stored (rounded) y, in f32
//     s2 = sum_{n,h,w} y^2
//
// What bounds it on the H100: operations. 2*9*C*F per output pixel against
// 2(C + F) bytes is far above the card's ~295 bf16 operations per byte at the
// ResNet50 sites (C = F >= 128), so the tensor cores set the least time.
//
// Design. An implicit GEMM on wgmma. A CTA owns up to 256 output positions
// (four wgmma tiles of 64 rows; consumer warpgroup w takes tiles w and w + 2)
// and 128 output features. Its positions are th rows of k images side by side
// (a small map) or of one column tile of tw columns (a wide one): the halo,
// th + 2 rows of pw = 1 + k (tw + 1) pixels (a zero column between the images
// and at each side), goes through the affine + ReLU into shared memory once
// per chunk of 128 input channels, "chunk-major" (hopper.cuh). An output
// position p = hl * pw + wl then finds its tap (ky, kx) at halo row
// p + ky * pw + kx, a constant shift: each tap is a plain [64 x 128] @
// [128 x 128] product whose A descriptor starts `shift` rows lower, which the
// unswizzled layout allows for any shift. Positions of a padding column or
// past the tile are computed and thrown away, which keeps A a constant-stride
// matrix. A producer warp streams the filter by TMA (128-byte swizzle) in
// boxes of [128 features, 64 channels of one tap], 18 per channel chunk,
// through a 4-stage ring of mbarriers, so the consumers never wait on a CTA
// barrier inside a chunk. The epilogue rounds to bf16, stages each 64 x 128
// tile in shared memory, stores 16-byte vectors and sums the stored values
// per feature into per-CTA partials; a second kernel adds the partials in a
// fixed order, so s1 and s2 are bitwise reproducible (no float atomics). C
// must be a multiple of 128; any N, H, W, F launches (F that is not a
// multiple of 8 takes scalar stores; TMA reads filter rows past F as zeros).

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;   // registers a thread of the producer keeps
constexpr int CONSUMER_REGS = 232;  // and of the consumers: 2 x 128 x 232 + 128 x 40 <= 64K
constexpr int TILES = 4;                              // wgmma tiles of 64 positions
constexpr int MAX_POS = TILES * 64;
constexpr int CK = 128;  // input channels per halo chunk
constexpr int BN = 128;  // output features per CTA
constexpr int BK = 64;   // filter rows (channels of one tap) per stage
constexpr int W_STAGE_BYTES = BN * BK * 2;
constexpr int STAGES = 4;
constexpr int STG_LD = BN + 8;
constexpr int STG_BYTES = 64 * STG_LD * 2;
constexpr int PHASES = WG_THREADS / (BN / 8);  // row phases of the epilogue
constexpr int RED_BYTES = CONSUMERS * 2 * PHASES * BN * 4;
constexpr int HALO_BATCH = 4;  // halo loads a thread keeps in flight
constexpr int SMEM_LIMIT = 232448;

// halo rows that MT tiles per warpgroup read: the last tile's farthest tap
__host__ __device__ inline int halo_rows(int mt, int pw) {
  return (mt * CONSUMERS * 64 + 2 * pw + 2 + 7) / 8 * 8;
}

inline int smem_bytes(int mt, int pw) {
  return 1024 + STAGES * W_STAGE_BYTES + halo_rows(mt, pw) * CK * 2 + CONSUMERS * STG_BYTES +
         RED_BYTES + 2 * STAGES * 8;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// grid: x = (group of k images, band of th rows, column tile), y = slice of
// 128 output features. MT wgmma tiles per warpgroup (1 where the CTA has at
// most 128 positions): every tile is computed, so no wgmma sits in a
// divergent path, which would serialise them
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
acs_main_kernel(const __grid_constant__ CUtensorMap kmap, const __nv_bfloat16* __restrict__ y_prev,
                const float* __restrict__ a, const float* __restrict__ b,
                __nv_bfloat16* __restrict__ y, float* __restrict__ s1_part,
                float* __restrict__ s2_part, int N, int H, int W, int C, int F, int Fp, int th,
                int tw, int k) {
  extern __shared__ uint8_t smem_raw[];
  const int pw = 1 + k * (tw + 1);
  const int npos = th * pw;
  const int R = halo_rows(MT, pw);
  uint8_t* ring = align1024(smem_raw);
  uint8_t* halo = ring + STAGES * W_STAGE_BYTES;  // [16 chunks][R rows][16 B]
  uint8_t* stg_all = halo + R * CK * 2;           // [2][64][STG_LD] bf16
  float* red = reinterpret_cast<float*>(stg_all + CONSUMERS * STG_BYTES);  // [2][2][8][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(red) + RED_BYTES);
  uint64_t* empty = full + STAGES;

  const int bands = (H + th - 1) / th;
  const int ctiles = (W + tw - 1) / tw;
  int bid = blockIdx.x;
  const int w0 = (bid % ctiles) * tw;
  bid /= ctiles;
  const int h0 = (bid % bands) * th;
  const int n0 = (bid / bands) * k;
  const int f0 = blockIdx.y * BN;
  const int chunks = C / CK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // producer: 9 taps x 2 halves of each channel chunk, from one thread
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int chunk = 0; chunk < chunks; ++chunk)
        for (int tap = 0; tap < 9; ++tap)
          for (int half = 0; half < 2; ++half) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], W_STAGE_BYTES);
            tma_load_2d(ring + stage * W_STAGE_BYTES, &kmap, &full[stage],
                        tap * C + chunk * CK + half * BK, f0);
            if (++stage == STAGES) stage = 0, phase ^= 1;
          }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = warp / 4, wq = warp % 4;
  const int t = threadIdx.x % WG_THREADS;
  const uint32_t halo_addr = smem_u32(halo), ring_addr = smem_u32(ring);
  const __nv_bfloat16* image0 = y_prev + (size_t)n0 * H * W * C;
  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;

  for (int chunk = 0; chunk < chunks; ++chunk) {
    named_barrier(1, CONSUMERS * WG_THREADS);  // every wgmma reading the halo has completed
    {
      // xh of this chunk over the halo, zero outside the images (the
      // convolution pads xh, not y_prev) and in the rows past the halo. Warp
      // w fills quad w % 4 (lane / 8 picks the chunk) of row groups w / 4,
      // w / 4 + 2, ...; lane % 8 is the row in the group
      const int j = wq * 4 + lane / 8;
      const int c = chunk * CK + j * 8;
      float a8[8], b8[8];
      load8(a + c, a8);
      load8(b + c, b8);
      for (int g0 = wg; g0 < R / 8; g0 += 2 * HALO_BATCH) {
        uint4 raw[HALO_BATCH];
        bool ok[HALO_BATCH];
#pragma unroll
        for (int u = 0; u < HALO_BATCH; ++u) {
          const int row = (g0 + 2 * u) * 8 + lane % 8;
          const int hrow = row / pw, hcol = row % pw;
          const int gh = h0 - 1 + hrow;
          const int slot = hcol == 0 ? 0 : (hcol - 1) / (tw + 1);
          const int gw = hcol == 0 ? w0 - 1 : w0 + (hcol - 1) % (tw + 1);
          ok[u] = g0 + 2 * u < R / 8 && hrow < th + 2 && gh >= 0 && gh < H && gw >= 0 &&
                  gw < W && n0 + slot < N;
          raw[u] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(
                               image0 + (((size_t)slot * H + gh) * W + gw) * C + c))
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < HALO_BATCH; ++u) {
          if (g0 + 2 * u >= R / 8) break;
          const int row = (g0 + 2 * u) * 8 + lane % 8;
          const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw[u]);
          __align__(16) __nv_bfloat16 xv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            xv[e] = __float2bfloat16(
                ok[u] ? affine_relu(__bfloat162float(yv[e]), a8[e], b8[e]) : 0.f);
          *reinterpret_cast<uint4*>(halo + ((size_t)j * R + row) * 16) =
              *reinterpret_cast<const uint4*>(xv);
        }
      }
    }
    fence_proxy_async();
    named_barrier(1, CONSUMERS * WG_THREADS);

    int held = -1;
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * pw + tap % 3;
      for (int half = 0; half < 2; ++half) {
        mbar_wait(&full[stage], phase);
        const uint32_t w_addr = ring_addr + stage * W_STAGE_BYTES;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = desc_kmajor_sw128(w_addr + kk * 32);
          const int accumulate = (chunk | tap | half | kk) != 0;
          const int kc = half * 8 + kk * 2;  // first 8-channel chunk of this k16 step
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_m64n128k16<0, 0>(
                  acc[mt],
                  desc_kmajor_chunks(halo_addr + (kc * R + (wg + 2 * mt) * 64 + shift) * 16, R),
                  db, accumulate);
        }
        wgmma_commit();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) mbar_arrive(&empty[held]);
  }

  // round, stage, store, and sum the rounded values: a thread keeps one group
  // of 8 features for the rows of its phase
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(stg_all + wg * STG_BYTES);
  const int fg = t % (BN / 8);
  const int ph = t / (BN / 8);
  const int f = f0 + fg * 8;
  float sum8[8], sq8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum8[e] = sq8[e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if ((wg + 2 * mt) * 64 >= npos) break;  // uniform over the warpgroup
    named_barrier(2 + wg, WG_THREADS);  // the previous tile's staged rows are stored
    {
      const int r = wq * 16 + lane / 4;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int col = jn * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(stg + r * STG_LD + col) =
            __floats2bfloat162_rn(acc[mt][4 * jn], acc[mt][4 * jn + 1]);
        *reinterpret_cast<__nv_bfloat162*>(stg + (r + 8) * STG_LD + col) =
            __floats2bfloat162_rn(acc[mt][4 * jn + 2], acc[mt][4 * jn + 3]);
      }
    }
    named_barrier(2 + wg, WG_THREADS);
    for (int r = ph; r < 64; r += PHASES) {
      const int p = (wg + 2 * mt) * 64 + r;
      const int hl = p / pw, wl = p % pw;
      const int slot = wl / (tw + 1), lc = wl % (tw + 1);
      const int gh = h0 + hl, gw = w0 + lc;
      if (p >= npos || lc >= tw || slot >= k || gh >= H || gw >= W || n0 + slot >= N) continue;
      const __nv_bfloat16* yv = stg + r * STG_LD + fg * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = __bfloat162float(yv[e]);
        sum8[e] += v;
        sq8[e] += v * v;
      }
      __nv_bfloat16* dst = y + ((((size_t)(n0 + slot)) * H + gh) * W + gw) * F + f;
      if (F % 8 == 0) {
        if (f < F) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(yv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (f + e < F) dst[e] = yv[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[((wg * 2 + 0) * PHASES + ph) * BN + fg * 8 + e] = sum8[e];
    red[((wg * 2 + 1) * PHASES + ph) * BN + fg * 8 + e] = sq8[e];
  }
  named_barrier(1, CONSUMERS * WG_THREADS);
  if (threadIdx.x < BN) {  // fixed-order sum over the warpgroups and phases
    float t1 = 0.f, t2 = 0.f;
    for (int g = 0; g < CONSUMERS; ++g)
      for (int p = 0; p < PHASES; ++p) {
        t1 += red[((g * 2 + 0) * PHASES + p) * BN + threadIdx.x];
        t2 += red[((g * 2 + 1) * PHASES + p) * BN + threadIdx.x];
      }
    s1_part[(size_t)blockIdx.x * Fp + f0 + threadIdx.x] = t1;
    s2_part[(size_t)blockIdx.x * Fp + f0 + threadIdx.x] = t2;
  }
}

// fixed-order sums of the per-CTA partials: 8 segments per feature, then the 8
constexpr int RED_SEGS = 8;

__global__ void __launch_bounds__(32 * RED_SEGS)
acs_reduce_kernel(const float* __restrict__ s1_part, const float* __restrict__ s2_part,
                  float* __restrict__ s1, float* __restrict__ s2, int F, int Fp, int nparts) {
  __shared__ float red2[2][RED_SEGS][32];
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
  red2[0][seg][fl] = t1;
  red2[1][seg][fl] = t2;
  __syncthreads();
  if (seg == 0 && f < F) {
    t1 = t2 = 0.f;
    for (int g = 0; g < RED_SEGS; ++g) {
      t1 += red2[0][g][fl];
      t2 += red2[1][g][fl];
    }
    s1[f] = t1;
    s2[f] = t2;
  }
}

}  // namespace

// y_prev [N, H, W, C] bf16, a, b [C] f32, kt [F, 9C] bf16 (row f, column
// (ky*3+kx)*C + c), all contiguous. Outputs y [N, H, W, F] bf16, s1, s2 [F]
// f32. Scratch s1_part, s2_part [ceil(N/k) * ceil(H/th) * ceil(W/tw), Fp] f32,
// Fp = F rounded up to a multiple of 128; `parts` is the number of their
// rows, which must be the CTAs' count. A CTA's positions are th rows of k
// images of tw columns side by side, th * (1 + k * (tw + 1)) <= 256; k > 1
// only with tw = W.
extern "C" int vince_affine_conv3x3_stats_bf16(
    const void* y_prev, const float* a, const float* b, const void* kt, void* y, float* s1,
    float* s2, float* s1_part, float* s2_part, int N, int H, int W, int C, int F, int th,
    int tw, int k, int parts, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int Fp = (F + BN - 1) / BN * BN;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % CK || th <= 0 || tw <= 0 ||
      k <= 0 || (k > 1 && tw != W) || (long long)th * (1 + (long long)k * (tw + 1)) > MAX_POS)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y_prev) % 16 || reinterpret_cast<uintptr_t>(kt) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long nparts =
      (long long)((N + k - 1) / k) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  if (nparts != parts || Fp / BN > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap kmap;
  int status = hopper_host::map_bf16_sw128(&kmap, kt, F, 9 * (uint64_t)C, BN);
  if (status) return status;
  const int pw = 1 + k * (tw + 1);
  const int mt = th * pw > CONSUMERS * 64 ? 2 : 1;
  const int smem = smem_bytes(mt, pw);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = mt == 2 ? acs_main_kernel<2> : acs_main_kernel<1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nparts, Fp / BN);
  kernel<<<grid, THREADS, smem, stream>>>(
      kmap, static_cast<const __nv_bfloat16*>(y_prev), a, b, static_cast<__nv_bfloat16*>(y),
      s1_part, s2_part, N, H, W, C, F, Fp, th, tw, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  acs_reduce_kernel<<<(F + 31) / 32, 32 * RED_SEGS, 0, stream>>>(s1_part, s2_part, s1, s2, F,
                                                                 Fp, parts);
  return (int)cudaGetLastError();
}

// The shared memory a CTA of the tile (th, tw, k) takes; the wrapper's tiling
// keeps a copy of this count in Python, held equal to it on the card.
extern "C" int vince_affine_conv3x3_stats_smem_bytes(int th, int tw, int k) {
  const int pw = 1 + k * (tw + 1);
  return smem_bytes(th * pw > CONSUMERS * 64 ? 2 : 1, pw);
}
