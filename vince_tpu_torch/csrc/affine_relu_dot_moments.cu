// Fused BN-apply + ReLU + 1x1 dot + input moments (K2), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel vince_tpu/ops/pallas/folded_dot_kernel.py
// (_pallas_impl / _kernel). For y [M, C] bf16, a, b [C] f32 and W [C, F] bf16
// (given transposed, wt = W^T [F, C]):
//     xh32 = relu(a * y + b)          (f32, never written to device memory)
//     out  = bf16(xh @ W)             xh = bf16(xh32), f32 accumulation
//     s1   = sum_rows xh32            (from the f32 xh, before rounding)
//     s2   = xh^T xh                  (bf16 xh, f32 accumulation)
//
// What bounds it on the H100: bytes at ResNet50 stages 2 and 3, operations at
// stage 4. The output [M, F] bf16 is 4x the input; stage 2 (M=100352, C=128,
// F=512) moves 129 MB for 13 GFLOP, so 3.35 TB/s, not the 989 TFLOP/s bf16
// rate, sets the least time; stage 4 (M=6272, C=512, F=2048) is 34 MB for 15
// GFLOP.
//
// Design. Three launches, as on the TPU the grid carries s1 and s2 across
// row blocks in VMEM and here blocks run in parallel:
//   1. main (out): persistent CTAs, about one per SM, walk work items of 128
//      rows x (F / fsplit) columns. Two consumer warpgroups own 64 rows each:
//      each reads its rows of y once per item, applies the affine + ReLU and
//      keeps x̂ in shared memory ("chunk-major", see hopper.cuh), then walks
//      its F columns in chunks of 128 with wgmma m64n128k16, x̂ as A and W as
//      B, accumulators in registers. The next item's first 32 channels of y
//      are loaded during an item's last F chunk. A producer warp streams W^T boxes of
//      [128 columns, 64 channels] by TMA (128-byte swizzle) through a ring of
//      mbarrier'd stages that both warpgroups share, so W is read from L2
//      once per 128 rows. The epilogue rounds to bf16, stages the 64 x 128
//      tile in shared memory, half at a time (so that C = 512 keeps 4 W
//      stages), and stores 16-byte vectors. fsplit > 1 splits F
//      over items where there are fewer row blocks than SMs (stage 4: 49 row
//      blocks), at the cost of building x̂ fsplit times. x̂ stays resident
//      for C <= 512; above that cap (C = 1152, 2048) it is rebuilt for each F
//      chunk in super-chunks of sc channels, reading y F / 128 times.
//   2. moments (s2 and s1): s2 is tiled into 128 x 128 blocks (upper triangle,
//      the matrix is symmetric), each tile split over M. A CTA recomputes x̂
//      for its two column strips, 64 rows at a time into double-buffered
//      chunk-major strips, and accumulates x̂_i^T x̂_j with wgmma reading both
//      strips MN-major (no transposed copy). A producer warp keeps 4 steps of
//      y in flight by TMA (holding them in registers, one step per thread,
//      left the pass at ~12 GB/s per SM). The diagonal tiles also sum the
//      f32 x̂ of their strip (s1 partials), so each channel is summed once.
//   3. reduce: sums the partials in a fixed order, 8 segments of partials per
//      element and then the 8, so the pass has C * C / 32 CTAs.
// Partials and a fixed order, not float atomics, so that s1 and s2 are
// bitwise reproducible from run to run. s2 is not fused into the main pass,
// at any C: at C = 128 a warpgroup would hold 96 f32 of s2 beside 64 of out
// and a prefetch of y, past the registers a consumer has, and it would still
// leave one 64 KB partial per warpgroup to reduce; the moments pass costs one
// more read of y (about a quarter of K2's time at ResNet50's sites, PERF.md).
// Rows past M are masked to x̂ = 0. C and F must be multiples of 128, y, wt
// and out 16-byte aligned.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;   // registers a thread of the producer keeps
constexpr int CONSUMER_REGS = 232;  // and of the consumers: 2 x 128 x 232 + 128 x 40 <= 64K
constexpr int WG_ROWS = 64;
constexpr int BLOCK_ROWS = CONSUMERS * WG_ROWS;  // rows of a work item
constexpr int BN = 128;                          // output columns per F chunk
constexpr int BK = 64;                           // channels per W stage
constexpr int W_STAGE_BYTES = BN * BK * 2;       // 16 KB
constexpr int MAX_STAGES = 8;
constexpr int SC_MAX = 512;  // channels of x̂ a warpgroup keeps
constexpr int STG_COLS = BN / 2;  // the epilogue stages half a chunk at a time
constexpr int STG_LD = STG_COLS + 8;  // staged output row (bf16): 144 bytes, no bank conflicts
constexpr int STG_BYTES = WG_ROWS * STG_LD * 2;
constexpr int SMEM_LIMIT = 232448;

constexpr int MOM_THREADS = 2 * WG_THREADS + 32;  // two warpgroups + a producer warp
constexpr int MOM_ROWS = 64;  // rows per step of the moments loop
constexpr int TILE = 128;     // s2 tile edge
constexpr int STRIP_BYTES = TILE / 8 * MOM_ROWS * 16;  // one chunk-major strip, 16 KB
constexpr int BOX_BYTES = MOM_ROWS * 64 * 2;           // a TMA box of y: 64 rows x 64 channels
constexpr int RAW_STAGES = 4;                          // steps of y in flight
constexpr int RAW_BYTES = 4 * BOX_BYTES;               // a step: 2 strips x 2 boxes
constexpr int MOM_SMEM = 1024 + RAW_STAGES * RAW_BYTES + 4 * STRIP_BYTES + 2 * RAW_STAGES * 8;

// shared memory of the main kernel besides the W ring
inline int main_fixed_bytes(int sc) {
  return 1024 + CONSUMERS * sc * WG_ROWS * 2 + CONSUMERS * STG_BYTES + 2 * MAX_STAGES * 8;
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

// y [rows r0 + g * 8 + lane % 8, 8 channels from c] for g < 8: one quad of 4
// chunks per warp, lane / 8 picking the chunk, so that a warp's load reads 64
// contiguous bytes of each of 8 rows; rows at or past r_end read as 0
__device__ __forceinline__ void fetch_quad(const __nv_bfloat16* __restrict__ y, uint4 (&raw)[8],
                                           int r0, int r_end, int c, int C, int lane) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int gr = r0 + g * 8 + lane % 8;
    raw[g] = gr < r_end ? __ldg(reinterpret_cast<const uint4*>(y + (size_t)gr * C + c))
                        : make_uint4(0, 0, 0, 0);
  }
}

// x̂ of those rows into chunk j of a chunk-major tile of `rows` rows; rows at
// or past r_end are 0. With S1 the f32 x̂ is added to sum8. The 16-byte
// stores of a quarter warp fall on 8 consecutive rows: no bank conflict.
template <bool S1>
__device__ __forceinline__ void store_quad(const uint4 (&raw)[8], const float (&a8)[8],
                                           const float (&b8)[8], float (&sum8)[8], uint8_t* tile,
                                           int rows, int j, int r0, int r_end, int lane) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int r = g * 8 + lane % 8;
    const bool valid = r0 + r < r_end;
    const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw[g]);
    __align__(16) __nv_bfloat16 xv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = valid ? affine_relu(__bfloat162float(yv[e]), a8[e], b8[e]) : 0.f;
      if (S1) sum8[e] += v;
      xv[e] = __float2bfloat16(v);
    }
    *reinterpret_cast<uint4*>(tile + ((size_t)j * rows + r) * 16) =
        *reinterpret_cast<const uint4*>(xv);
  }
}

// ---- 1. main: out -------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
ardm_main_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ y,
                 const float* __restrict__ a, const float* __restrict__ b,
                 __nv_bfloat16* __restrict__ out, int M, int C, int F, int fsplit, int sc,
                 int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);  // [stages][128 x 64] bf16, 128-byte swizzle
  uint8_t* xs_all = ring + stages * W_STAGE_BYTES;          // [2][sc / 8][64 rows][16 B]
  uint8_t* stg_all = xs_all + CONSUMERS * sc * WG_ROWS * 2;  // [2][64][STG_LD] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(stg_all + CONSUMERS * STG_BYTES);
  uint64_t* empty = full + MAX_STAGES;

  const int items = (M + BLOCK_ROWS - 1) / BLOCK_ROWS * fsplit;
  const int fchunks = F / BN / fsplit;  // F chunks of an item
  const int nsc = C / sc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // producer: the W^T boxes in the order the consumers take them, from one thread
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int fs = it % fsplit;
        for (int fc = 0; fc < fchunks; ++fc)
          for (int kb = 0; kb < C / BK; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], W_STAGE_BYTES);
            tma_load_2d(ring + stage * W_STAGE_BYTES, &wmap, &full[stage], kb * BK,
                        (fs * fchunks + fc) * BN);
            if (++stage == stages) stage = 0, phase ^= 1;
          }
      }
    }
    return;
  }

  // consumers
  reg_alloc<CONSUMER_REGS>();
  const int wg = warp / 4, wq = warp % 4;
  const int t = threadIdx.x % WG_THREADS;
  const int bar = 1 + wg;  // this warpgroup's named barrier
  uint8_t* xs = xs_all + wg * sc * WG_ROWS * 2;
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(stg_all + wg * STG_BYTES);
  const uint32_t xs_addr = smem_u32(xs), ring_addr = smem_u32(ring);
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float unused[8];
  // y of the next item's first quad, loaded during this item's last F chunk
  // where x̂ is built once per item (nsc = 1), so that the build waits less
  uint4 next[8];
  bool have_next = false;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row0 = (it / fsplit) * BLOCK_ROWS + wg * WG_ROWS;
    const int fs = it % fsplit;
    for (int fc = 0; fc < fchunks; ++fc) {
      const int f0 = (fs * fchunks + fc) * BN;
      for (int sci = 0; sci < nsc; ++sci) {
        if (fc == 0 || nsc > 1) {
          named_barrier(bar, WG_THREADS);  // every wgmma reading xs has completed
          for (int q = wq; q < sc / 32; q += 4) {
            const int j = q * 4 + lane / 8;
            const int c = sci * sc + j * 8;
            float a8[8], b8[8];
            load8(a + c, a8);
            load8(b + c, b8);
            uint4 raw[8];
            if (q == wq && have_next) {
#pragma unroll
              for (int g = 0; g < 8; ++g) raw[g] = next[g];
            } else {
              fetch_quad(y, raw, row0, M, c, C, lane);
            }
            store_quad<false>(raw, a8, b8, unused, xs, WG_ROWS, j, row0, M, lane);
          }
          have_next = false;
          fence_proxy_async();
          named_barrier(bar, WG_THREADS);
        }
        const int it_next = it + gridDim.x;
        if (nsc == 1 && fc == fchunks - 1 && it_next < items) {
          fetch_quad(y, next, (it_next / fsplit) * BLOCK_ROWS + wg * WG_ROWS, M,
                     (wq * 4 + lane / 8) * 8, C, lane);
          have_next = true;
        }
        int held = -1;  // the stage that the last committed group reads
        for (int kb = 0; kb < sc / BK; ++kb) {
          mbar_wait(&full[stage], phase);
          const uint32_t w_addr = ring_addr + stage * W_STAGE_BYTES;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n128k16<0, 0>(
                acc, desc_kmajor_chunks(xs_addr + (kb * 8 + kk * 2) * WG_ROWS * 16, WG_ROWS),
                desc_kmajor_sw128(w_addr + kk * 32), (sci | kb | kk) != 0);
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();  // the previous group is done: its stage goes back
          if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
          held = stage;
          if (++stage == stages) stage = 0, phase ^= 1;
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[held]);
      }

      // epilogue: round, stage 64 x 64 halves of the tile, store 16-byte vectors
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        named_barrier(bar, WG_THREADS);  // the staged rows before these are stored
        const int r = wq * 16 + lane / 4;
#pragma unroll
        for (int jn = 0; jn < STG_COLS / 8; ++jn) {
          const int col = jn * 8 + (lane % 4) * 2;
          const int i = 4 * (half * STG_COLS / 8 + jn);
          *reinterpret_cast<__nv_bfloat162*>(stg + r * STG_LD + col) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(stg + (r + 8) * STG_LD + col) =
              __floats2bfloat162_rn(acc[i + 2], acc[i + 3]);
        }
        named_barrier(bar, WG_THREADS);
#pragma unroll
        for (int i = 0; i < WG_ROWS * STG_COLS / 8 / WG_THREADS; ++i) {
          const int v = t + i * WG_THREADS;
          const int rr = v / (STG_COLS / 8), cc = (v % (STG_COLS / 8)) * 8;
          if (row0 + rr < M)
            *reinterpret_cast<uint4*>(out + (size_t)(row0 + rr) * F + f0 + half * STG_COLS + cc) =
                *reinterpret_cast<const uint4*>(stg + rr * STG_LD + cc);
        }
      }
    }
  }
}

// ---- 2. moments: s2 tile partials, s1 partials --------------------------------
// blockIdx.x enumerates the upper-triangle tile pairs (ti <= tj), blockIdx.y
// the split of rows. A producer warp brings y for each step of 64 rows by
// TMA (boxes of 64 rows x 64 channels, 128-byte swizzle) into a ring of
// RAW_STAGES steps; the consumers apply the affine into chunk-major strips:
// warp w takes quad w % 4 of strip w / 4 (strip 1 holds tj's channels; on the
// diagonal it is strip 0 and warps 4-7 only compute). Warpgroup w then
// accumulates rows [64 w, 64 w + 64) of the tile.
__global__ void __launch_bounds__(MOM_THREADS, 1)
ardm_moments_kernel(const __grid_constant__ CUtensorMap ymap, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ s1_part,
                    float* __restrict__ s2_part, int M, int C, int rows_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* raw = align1024(smem_raw);                 // [RAW_STAGES][2 strips][2 boxes]
  uint8_t* strips = raw + RAW_STAGES * RAW_BYTES;     // [2 buffers][2 strips][16][64][16 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(strips + 4 * STRIP_BYTES);
  uint64_t* empty = full + RAW_STAGES;

  const int T = C / TILE;
  int ti = 0, rem = blockIdx.x;
  while (rem >= T - ti) {
    rem -= T - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int steps = (r_end - r_begin + MOM_ROWS - 1) / MOM_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < RAW_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: the boxes of each step, both strips (one on the diagonal)
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&empty[st], phase ^ 1);
        mbar_expect_tx(&full[st], (diag ? 2 : 4) * BOX_BYTES);
        for (int strip = 0; strip < (diag ? 1 : 2); ++strip)
          for (int box = 0; box < 2; ++box)
            tma_load_2d(raw + st * RAW_BYTES + (strip * 2 + box) * BOX_BYTES, &ymap, &full[st],
                        (strip ? tj : ti) * TILE + box * 64, r_begin + s * MOM_ROWS);
        if (++st == RAW_STAGES) st = 0, phase ^= 1;
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int strip = warp / 4;
  const int j = (warp % 4) * 4 + lane / 8;  // chunk of the strip
  const int c = (strip ? tj : ti) * TILE + j * 8;
  const bool stages_strip = !(diag && strip == 1);
  float a8[8], b8[8], sum8[8];
  load8(a + c, a8);
  load8(b + c, b8);
#pragma unroll
  for (int e = 0; e < 8; ++e) sum8[e] = 0.f;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int st = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    uint8_t* buf = strips + (s & 1) * 2 * STRIP_BYTES;
    const int r0 = r_begin + s * MOM_ROWS;
    mbar_wait(&full[st], phase);
    if (stages_strip) {
      // box (strip, j / 8) holds chunk j % 8 of row r at r * 128 + ((j % 8) ^ (r % 8)) * 16
      const uint8_t* box = raw + st * RAW_BYTES + (strip * 2 + j / 8) * BOX_BYTES;
      uint4 v[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int r = g * 8 + lane % 8;
        v[g] = *reinterpret_cast<const uint4*>(box + r * 128 + (((j % 8) ^ (r % 8)) * 16));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (diag)
        store_quad<true>(v, a8, b8, sum8, buf, MOM_ROWS, j, r0, r_end, lane);
      else
        store_quad<false>(v, a8, b8, sum8, buf + strip * STRIP_BYTES, MOM_ROWS, j, r0, r_end,
                          lane);
    } else if (lane == 0) {
      mbar_arrive(&empty[st]);
    }
    if (++st == RAW_STAGES) st = 0, phase ^= 1;
    fence_proxy_async();
    named_barrier(1, 2 * WG_THREADS);  // both strips of this step are written
    const uint32_t xi = smem_u32(buf);
    const uint32_t xj = diag ? xi : xi + STRIP_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MOM_ROWS / 16; ++kk)
      wgmma_m64n128k16<1, 1>(
          acc, desc_mnmajor_chunks(xi + wg * 8 * MOM_ROWS * 16 + kk * 16 * 16, MOM_ROWS),
          desc_mnmajor_chunks(xj + kk * 16 * 16, MOM_ROWS), (s | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();  // this step's strips are read before the barrier of step s + 1
    fence_acc(acc);
  }

  float* dst = s2_part + (size_t)blockIdx.y * C * C;
  const int gi = ti * TILE + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int jn = 0; jn < TILE / 8; ++jn) {
    const int col = tj * TILE + jn * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * jn + 2 * h], v1 = acc[4 * jn + 2 * h + 1];
      const int row = gi + 8 * h;
      *reinterpret_cast<float2*>(dst + (size_t)row * C + col) = make_float2(v0, v1);
      if (!diag) {
        dst[(size_t)col * C + row] = v0;
        dst[(size_t)(col + 1) * C + row] = v1;
      }
    }
  }
  if (diag && strip == 0) {
    // the lanes that share a chunk hold 8 rows each: sum them in a fixed order
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sum8[e] += __shfl_xor_sync(0xffffffffu, sum8[e], 1);
      sum8[e] += __shfl_xor_sync(0xffffffffu, sum8[e], 2);
      sum8[e] += __shfl_xor_sync(0xffffffffu, sum8[e], 4);
    }
    if (lane % 8 == 0) {
      float4* d1 = reinterpret_cast<float4*>(s1_part + (size_t)blockIdx.y * C + c);
      d1[0] = make_float4(sum8[0], sum8[1], sum8[2], sum8[3]);
      d1[1] = make_float4(sum8[4], sum8[5], sum8[6], sum8[7]);
    }
  }
}

// ---- 3. reduce: fixed-order sums of the partials -----------------------------
// A CTA takes 32 elements of s2 (or s1) and 8 segments of the partials; the
// segments' sums are then added in order.
constexpr int RED_SEGS = 8;

__global__ void __launch_bounds__(32 * RED_SEGS)
ardm_reduce_kernel(const float* __restrict__ s1_part, const float* __restrict__ s2_part,
                   float* __restrict__ s1, float* __restrict__ s2, int C, int nparts) {
  __shared__ float red[RED_SEGS][32];
  const int s2_blocks = C * C / 32;
  const bool is2 = blockIdx.x < s2_blocks;
  const float* part = is2 ? s2_part : s1_part;
  float* res = is2 ? s2 : s1;
  const size_t E = is2 ? (size_t)C * C : (size_t)C;
  const size_t e = (size_t)(is2 ? blockIdx.x : blockIdx.x - s2_blocks) * 32 + threadIdx.x % 32;
  const int seg = threadIdx.x / 32;
  const int per = (nparts + RED_SEGS - 1) / RED_SEGS;
  const int end = min(nparts, (seg + 1) * per);
  float acc = 0.f;
#pragma unroll 4
  for (int p = seg * per; p < end; ++p) acc += part[(size_t)p * E + e];
  red[seg][threadIdx.x % 32] = acc;
  __syncthreads();
  if (seg == 0) {
    acc = 0.f;
#pragma unroll
    for (int g = 0; g < RED_SEGS; ++g) acc += red[g][threadIdx.x];
    res[e] = acc;
  }
}

}  // namespace

// y [M, C] bf16, a, b [C] f32, wt = W^T [F, C] bf16, all contiguous. Outputs
// out [M, F] bf16, s1 [C] f32, s2 [C, C] f32. Scratch s1_part [msplit, C] and
// s2_part [msplit, C, C] f32, with msplit * rows_per_split >= M and
// rows_per_split a multiple of 64. The main kernel runs `grid` CTAs over
// ceil(M / 128) * fsplit items; sc divides C, is a multiple of 128 and at most
// 512, and is C where C <= 512.
extern "C" int vince_affine_relu_dot_moments_bf16(
    const void* y, const float* a, const float* b, const void* wt, void* out, float* s1,
    float* s2, float* s1_part, float* s2_part, int M, int C, int F, int grid, int fsplit,
    int sc, int msplit, int rows_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M <= 0 || C <= 0 || F <= 0 || C % TILE || F % BN || grid <= 0 || fsplit <= 0 ||
      (F / BN) % fsplit || sc <= 0 || sc % TILE || sc > SC_MAX || C % sc ||
      (C <= SC_MAX && sc != C) || rows_per_split <= 0 || rows_per_split % MOM_ROWS ||
      (long long)msplit * rows_per_split < M || (long long)(msplit - 1) * rows_per_split >= M)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap wmap, ymap;
  int status = hopper_host::map_bf16_sw128(&wmap, wt, F, C, BN);
  if (!status) status = hopper_host::map_bf16_sw128(&ymap, y, M, C, MOM_ROWS);
  if (status) return status;
  int stages = (SMEM_LIMIT - main_fixed_bytes(sc)) / W_STAGE_BYTES;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = main_fixed_bytes(sc) + stages * W_STAGE_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(ardm_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ardm_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MOM_SMEM);
  if (err != cudaSuccess) return (int)err;

  ardm_main_kernel<<<grid, THREADS, smem, stream>>>(
      wmap, static_cast<const __nv_bfloat16*>(y), a, b, static_cast<__nv_bfloat16*>(out), M, C,
      F, fsplit, sc, stages);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int T = C / TILE;
  ardm_moments_kernel<<<dim3(T * (T + 1) / 2, msplit), MOM_THREADS, MOM_SMEM, stream>>>(
      ymap, a, b, s1_part, s2_part, M, C, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ardm_reduce_kernel<<<C * C / 32 + C / 32, 32 * RED_SEGS, 0, stream>>>(s1_part, s2_part, s1, s2,
                                                                      C, msplit);
  return (int)cudaGetLastError();
}
