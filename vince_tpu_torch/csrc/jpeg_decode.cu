// JPEG decode on the card (nvJPEG) and the hand-written kernels after it:
// one fused kernel on the decode's path, from the YCbCr planes to the square
// RGB canvas, and the two kernels it replaced (libjpeg's chroma upsampling
// and YCbCr -> RGB conversion, and a bilinear resize), kept off every path as
// stand-alone ops. CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: it is the counterpart of the host C++ decoder
// vince_tpu/native/decode.cc (libjpeg decode + resize_bilinear_rgb, :54-114),
// which the JAX package runs behind --native-decode, and of the cv2 read that
// both packages fall back to. The entropy decode and the IDCT are a library's
// in both packages (libjpeg there, nvJPEG here); what follows them is here.
//
// Decode. nvJPEG's library handle is made once per process and shared
// (nvJPEG documents the handle as thread-safe); a decoder belongs to one host
// thread. nvJPEG's default backend (Huffman decode on the host, the IDCT on
// the card) decodes each stream to planar YCbCr at the stream's own chroma
// subsampling (grayscale: Y alone) into the buffer the caller allocated, on
// the caller's stream. nvjpegDecode returns while its image's work is still
// queued on the stream, and a decode state reused before that work ends can
// give the image another image's data: on the H100 a batch decoded back to
// back on one state now and then came out with an image, or a run of them,
// wrong (chip_smoke.py phase 2). So a decoder holds two states, used in turn,
// and an event after each image's work: a state is reused only once the
// event of its last image has fired, and the host's Huffman decode of one
// image still overlaps the card's work on the one before. nvJPEG has no
// DCT-domain scaled decode (decode.cc:138-152 picks m/8), so the image is
// decoded at full size and the resize does all the shrinking. A stream
// nvJPEG rejects (not a JPEG, a coding it does not take, truncated) is
// reported as refused, and the caller reads that file by other means; every
// other nvJPEG status is a failure of the library or the card and is
// returned as an error.
//
// The arithmetic. libjpeg's (and so cv2's) "fancy" chroma upsampling
// (jdsample.c: h2v1, h1v2 and h2v2 triangular filters with their rounding
// biases, the edges replicated, box replication for planes of width <= 2) and
// its fixed-point YCbCr -> RGB conversion (jdcolor.c, 16-bit fractions, the
// same rounding), in integers: libjpeg's pixels from libjpeg's planes.
// nvJPEG's own RGB output upsamples chroma otherwise (4:2:0 frames came out
// up to 12 levels from cv2's at the 99th percentile on the H100). Then
// decode.cc's resize: cv2.INTER_LINEAR with half-pixel centres, src = (dst +
// 0.5) * (in / out) - 0.5 clamped at 0, the upper neighbour clamped to the
// edge, a horizontal lerp of each of the two source rows, a vertical lerp of
// those, + 0.5 and truncation to uint8. Every product and sum is rounded on
// its own (__fmul_rn, __fadd_rn: no fused multiply-add), in decode.cc's
// order, so the kernels give the plain PyTorch versions' bits.
//
// ycc_resize_canvas_kernel, the path's kernel. Its least traffic is the
// planes read once (1.5 bytes a pixel at 4:2:0) and the canvas written once;
// the two kernels before it also wrote the full-size RGB image and read it
// back, 2/3 of their traffic. One block of 256 threads makes a band of
// output rows of one frame (the frame in blockIdx.y), and the RGB it
// interpolates from never leaves shared memory:
//   - the frame's meta is read once, into shared memory;
//   - the band's column coordinates, neighbours and weights and its rows'
//     are computed once; the source columns and rows that they touch are
//     listed once each, in order (a block-wide prefix sum), so that a frame
//     shrunk by 10 converts 1 in 5 of its pixels and not all of them;
//   - each listed pixel of each listed row is converted to RGB once, into
//     shared memory, Y and chroma read through L1: neighbouring threads read
//     neighbouring bytes, so a warp's reads fall in one or two 32-byte
//     sectors and each byte comes from device memory about once;
//   - the band's output rows are assembled in shared memory and written
//     with 16-byte stores (bytes at an unaligned head and tail);
//   - no integer division in the loops: subsampling by shifts, the flat
//     loops over (row, column) by carried indices.
// The shared memory depends on the canvas and the band alone (the listed
// columns are at most 2 * canvas), so a frame of any width takes the same
// block: 39 KB for 8 rows of a 256 canvas. Adjacent bands convert the source
// row between them twice (~9% of the rows at 360 -> 256 with 8-row bands);
// a call of few frames takes narrower bands, so that its grid still fills
// the card (fused_launch_rows), and converts more rows twice.
// What holds it back on the H100 is not bytes but instructions: a converted
// pixel costs ~100 (eight chroma byte loads at 4:2:0, the index arithmetic,
// the conversion, three byte stores), and with the chroma left out it takes
// 58% of its time (tools/jpeg_variants.py). Staging the rows in shared
// memory with 16-byte loads first, 4-byte RGB slots, four conversions a
// thread at once, per-row offset tables, a shuffle scan and blocks of 128 or
// 512 threads were each tried on the card and were slower or no faster.
//
// ycc_to_rgb_kernel and resize_bilinear_rgb_kernel (the path's kernels before
// the fused one): one thread per output pixel or output byte, the full-size
// RGB image in device memory between them. Kept as stand-alone ops and
// checked against their plain versions, beside the fused kernel.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int NVJPEG_ERROR = 1000;  // a failed nvJPEG call returns NVJPEG_ERROR + its status
constexpr int REFUSED = -1;        // nvJPEG rejected the stream itself

std::mutex g_mu;
bool g_ready = false;
int g_status = 0;
nvjpegHandle_t g_handle = nullptr;  // nvJPEG's default backend

int init_handle() {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_ready) return g_status;
  g_ready = true;
  const nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0, &g_handle);
  g_status = s == NVJPEG_STATUS_SUCCESS ? 0 : NVJPEG_ERROR + (int)s;
  return g_status;
}

// 0 on success, REFUSED where the status is about the stream, else NVJPEG_ERROR + status.
int outcome(nvjpegStatus_t s) {
  switch (s) {
    case NVJPEG_STATUS_SUCCESS: return 0;
    case NVJPEG_STATUS_BAD_JPEG:
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM: return REFUSED;
    default: return NVJPEG_ERROR + (int)s;
  }
}

// One chroma plane upsampled to the output pixel (y, x) as libjpeg does.
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ p, int cw, int ch, int hs,
                                         int vs, int y, int x) {
  if (hs == 1 && vs == 1) return p[y * cw + x];
  const int r = y / vs, i = x / hs;
  if (hs == 2 && cw <= 2) return p[r * cw + i];  // h2v1_upsample / h2v2_upsample
  if (vs == 1) {  // h2v1_fancy_upsample
    const int odd = x & 1;
    const int j = min(max(i + (odd ? 1 : -1), 0), cw - 1);
    return (3 * p[r * cw + i] + p[r * cw + j] + (odd ? 2 : 1)) >> 2;
  }
  const int lower = y & 1;
  const int r2 = min(max(r + (lower ? 1 : -1), 0), ch - 1);
  if (hs == 1)  // h1v2_fancy_upsample
    return (3 * p[r * cw + x] + p[r2 * cw + x] + (lower ? 2 : 1)) >> 2;
  const int odd = x & 1;  // h2v2_fancy_upsample
  const int j = min(max(i + (odd ? 1 : -1), 0), cw - 1);
  const int si = 3 * p[r * cw + i] + p[r2 * cw + i];
  const int sj = 3 * p[r * cw + j] + p[r2 * cw + j];
  return (3 * si + sj + (odd ? 7 : 8)) >> 4;
}

// meta [n, 8] int64: the planes' byte offset, height, width, chroma width,
// chroma height, horizontal and vertical subsampling (0, 0: grayscale), the
// RGB image's byte offset in out.
__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ src,
                                  const long long* __restrict__ meta,
                                  uint8_t* __restrict__ out) {
  const long long* m = meta + 8 * blockIdx.y;
  const int h = (int)m[1], w = (int)m[2], cw = (int)m[3], ch = (int)m[4];
  const int hs = (int)m[5], vs = (int)m[6];
  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= h * w) return;
  const int y = pixel / w, x = pixel % w;
  const uint8_t* planes = src + m[0];
  const int luma = planes[pixel];
  uint8_t* rgb = out + m[7] + 3LL * pixel;
  if (hs == 0) {
    rgb[0] = rgb[1] = rgb[2] = (uint8_t)luma;
    return;
  }
  const uint8_t* cb_plane = planes + (long long)h * w;
  const int cb = upsampled(cb_plane, cw, ch, hs, vs, y, x) - 128;
  const int cr = upsampled(cb_plane + (long long)ch * cw, cw, ch, hs, vs, y, x) - 128;
  const int r = luma + ((91881 * cr + 32768) >> 16);
  const int g = luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
  const int b = luma + ((116130 * cb + 32768) >> 16);
  rgb[0] = (uint8_t)min(max(r, 0), 255);
  rgb[1] = (uint8_t)min(max(g, 0), 255);
  rgb[2] = (uint8_t)min(max(b, 0), 255);
}

__global__ void resize_bilinear_rgb_kernel(const uint8_t* __restrict__ src,
                                           const long long* __restrict__ meta, int canvas,
                                           uint8_t* __restrict__ out) {
  const int img = blockIdx.y;
  const long long offset = meta[3 * img];
  const int sh = (int)meta[3 * img + 1];
  const int sw = (int)meta[3 * img + 2];
  const int per_image = canvas * canvas * 3;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_image) return;
  const int c = i % 3;
  const int x = (i / 3) % canvas;
  const int y = i / (3 * canvas);
  const float sy = __fdiv_rn((float)sh, (float)canvas);
  const float sx = __fdiv_rn((float)sw, (float)canvas);
  float fy = __fsub_rn(__fmul_rn(__fadd_rn((float)y, 0.5f), sy), 0.5f);
  if (fy < 0.f) fy = 0.f;
  int y0 = (int)fy;
  if (y0 > sh - 1) y0 = sh - 1;
  const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
  const float wy = __fsub_rn(fy, (float)y0);
  float fx = __fsub_rn(__fmul_rn(__fadd_rn((float)x, 0.5f), sx), 0.5f);
  if (fx < 0.f) fx = 0.f;
  int x0 = (int)fx;
  if (x0 > sw - 1) x0 = sw - 1;
  const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
  const float wx = __fsub_rn(fx, (float)x0);
  const uint8_t* r0 = src + offset + (long long)y0 * sw * 3 + c;
  const uint8_t* r1 = src + offset + (long long)y1 * sw * 3 + c;
  const int a0 = r0[3 * x0], b0 = r0[3 * x1], a1 = r1[3 * x0], b1 = r1[3 * x1];
  const float t0 = __fadd_rn((float)a0, __fmul_rn(wx, (float)(b0 - a0)));
  const float t1 = __fadd_rn((float)a1, __fmul_rn(wx, (float)(b1 - a1)));
  const float v = __fadd_rn(__fadd_rn(t0, __fmul_rn(wy, __fsub_rn(t1, t0))), 0.5f);
  out[(long long)img * per_image + i] = (uint8_t)v;
}

// ---- the fused kernel: YCbCr planes -> the canvas ----

constexpr int FUSED_META = 7;    // meta columns: see ycc_resize_canvas_kernel
constexpr int MAX_BAND = 8;      // output rows of a band, fewer for a wide canvas
constexpr int SMEM_LIMIT = 232448;  // the shared memory a block may take on the H100

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The fused kernel's shared memory, carved from one dynamic buffer (its
// base, or nullptr to count the bytes).
struct FusedSmem {
  long long* meta;  // [FUSED_META]
  int* count;       // [2]: the listed rows, the listed columns
  int* ry0;         // [MAX_BAND] each output row's source rows, weight, and
  int* ry1;         //   the places of its two rows in the list
  float* wy;
  int* rslot0;
  int* rslot1;
  int* urow;        // [2 * MAX_BAND] the listed source rows, ascending
  int* part;        // [THREADS] the prefix sum's scratch
  int* cx0;         // [canvas] each output column's source columns, weight,
  int* cx1;         //   and the places of its two columns in the list
  float* wx;
  int* slot0;
  int* slot1;
  int* ucol;        // [2 * canvas] the listed source columns, ascending
  uint8_t* rgb;     // [2 * rows][2 * canvas][3] the listed pixels' RGB
  uint8_t* out;     // [rows * canvas * 3 + 16] the band's output bytes
};

__host__ __device__ inline size_t fused_smem(uint8_t* base, int canvas, int rows,
                                             FusedSmem* s) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    uint8_t* p = base ? base + at : nullptr;
    at += align16(bytes);
    return p;
  };
  s->meta = (long long*)take(FUSED_META * sizeof(long long));
  s->count = (int*)take(2 * sizeof(int));
  s->ry0 = (int*)take(MAX_BAND * sizeof(int));
  s->ry1 = (int*)take(MAX_BAND * sizeof(int));
  s->wy = (float*)take(MAX_BAND * sizeof(float));
  s->rslot0 = (int*)take(MAX_BAND * sizeof(int));
  s->rslot1 = (int*)take(MAX_BAND * sizeof(int));
  s->urow = (int*)take(2 * MAX_BAND * sizeof(int));
  s->part = (int*)take(THREADS * sizeof(int));
  s->cx0 = (int*)take((size_t)canvas * sizeof(int));
  s->cx1 = (int*)take((size_t)canvas * sizeof(int));
  s->wx = (float*)take((size_t)canvas * sizeof(float));
  s->slot0 = (int*)take((size_t)canvas * sizeof(int));
  s->slot1 = (int*)take((size_t)canvas * sizeof(int));
  s->ucol = (int*)take(2 * (size_t)canvas * sizeof(int));
  s->rgb = take(2 * (size_t)rows * 2 * canvas * 3);
  s->out = take((size_t)rows * canvas * 3 + 16);
  return at;
}

// The output rows of a band: MAX_BAND, halved until the block's shared
// memory fits; 0 where no band fits.
__host__ __device__ inline int fused_band_rows(int canvas) {
  FusedSmem s;
  for (int rows = MAX_BAND; rows >= 1; rows >>= 1)
    if (fused_smem(nullptr, canvas, rows, &s) <= (size_t)SMEM_LIMIT) return rows;
  return 0;
}

// The output rows of a band for n frames on a card of `sms` SMs: at most
// fused_band_rows, halved while the grid would give fewer than two blocks an
// SM (a call of one ImageNet image takes bands of one row: 256 blocks).
__host__ __device__ inline int fused_launch_rows(int canvas, int n, int sms) {
  int rows = fused_band_rows(canvas);
  while (rows > 1 && (long long)n * ((canvas + rows - 1) / rows) < 2LL * sms) rows >>= 1;
  return rows;
}

// upsampled() with shifts for the divisions (hs, vs in {1, 2}); upsampled()
// itself stays as ycc_to_rgb_kernel ran it on the path, so that the pair's
// times compare with the fused kernel's.
__device__ __forceinline__ int chroma_at(const uint8_t* __restrict__ p, int cw, int ch, int hs,
                                         int vs, int y, int x) {
  const int r = y >> (vs - 1), i = x >> (hs - 1);
  if (hs == 1 && vs == 1) return p[(long long)y * cw + x];
  const uint8_t* row = p + (long long)r * cw;
  if (hs == 2 && cw <= 2) return row[i];  // h2v1_upsample / h2v2_upsample
  if (vs == 1) {  // h2v1_fancy_upsample
    const int odd = x & 1;
    const int j = min(max(i + (odd ? 1 : -1), 0), cw - 1);
    return (3 * row[i] + row[j] + (odd ? 2 : 1)) >> 2;
  }
  const int lower = y & 1;
  const uint8_t* row2 = p + (long long)min(max(r + (lower ? 1 : -1), 0), ch - 1) * cw;
  if (hs == 1)  // h1v2_fancy_upsample
    return (3 * row[x] + row2[x] + (lower ? 2 : 1)) >> 2;
  const int odd = x & 1;  // h2v2_fancy_upsample
  const int j = min(max(i + (odd ? 1 : -1), 0), cw - 1);
  const int si = 3 * row[i] + row2[i];
  const int sj = 3 * row[j] + row2[j];
  return (3 * si + sj + (odd ? 7 : 8)) >> 4;
}

// decode.cc's source coordinate of output index o along an axis of n_in
// source pixels at the given scale: the lower neighbour, the upper (clamped
// to the edge) and the lerp weight.
__device__ __forceinline__ void source_axis(int o, int n_in, float scale, int* lo, int* hi,
                                            float* w) {
  float f = __fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), scale), 0.5f);
  if (f < 0.f) f = 0.f;
  int a = (int)f;
  if (a > n_in - 1) a = n_in - 1;
  *lo = a;
  *hi = a + 1 < n_in ? a + 1 : n_in - 1;
  *w = __fsub_rn(f, (float)a);
}

__device__ __forceinline__ uint8_t* fused_smem_base() {
  extern __shared__ __align__(16) uint8_t smem[];
  return smem;
}

// meta [n, 7] int64: the planes' byte offset in src, height, width, chroma
// width, chroma height, horizontal and vertical subsampling (0, 0:
// grayscale). out [n, canvas, canvas, 3] uint8. Block (band, frame): output
// rows [band * rows, + rows) of frame blockIdx.y.
__global__ void __launch_bounds__(THREADS)
    ycc_resize_canvas_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ meta,
                             int canvas, int band_rows, uint8_t* __restrict__ out) {
  FusedSmem s;
  fused_smem(fused_smem_base(), canvas, band_rows, &s);
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int yb = blockIdx.x * band_rows;
  const int rows = min(band_rows, canvas - yb);
  if (tid < FUSED_META) s.meta[tid] = meta[(long long)FUSED_META * img + tid];
  __syncthreads();
  const uint8_t* planes = src + s.meta[0];
  const int sh = (int)s.meta[1], sw = (int)s.meta[2], cw = (int)s.meta[3];
  const int ch = (int)s.meta[4], hs = (int)s.meta[5], vs = (int)s.meta[6];
  const float sy = __fdiv_rn((float)sh, (float)canvas);
  const float sx = __fdiv_rn((float)sw, (float)canvas);

  // 1. coordinates: each output column's and each of the band's rows'
  for (int x = tid; x < canvas; x += THREADS) source_axis(x, sw, sx, &s.cx0[x], &s.cx1[x], &s.wx[x]);
  if (tid < rows) source_axis(yb + tid, sh, sy, &s.ry0[tid], &s.ry1[tid], &s.wy[tid]);
  __syncthreads();

  // 2. the source rows and columns that they touch, listed in order. Along
  // an axis lo and hi never fall, hi <= lo + 1, so walking lo[0], hi[0],
  // lo[1], ... a value is new where it passes the last one listed, hi[o - 1];
  // an old lo is that one or the one before it, an old hi is the last.
  if (tid == 0) {
    int n = 0, last = -1;
    for (int j = 0; j < rows; ++j) {
      const int lo = s.ry0[j], hi = s.ry1[j];
      if (lo > last) s.urow[n++] = lo;
      s.rslot0[j] = lo == s.urow[n - 1] ? n - 1 : n - 2;
      last = max(last, lo);
      if (hi > last) s.urow[n++] = last = hi;
      s.rslot1[j] = n - 1;
    }
    s.count[0] = n;
  }
  const int per = (canvas + THREADS - 1) / THREADS;  // a thread's run of columns
  const int xa = min(tid * per, canvas), xe = min(xa + per, canvas);
  int mine = 0;
  for (int x = xa; x < xe; ++x) {
    const int last = x ? s.cx1[x - 1] : -1;
    mine += (s.cx0[x] > last) + (s.cx1[x] > max(last, s.cx0[x]));
  }
  s.part[tid] = mine;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {  // inclusive prefix sum over the threads
    const int v = tid >= d ? s.part[tid - d] : 0;
    __syncthreads();
    s.part[tid] += v;
    __syncthreads();
  }
  int at = s.part[tid] - mine;
  for (int x = xa; x < xe; ++x) {
    const int last = x ? s.cx1[x - 1] : -1, lo = s.cx0[x], hi = s.cx1[x];
    if (lo > last) {
      s.ucol[at] = lo;
      s.slot0[x] = at++;
    } else {
      s.slot0[x] = lo == last ? at - 1 : at - 2;
    }
    if (hi > max(last, lo)) s.ucol[at++] = hi;
    s.slot1[x] = at - 1;
  }
  if (tid == THREADS - 1) s.count[1] = s.part[THREADS - 1];
  __syncthreads();

  // 3. each listed pixel of each listed row to RGB, once
  const int nrow = s.count[0], ncol = s.count[1], pitch = 2 * canvas * 3;
  const uint8_t* cb_plane = planes + (long long)sh * sw;
  const uint8_t* cr_plane = cb_plane + (long long)ch * cw;
  {
    int r = 0, k = tid;
    while (k >= ncol) k -= ncol, ++r;
    while (r < nrow) {
      const int y = s.urow[r], x = s.ucol[k];
      const int luma = planes[(long long)y * sw + x];
      uint8_t* rgb = s.rgb + r * pitch + 3 * k;
      if (hs == 0) {
        rgb[0] = rgb[1] = rgb[2] = (uint8_t)luma;
      } else {
        const int cb = chroma_at(cb_plane, cw, ch, hs, vs, y, x) - 128;
        const int cr = chroma_at(cr_plane, cw, ch, hs, vs, y, x) - 128;
        rgb[0] = (uint8_t)min(max(luma + ((91881 * cr + 32768) >> 16), 0), 255);
        rgb[1] = (uint8_t)min(max(luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16), 0), 255);
        rgb[2] = (uint8_t)min(max(luma + ((116130 * cb + 32768) >> 16), 0), 255);
      }
      k += THREADS;
      while (k >= ncol) k -= ncol, ++r;
    }
  }
  // the band's bytes in shared memory at the offset of their place in out
  // modulo 16, so that the copy below moves aligned 16-byte words
  uint8_t* dst = out + ((long long)img * canvas + yb) * canvas * 3;
  const int skew = (int)((uintptr_t)dst & 15);
  uint8_t* band = s.out + skew;
  __syncthreads();

  // 4. the band's output pixels, decode.cc's order of operations
  {
    int j = 0, x = tid;
    while (x >= canvas) x -= canvas, ++j;
    while (j < rows) {
      const uint8_t* r0 = s.rgb + s.rslot0[j] * pitch;
      const uint8_t* r1 = s.rgb + s.rslot1[j] * pitch;
      const float wy = s.wy[j], wx = s.wx[x];
      const int c0 = 3 * s.slot0[x], c1 = 3 * s.slot1[x];
      uint8_t* o = band + (j * canvas + x) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int a0 = r0[c0 + c], b0 = r0[c1 + c], a1 = r1[c0 + c], b1 = r1[c1 + c];
        const float t0 = __fadd_rn((float)a0, __fmul_rn(wx, (float)(b0 - a0)));
        const float t1 = __fadd_rn((float)a1, __fmul_rn(wx, (float)(b1 - a1)));
        o[c] = (uint8_t)__fadd_rn(__fadd_rn(t0, __fmul_rn(wy, __fsub_rn(t1, t0))), 0.5f);
      }
      x += THREADS;
      while (x >= canvas) x -= canvas, ++j;
    }
  }
  __syncthreads();

  // 5. the band to out: bytes to the first 16-byte boundary, 16-byte words,
  // the bytes after the last word
  const int nbytes = rows * canvas * 3;
  const int head = min((16 - skew) & 15, nbytes);
  const int words = (nbytes - head) >> 4;
  for (int i = tid; i < head; i += THREADS) dst[i] = band[i];
  for (int i = tid; i < words; i += THREADS)
    reinterpret_cast<uint4*>(dst + head)[i] = reinterpret_cast<const uint4*>(band + head)[i];
  for (int i = head + 16 * words + tid; i < nbytes; i += THREADS) dst[i] = band[i];
}

// two decode states, used in turn, and the event after each one's last image
struct Decoder {
  nvjpegJpegState_t state[2] = {nullptr, nullptr};
  cudaEvent_t done[2] = {nullptr, nullptr};
  int next = 0;
};

// the planes of one image at dst: Y [h][w], then Cb and Cr [ch][cw]
nvjpegImage_t planes(uint8_t* dst, const int* info) {
  const int w = info[2], h = info[3], cw = info[4], ch = info[5];
  nvjpegImage_t image = {};
  image.channel[0] = dst;
  image.pitch[0] = (size_t)w;
  if (info[0] == 3) {
    image.channel[1] = dst + (size_t)h * w;
    image.channel[2] = image.channel[1] + (size_t)ch * cw;
    image.pitch[1] = image.pitch[2] = (size_t)cw;
  }
  return image;
}

}  // namespace

extern "C" {

void vince_jpeg_decoder_free(void* decoder) {
  Decoder* d = static_cast<Decoder*>(decoder);
  if (!d) return;
  for (int k = 0; k < 2; ++k) {
    if (d->state[k]) nvjpegJpegStateDestroy(d->state[k]);
    if (d->done[k]) cudaEventDestroy(d->done[k]);
  }
  delete d;
}

// A decoder for one host thread, on the current device; 0 on success, else
// NVJPEG_ERROR + status or a CUDA error.
int vince_jpeg_decoder_new(void** out) {
  *out = nullptr;
  const int status = init_handle();
  if (status != 0) return status;
  Decoder* d = new Decoder();
  for (int k = 0; k < 2; ++k) {
    const nvjpegStatus_t s = nvjpegJpegStateCreate(g_handle, &d->state[k]);
    const cudaError_t e = cudaEventCreateWithFlags(&d->done[k], cudaEventDisableTiming);
    if (s != NVJPEG_STATUS_SUCCESS || e != cudaSuccess) {
      vince_jpeg_decoder_free(d);
      return s != NVJPEG_STATUS_SUCCESS ? NVJPEG_ERROR + (int)s : (int)e;
    }
  }
  *out = d;
  return 0;
}

// The stream's layout in info[0..7]: components, subsampling
// (nvjpegChromaSubsampling_t), width, height, chroma width, chroma height,
// horizontal and vertical chroma subsampling (0, 0 for grayscale; -1, -1 for
// a layout this path does not take). 0 on success, REFUSED where nvJPEG
// rejects the stream, else NVJPEG_ERROR + status.
int vince_jpeg_info(const uint8_t* data, size_t len, int* info) {
  const int status = init_handle();
  if (status != 0) return status;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  int components = 0;
  nvjpegChromaSubsampling_t subsampling = NVJPEG_CSS_UNKNOWN;
  const nvjpegStatus_t s =
      nvjpegGetImageInfo(g_handle, data, len, &components, &subsampling, widths, heights);
  int hs = -1, vs = -1;
  switch (subsampling) {
    case NVJPEG_CSS_444: hs = 1; vs = 1; break;
    case NVJPEG_CSS_422: hs = 2; vs = 1; break;
    case NVJPEG_CSS_420: hs = 2; vs = 2; break;
    case NVJPEG_CSS_440: hs = 1; vs = 2; break;
    case NVJPEG_CSS_GRAY: hs = 0; vs = 0; break;
    default: break;
  }
  const int fields[8] = {components, (int)subsampling, widths[0], heights[0], widths[1],
                         heights[1], hs, vs};
  for (int k = 0; k < 8; ++k) info[k] = fields[k];
  return outcome(s);
}

// Decode n streams into dst[i] (planar, as planes() lays them out) on
// `stream`; info holds each stream's 8 fields of vince_jpeg_info.
// decoded[i] is set to 1 where the stream was decoded, 0 where nvJPEG
// rejected it. Returns NVJPEG_ERROR + status at the first other nvJPEG
// status, else a CUDA error.
int vince_jpeg_decode(void* decoder, int n, const uint8_t* const* data, const size_t* lens,
                      uint8_t* const* dst, const int* info, int* decoded, void* stream_ptr) {
  Decoder* d = static_cast<Decoder*>(decoder);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int i = 0; i < n; ++i) {
    const int k = d->next;
    d->next ^= 1;
    // the state's last image has left the card (an event never recorded has fired)
    cudaError_t e = cudaEventSynchronize(d->done[k]);
    if (e != cudaSuccess) return (int)e;
    nvjpegImage_t image = planes(dst[i], info + 8 * i);
    const int status = outcome(nvjpegDecode(g_handle, d->state[k], data[i], lens[i],
                                            info[8 * i] == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y,
                                            &image, stream));
    if (status > 0) return status;
    decoded[i] = status == 0;
    e = cudaEventRecord(d->done[k], stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// out: RGB images at the offsets of meta [n, 8] int64 on the device (see
// ycc_to_rgb_kernel) from the planes in src; pixels = the largest h * w.
int vince_ycc_to_rgb(const uint8_t* src, const long long* meta, int n, int pixels, uint8_t* out,
                     void* stream_ptr) {
  if (n <= 0 || n > 65535 || pixels <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((pixels + THREADS - 1) / THREADS, n);
  ycc_to_rgb_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(src, meta, out);
  return (int)cudaGetLastError();
}

// out [n, canvas, canvas, 3] uint8 from the decoded images in src; meta [n, 3]
// int64 on the device: each image's byte offset in src, its height, width.
int vince_resize_bilinear_rgb(const uint8_t* src, const long long* meta, int n, int canvas,
                              uint8_t* out, void* stream_ptr) {
  if (n <= 0 || canvas <= 0) return (int)cudaErrorInvalidValue;
  const int per_image = canvas * canvas * 3;
  const dim3 grid((per_image + THREADS - 1) / THREADS, n);
  resize_bilinear_rgb_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      src, meta, canvas, out);
  return (int)cudaGetLastError();
}


// out [n, canvas, canvas, 3] uint8 from the planes in src; meta [n, 7] int64
// on the device (see ycc_resize_canvas_kernel).
int vince_ycc_resize_canvas(const uint8_t* src, const long long* meta, int n, int canvas,
                            uint8_t* out, void* stream_ptr) {
  if (n <= 0 || n > 65535 || canvas <= 0) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int rows = fused_launch_rows(canvas, n, sms);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  FusedSmem layout;
  const size_t smem = fused_smem(nullptr, canvas, rows, &layout);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        ycc_resize_canvas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((canvas + rows - 1) / rows, n);
  ycc_resize_canvas_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      src, meta, canvas, rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
