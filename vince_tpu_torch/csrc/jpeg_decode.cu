// JPEG decode on the card (nvJPEG) and two hand-written kernels: libjpeg's
// chroma upsampling and YCbCr -> RGB conversion, and a bilinear resize to the
// square canvas. CUDA C++ for sm_90a.
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
// ycc_to_rgb_kernel. libjpeg's (and so cv2's) "fancy" chroma upsampling
// (jdsample.c: h2v1, h1v2 and h2v2 triangular filters with their rounding
// biases, the edges replicated, box replication for planes of width <= 2) and
// its fixed-point YCbCr -> RGB conversion (jdcolor.c, 16-bit fractions, the
// same rounding), in integers: it gives libjpeg's pixels from libjpeg's
// planes. nvJPEG's own RGB output upsamples chroma otherwise (4:2:0 frames came
// out up to 12 levels from cv2's at the 99th percentile on the H100).
//
// resize_bilinear_rgb_kernel. decode.cc's formula: cv2.INTER_LINEAR with
// half-pixel centres, src = (dst + 0.5) * (in / out) - 0.5 clamped at 0, the
// upper neighbour clamped to the edge, a horizontal lerp of each of the two
// source rows, a vertical lerp of those, + 0.5 and truncation to uint8. Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), in decode.cc's order, so the kernel gives the plain PyTorch
// version's bits.
//
// What bounds both kernels on the H100: bytes. Each reads a few neighbouring
// bytes and writes one pixel or one byte with a handful of integer or float
// operations; the least traffic is each input read once and each output
// written once. One thread per output pixel (ycc_to_rgb) or output byte
// (resize) along the rows, so a warp's stores are neighbouring and its reads
// short runs of one or two rows; the batch's images are the grid's y
// dimension. Simple kernels: the decode, not they, takes the time of a batch.

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

}  // extern "C"
