// jpeg_decode.cu's C entry points on the host, behind its kernels compiled
// under emulate.h: the kernels' launches emulated, the decode by libjpeg's
// raw_data_out into the planes nvJPEG would write (planar Y, Cb, Cr at the
// stream's own subsampling), the layout in vince_jpeg_info's 8 fields.
#include <jpeglib.h>
#include <setjmp.h>
#include <stdio.h>

extern "C" {

// as the card's entry, on a card of 132 SMs; rows > 0 fixes the band's rows
int vince_ycc_resize_canvas_rows(const uint8_t* src, const long long* meta, int n, int canvas,
                                 int rows, uint8_t* out) {
  if (n <= 0 || n > 65535 || canvas <= 0) return 1;
  if (rows <= 0) rows = fused_launch_rows(canvas, n, 132);
  FusedSmem layout;
  if (rows == 0 || fused_smem(nullptr, canvas, rows, &layout) > sizeof(smem)) return 1;
  launch((canvas + rows - 1) / rows, n, THREADS,
         [&] { ycc_resize_canvas_kernel(src, meta, canvas, rows, out); });
  return 0;
}

int vince_ycc_resize_canvas(const uint8_t* src, const long long* meta, int n, int canvas,
                            uint8_t* out, void* stream) {
  return vince_ycc_resize_canvas_rows(src, meta, n, canvas, 0, out);
}

int vince_ycc_to_rgb(const uint8_t* src, const long long* meta, int n, int pixels, uint8_t* out,
                     void* stream) {
  launch((pixels + THREADS - 1) / THREADS, n, THREADS, [&] { ycc_to_rgb_kernel(src, meta, out); });
  return 0;
}

int vince_resize_bilinear_rgb(const uint8_t* src, const long long* meta, int n, int canvas,
                              uint8_t* out, void* stream) {
  launch((canvas * canvas * 3 + THREADS - 1) / THREADS, n, THREADS,
         [&] { resize_bilinear_rgb_kernel(src, meta, canvas, out); });
  return 0;
}

struct Err {
  jpeg_error_mgr pub;
  jmp_buf jb;
};
static void on_error(j_common_ptr c) { longjmp(((Err*)c->err)->jb, 1); }
static void quiet(j_common_ptr, int) {}

int vince_jpeg_decoder_new(void** out) {
  *out = (void*)new int(0);
  return 0;
}
void vince_jpeg_decoder_free(void* d) { delete (int*)d; }

static void header(jpeg_decompress_struct* c, int* info) {
  const int comps = c->num_components, w = c->image_width, h = c->image_height;
  int hs = -1, vs = -1, cw = 0, ch = 0;
  if (comps == 1) {
    hs = vs = 0;
  } else if (comps == 3) {
    const jpeg_component_info* k = c->comp_info;
    if (k[1].h_samp_factor == 1 && k[1].v_samp_factor == 1 && k[2].h_samp_factor == 1 &&
        k[2].v_samp_factor == 1 && k[0].h_samp_factor <= 2 && k[0].v_samp_factor <= 2) {
      hs = k[0].h_samp_factor;
      vs = k[0].v_samp_factor;
      cw = (w + hs - 1) / hs;
      ch = (h + vs - 1) / vs;
    }
  }
  const int f[8] = {comps, 0, w, h, cw, ch, hs, vs};
  for (int i = 0; i < 8; ++i) info[i] = f[i];
}

int vince_jpeg_info(const uint8_t* data, size_t len, int* info) {
  jpeg_decompress_struct c;
  Err e;
  c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.emit_message = quiet;
  jpeg_create_decompress(&c);
  if (setjmp(e.jb)) {
    jpeg_destroy_decompress(&c);
    return -1;
  }
  jpeg_mem_src(&c, data, len);
  jpeg_read_header(&c, TRUE);
  header(&c, info);
  jpeg_destroy_decompress(&c);
  return 0;
}

static int decode_one(const uint8_t* data, size_t len, uint8_t* dst) {
  jpeg_decompress_struct c;
  Err e;
  c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.emit_message = quiet;
  jpeg_create_decompress(&c);
  if (setjmp(e.jb)) {
    jpeg_destroy_decompress(&c);
    return -1;
  }
  jpeg_mem_src(&c, data, len);
  jpeg_read_header(&c, TRUE);
  int info[8];
  header(&c, info);
  c.raw_data_out = TRUE;
  jpeg_start_decompress(&c);
  const int comps = c.num_components, mv = c.max_v_samp_factor;
  int pw[3] = {info[2], info[4], info[4]}, ph[3] = {info[3], info[5], info[5]};
  uint8_t* base[3] = {dst, dst + (size_t)info[2] * info[3], nullptr};
  base[2] = base[1] + (size_t)info[4] * info[5];
  std::vector<std::vector<uint8_t>> buf(comps);
  std::vector<std::vector<JSAMPROW>> rows(comps);
  JSAMPARRAY arrays[3];
  for (int k = 0; k < comps; ++k) {
    const int width = c.comp_info[k].width_in_blocks * DCTSIZE;
    const int n = c.comp_info[k].v_samp_factor * DCTSIZE;
    buf[k].assign((size_t)width * n, 0);
    for (int r = 0; r < n; ++r) rows[k].push_back(buf[k].data() + (size_t)r * width);
    arrays[k] = rows[k].data();
  }
  for (int imcu = 0; c.output_scanline < c.output_height; ++imcu) {
    jpeg_read_raw_data(&c, arrays, mv * DCTSIZE);
    for (int k = 0; k < comps; ++k) {
      const int n = c.comp_info[k].v_samp_factor * DCTSIZE;
      for (int r = 0; r < n; ++r) {
        const int y = imcu * n + r;
        if (y < ph[k]) memcpy(base[k] + (size_t)y * pw[k], rows[k][r], pw[k]);
      }
    }
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
  return 0;
}

int vince_jpeg_decode(void* decoder, int n, const uint8_t* const* data, const size_t* lens,
                      uint8_t* const* dst, const int* info, int* decoded, void* stream) {
  for (int i = 0; i < n; ++i) decoded[i] = decode_one(data[i], lens[i], dst[i]) == 0;
  return 0;
}

}  // extern "C"
