// JPEG codec for the dpc_tpu_torch frame pipeline on libjpeg (the host
// backend): baseline decode to RGB with DCT-domain M/8 scaling ahead of
// a fixed-point bilinear resize, the pthread batch decode, and a baseline
// 4:2:0 encoder that writes frame trees.  The decode is the arithmetic of
// dpc_tpu/native/jpeg_decoder.cpp, so both packages read a frame to the
// same pixels.
//
// Build: g++ -O3 -shared -fPIC -o libdpcjpeg.so jpeg_libjpeg.cpp -ljpeg -lpthread

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <jpeglib.h>
#include <vector>

#include "jpeg_common.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void quiet(j_common_ptr, int) {}

}  // namespace

extern "C" {

const char* dpc_jpeg_backend() { return "libjpeg"; }

int dpc_jpeg_init() { return 0; }

// Decode the header only: writes (height, width) into dims; returns 0 ok.
int dpc_jpeg_dims(const uint8_t* data, int64_t len, int32_t* dims) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  dims[0] = cinfo.image_height;
  dims[1] = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode one JPEG to RGB and bilinear-resize into out (th x tw x 3);
// th/tw <= 0 means the native size (out sized by dpc_jpeg_dims).  The
// decode uses the smallest DCT-domain M/8 scale that still covers the
// target.  Returns 0 on success.
int dpc_jpeg_decode_resize(const uint8_t* data, int64_t len, uint8_t* out,
                           int32_t th, int32_t tw) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (th > 0 && tw > 0) {
    int m = 8;
    for (int cand = 1; cand <= 8; ++cand) {
      long sh = (static_cast<long>(cinfo.image_height) * cand + 7) / 8;
      long sw = (static_cast<long>(cinfo.image_width) * cand + 7) / 8;
      if (sh >= th && sw >= tw) {
        m = cand;
        break;
      }
    }
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  const int stride = w * cinfo.output_components;
  std::vector<uint8_t> buf(static_cast<size_t>(h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        buf.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  const int comps = cinfo.output_components;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (comps != 3) {  // grayscale: replicate to RGB
    std::vector<uint8_t> rgb(static_cast<size_t>(h) * w * 3);
    for (size_t i = 0; i < static_cast<size_t>(h) * w; ++i)
      rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = buf[i];
    buf.swap(rgb);
  }
  if (th <= 0 || tw <= 0) {
    memcpy(out, buf.data(), static_cast<size_t>(h) * w * 3);
    return 0;
  }
  dpc_jpeg::bilinear_rgb(buf.data(), h, w, out, th, tw);
  return 0;
}

int dpc_jpeg_decode_batch(const uint8_t* const* datas, const int64_t* lens,
                          int n, uint8_t* out, int32_t th, int32_t tw,
                          int threads) {
  return dpc_jpeg::decode_batch(dpc_jpeg_decode_resize, datas, lens, n, out,
                                th, tw, threads);
}

// Encode RGB uint8 [h, w, 3] as a baseline 4:2:0 JPEG at `quality` into
// out (capacity cap).  Returns the byte count, or -1 on failure or when
// the stream does not fit.
int64_t dpc_jpeg_encode(const uint8_t* rgb, int32_t h, int32_t w,
                        int32_t quality, uint8_t* out, int64_t cap) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int64_t n = static_cast<int64_t>(mem_len);
  if (n > cap) n = -1;
  else memcpy(out, mem, mem_len);
  free(mem);
  return n;
}

}  // extern "C"
