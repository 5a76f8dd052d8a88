// JPEG codec for the dpc_tpu_torch frame pipeline on nvJPEG, for machines
// whose CUDA toolkit ships nvJPEG but which have no libjpeg headers.  The
// C ABI is jpeg_libjpeg.cpp's (see jpeg_common.h): the entropy decode runs
// on the host (NVJPEG_BACKEND_HYBRID), the IDCT and colour conversion on
// the GPU, and every decode is copied back to host memory, so the dataset
// code above it has one path.  The encoder writes baseline 4:2:0 JPEGs.
// Pixels may differ from libjpeg's by the rounding of the IDCT and the
// chroma upsampling.  nvJPEG has no DCT-domain scaling, so the
// scale-and-crop decode decodes the whole frame and copies back only what
// the crop needs: at scale 1 the crop itself (a strided 2-D copy), else
// the source span feeding it, which the shared 16.16 bilinear_rgb_roi
// resamples from the full-size frame (libjpeg resamples from its DCT-scaled
// frame, so at a scale other than 1 the two backends' pixels differ by the
// resampling too).  The batched decodes split the frames over
// jpeg_common.h's pthread pool, one nvJPEG state a thread.
//
// Build: g++ -O3 -shared -fPIC -o libdpcjpeg.so jpeg_nvjpeg.cpp
//   -I$CUDA_HOME/include -L$CUDA_HOME/lib64 -lnvjpeg -lcudart_static
//   -lpthread -ldl -lrt

#include <cuda_runtime_api.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include "jpeg_common.h"

namespace {

// One per concurrent caller: nvJPEG's decode and encode states are not
// thread-safe, the library handle is.
struct Ctx {
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dbuf = nullptr;
  size_t dcap = 0;
};

nvjpegHandle_t g_handle = nullptr;
int g_init_status = -1;
std::once_flag g_once;
std::mutex g_pool_mu;
std::vector<Ctx*> g_pool;

void init_once() {
  nvjpegStatus_t st =
      nvjpegCreateEx(NVJPEG_BACKEND_HYBRID, nullptr, nullptr, 0, &g_handle);
  g_init_status = static_cast<int>(st);
}

Ctx* acquire() {
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (!g_pool.empty()) {
      Ctx* c = g_pool.back();
      g_pool.pop_back();
      return c;
    }
  }
  Ctx* c = new Ctx();
  if (cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      nvjpegJpegStateCreate(g_handle, &c->state) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderStateCreate(g_handle, &c->enc, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsCreate(g_handle, &c->params, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(c->params, NVJPEG_CSS_420,
                                            c->stream) !=
          NVJPEG_STATUS_SUCCESS) {
    return nullptr;  // leaks the partial context; the caller reports
  }
  return c;
}

void release(Ctx* c) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  g_pool.push_back(c);
}

bool reserve(Ctx* c, size_t bytes) {
  if (c->dcap >= bytes) return true;
  if (c->dbuf) cudaFree(c->dbuf);
  c->dbuf = nullptr;
  c->dcap = 0;
  if (cudaMalloc(reinterpret_cast<void**>(&c->dbuf), bytes) != cudaSuccess)
    return false;
  c->dcap = bytes;
  return true;
}

int image_dims(const uint8_t* data, int64_t len, int* h, int* w) {
  int nc = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(g_handle, data, static_cast<size_t>(len), &nc, &ss,
                         widths, heights) != NVJPEG_STATUS_SUCCESS)
    return 1;
  *h = heights[0];
  *w = widths[0];
  return (*h > 0 && *w > 0) ? 0 : 1;
}

}  // namespace

extern "C" {

const char* dpc_jpeg_backend() { return "nvjpeg"; }

// 0 when the nvJPEG handle exists, else nvJPEG's status code.
int dpc_jpeg_init() {
  std::call_once(g_once, init_once);
  return g_init_status;
}

int dpc_jpeg_dims(const uint8_t* data, int64_t len, int32_t* dims) {
  if (dpc_jpeg_init() != 0) return 1;
  int h, w;
  if (image_dims(data, len, &h, &w) != 0) return 1;
  dims[0] = h;
  dims[1] = w;
  return 0;
}

// Decode to RGB on the GPU, copy to host, then resize on the host when
// th/tw > 0.  Returns 0 on success.
int dpc_jpeg_decode_resize(const uint8_t* data, int64_t len, uint8_t* out,
                           int32_t th, int32_t tw) {
  if (dpc_jpeg_init() != 0) return 1;
  int h, w;
  if (image_dims(data, len, &h, &w) != 0) return 1;
  Ctx* c = acquire();
  if (c == nullptr) return 1;
  const size_t bytes = static_cast<size_t>(h) * w * 3;
  int rc = 1;
  if (reserve(c, bytes)) {
    nvjpegImage_t img;
    memset(&img, 0, sizeof(img));
    img.channel[0] = c->dbuf;
    img.pitch[0] = static_cast<unsigned int>(w) * 3;
    const bool native = th <= 0 || tw <= 0 || (th == h && tw == w);
    std::vector<uint8_t> host(native ? 0 : bytes);
    uint8_t* dst = native ? out : host.data();
    if (nvjpegDecode(g_handle, c->state, data, static_cast<size_t>(len),
                     NVJPEG_OUTPUT_RGBI, &img, c->stream) ==
            NVJPEG_STATUS_SUCCESS &&
        cudaMemcpyAsync(dst, c->dbuf, bytes, cudaMemcpyDeviceToHost,
                        c->stream) == cudaSuccess &&
        cudaStreamSynchronize(c->stream) == cudaSuccess) {
      if (!native) dpc_jpeg::bilinear_rgb(host.data(), h, w, out, th, tw);
      rc = 0;
    }
  }
  release(c);
  return rc;
}

int dpc_jpeg_decode_batch(const uint8_t* const* datas, const int64_t* lens,
                          int n, uint8_t* out, int32_t th, int32_t tw,
                          int threads) {
  return dpc_jpeg::decode_batch(dpc_jpeg_decode_resize, datas, lens, n, out,
                                th, tw, threads);
}

// Decode fused with the short-side scale and the crop (jpeg_common.h).
// Returns 0 ok, 1 corrupt, 2 crop outside the scaled image.
int dpc_jpeg_decode_scale_crop(const uint8_t* data, int64_t len,
                               uint8_t* out, int32_t short_side, int32_t cy,
                               int32_t cx, int32_t ch, int32_t cw) {
  if (dpc_jpeg_init() != 0) return 1;
  int h, w;
  if (image_dims(data, len, &h, &w) != 0) return 1;
  int oh, ow;
  dpc_jpeg::shortside_dims(h, w, short_side, &oh, &ow);
  if (cy < 0 || cx < 0 || ch < 1 || cw < 1 || cy + ch > oh ||
      cx + cw > ow)
    return 2;
  Ctx* c = acquire();
  if (c == nullptr) return 1;
  int rc = 1;
  if (reserve(c, static_cast<size_t>(h) * w * 3)) {
    nvjpegImage_t img;
    memset(&img, 0, sizeof(img));
    img.channel[0] = c->dbuf;
    img.pitch[0] = static_cast<unsigned int>(w) * 3;
    int y_lo, y_hi, x_lo, x_hi;
    dpc_jpeg::roi_span(h, w, oh, ow, cy, cx, ch, cw, &y_lo, &y_hi, &x_lo,
                       &x_hi);
    const bool pure = oh == h && ow == w;  // the span is the crop itself
    const int rw = x_hi - x_lo + 1, rh = y_hi - y_lo + 1;
    std::vector<uint8_t> host(pure ? 0 : static_cast<size_t>(rh) * rw * 3);
    uint8_t* dst = pure ? out : host.data();
    const uint8_t* src =
        c->dbuf + (static_cast<size_t>(y_lo) * w + x_lo) * 3;
    if (nvjpegDecode(g_handle, c->state, data, static_cast<size_t>(len),
                     NVJPEG_OUTPUT_RGBI, &img, c->stream) ==
            NVJPEG_STATUS_SUCCESS &&
        cudaMemcpy2DAsync(dst, static_cast<size_t>(rw) * 3, src,
                          static_cast<size_t>(w) * 3,
                          static_cast<size_t>(rw) * 3, rh,
                          cudaMemcpyDeviceToHost, c->stream) == cudaSuccess &&
        cudaStreamSynchronize(c->stream) == cudaSuccess) {
      if (!pure)
        dpc_jpeg::bilinear_rgb_roi(host.data(), h, w, y_lo, x_lo, rh, rw,
                                   out, oh, ow, cy, cx, ch, cw);
      rc = 0;
    }
  }
  release(c);
  return rc;
}

int dpc_jpeg_decode_batch_scale_crop(const uint8_t* const* datas,
                                     const int64_t* lens, int n, uint8_t* out,
                                     int32_t short_side, int32_t cy,
                                     int32_t cx, int32_t ch, int32_t cw,
                                     int threads) {
  return dpc_jpeg::decode_batch_scale_crop(dpc_jpeg_decode_scale_crop, datas,
                                           lens, n, out, short_side, cy, cx,
                                           ch, cw, threads);
}

// Encode RGB uint8 [h, w, 3] as a baseline 4:2:0 JPEG at `quality` into
// out (capacity cap).  Returns the byte count, or -1 on failure or when
// the stream does not fit.
int64_t dpc_jpeg_encode(const uint8_t* rgb, int32_t h, int32_t w,
                        int32_t quality, uint8_t* out, int64_t cap) {
  if (dpc_jpeg_init() != 0) return -1;
  Ctx* c = acquire();
  if (c == nullptr) return -1;
  const size_t bytes = static_cast<size_t>(h) * w * 3;
  int64_t rc = -1;
  size_t length = 0;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  if (reserve(c, bytes) &&
      cudaMemcpyAsync(c->dbuf, rgb, bytes, cudaMemcpyHostToDevice,
                      c->stream) == cudaSuccess &&
      nvjpegEncoderParamsSetQuality(c->params, quality, c->stream) ==
          NVJPEG_STATUS_SUCCESS) {
    img.channel[0] = c->dbuf;
    img.pitch[0] = static_cast<unsigned int>(w) * 3;
    if (nvjpegEncodeImage(g_handle, c->enc, c->params, &img,
                          NVJPEG_INPUT_RGBI, w, h, c->stream) ==
            NVJPEG_STATUS_SUCCESS &&
        nvjpegEncodeRetrieveBitstream(g_handle, c->enc, nullptr, &length,
                                      c->stream) == NVJPEG_STATUS_SUCCESS &&
        cudaStreamSynchronize(c->stream) == cudaSuccess &&
        static_cast<int64_t>(length) <= cap &&
        nvjpegEncodeRetrieveBitstream(g_handle, c->enc, out, &length,
                                      c->stream) == NVJPEG_STATUS_SUCCESS &&
        cudaStreamSynchronize(c->stream) == cudaSuccess) {
      rc = static_cast<int64_t>(length);
    }
  }
  release(c);
  return rc;
}

}  // extern "C"
