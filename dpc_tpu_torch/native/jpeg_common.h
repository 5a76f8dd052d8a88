// Shared by the two JPEG codec backends of dpc_tpu_torch (jpeg_libjpeg.cpp
// and jpeg_nvjpeg.cpp): the fixed-point bilinear resamples that finish a
// resized or scaled-and-cropped decode, the short-side geometry, and the
// pthread pool of the batched decodes.  Both backends export the same C
// ABI:
//
//   const char* dpc_jpeg_backend();                        // the library
//   int dpc_jpeg_init();                                    // 0: ready
//   int dpc_jpeg_dims(data, len, int32 dims[2]);            // (h, w)
//   int dpc_jpeg_decode_resize(data, len, out, th, tw);     // th/tw <= 0: native
//   int dpc_jpeg_decode_batch(datas, lens, n, out, th, tw, threads);
//   int dpc_jpeg_decode_scale_crop(data, len, out, short_side, cy, cx, ch, cw);
//       // 0 ok, 1 corrupt, 2 crop outside the scaled image
//   int dpc_jpeg_decode_batch_scale_crop(datas, lens, n, out, short_side,
//                                        cy, cx, ch, cw, threads);
//   int64 dpc_jpeg_encode(rgb, h, w, quality, out, cap);    // bytes written
//
// The scale-and-crop decode is the host half of --device_augment: scale so
// that min(h, w) == short_side (data/augment.py's shortside_dims), then
// keep rows [cy, cy+ch) x cols [cx, cx+cw) of the scaled image.
// Decodes land in host memory as RGB uint8 [h, w, 3].
#pragma once

#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <vector>

namespace dpc_jpeg {

// Bilinear resample (fixed-point 16.16) from src (h,w,3) to dst (th,tw,3);
// the same grid and rounding as dpc_tpu/native/jpeg_decoder.cpp.
inline void bilinear_rgb(const uint8_t* src, int h, int w, uint8_t* dst,
                         int th, int tw) {
  if (h == th && w == tw) {
    memcpy(dst, src, static_cast<size_t>(h) * w * 3);
    return;
  }
  const int64_t x_step = ((int64_t)w << 16) / tw;
  const int64_t y_step = ((int64_t)h << 16) / th;
  std::vector<int> x0s(tw), x1s(tw), wxs(tw);
  for (int x = 0; x < tw; ++x) {
    int64_t fx = x * x_step + (x_step >> 1) - (1 << 15);
    if (fx < 0) fx = 0;
    int xi = static_cast<int>(fx >> 16);
    x0s[x] = xi < w - 1 ? xi : w - 1;
    x1s[x] = xi + 1 < w ? xi + 1 : w - 1;
    wxs[x] = static_cast<int>(fx & 0xffff);
  }
  for (int y = 0; y < th; ++y) {
    int64_t fy = y * y_step + (y_step >> 1) - (1 << 15);
    if (fy < 0) fy = 0;
    int yi = static_cast<int>(fy >> 16);
    int y0 = yi < h - 1 ? yi : h - 1;
    int y1 = yi + 1 < h ? yi + 1 : h - 1;
    int wy = static_cast<int>(fy & 0xffff);
    const uint8_t* r0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * w * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * tw * 3;
    for (int x = 0; x < tw; ++x) {
      const int x0 = x0s[x] * 3, x1 = x1s[x] * 3, wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        int top = r0[x0 + c] + (((r0[x1 + c] - r0[x0 + c]) * wx) >> 16);
        int bot = r1[x0 + c] + (((r1[x1 + c] - r1[x0 + c]) * wx) >> 16);
        out[x * 3 + c] =
            static_cast<uint8_t>(top + (((bot - top) * wy) >> 16));
      }
    }
  }
}

// Bilinear resample from a ROI of a virtual (sh, sw) image to the crop
// [cy:cy+ch, cx:cx+cw] of the virtual (oh, ow) output.  `src` holds rows
// [roi_y0, roi_y0+roi_h) x cols [roi_x0, roi_x0+roi_w) of the source; the
// grid is bilinear_rgb's, so a cropped decode gives the same pixels as
// crop-after-resize (dpc_tpu/native/jpeg_decoder.cpp's bilinear_rgb_roi).
inline void bilinear_rgb_roi(const uint8_t* src, int sh, int sw, int roi_y0,
                             int roi_x0, int roi_h, int roi_w, uint8_t* dst,
                             int oh, int ow, int cy, int cx, int ch,
                             int cw) {
  (void)roi_h;
  const int64_t x_step = ((int64_t)sw << 16) / ow;
  const int64_t y_step = ((int64_t)sh << 16) / oh;
  std::vector<int> x0s(cw), x1s(cw), wxs(cw);
  for (int x = 0; x < cw; ++x) {
    int64_t fx = (int64_t)(cx + x) * x_step + (x_step >> 1) - (1 << 15);
    if (fx < 0) fx = 0;
    int xi = static_cast<int>(fx >> 16);
    int x0 = xi < sw - 1 ? xi : sw - 1;
    int x1 = xi + 1 < sw ? xi + 1 : sw - 1;
    x0s[x] = (x0 - roi_x0) * 3;
    x1s[x] = (x1 - roi_x0) * 3;
    wxs[x] = static_cast<int>(fx & 0xffff);
  }
  for (int y = 0; y < ch; ++y) {
    int64_t fy = (int64_t)(cy + y) * y_step + (y_step >> 1) - (1 << 15);
    if (fy < 0) fy = 0;
    int yi = static_cast<int>(fy >> 16);
    int y0 = yi < sh - 1 ? yi : sh - 1;
    int y1 = yi + 1 < sh ? yi + 1 : sh - 1;
    int wy = static_cast<int>(fy & 0xffff);
    const uint8_t* r0 = src + static_cast<size_t>(y0 - roi_y0) * roi_w * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1 - roi_y0) * roi_w * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * cw * 3;
    for (int x = 0; x < cw; ++x) {
      const int x0 = x0s[x], x1 = x1s[x], wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        int top = r0[x0 + c] + (((r0[x1 + c] - r0[x0 + c]) * wx) >> 16);
        int bot = r1[x0 + c] + (((r1[x1 + c] - r1[x0 + c]) * wx) >> 16);
        out[x * 3 + c] =
            static_cast<uint8_t>(top + (((bot - top) * wy) >> 16));
      }
    }
  }
}

// Short-side output dims, data/augment.py's shortside_dims (int() rule).
inline void shortside_dims(int h, int w, int s, int* oh, int* ow) {
  if ((w <= h && w == s) || (h <= w && h == s)) {
    *oh = h;
    *ow = w;
  } else if (w < h) {
    *ow = s;
    *oh = static_cast<int>((double)s * h / w);
  } else {
    *oh = s;
    *ow = static_cast<int>((double)s * w / h);
  }
}

// The rows [y_lo, y_hi] and cols [x_lo, x_hi] of a (sh, sw) source that
// bilinear_rgb_roi reads for the crop of the (oh, ow) output.
inline void roi_span(int sh, int sw, int oh, int ow, int cy, int cx, int ch,
                     int cw, int* y_lo, int* y_hi, int* x_lo, int* x_hi) {
  if (sh == oh && sw == ow) {
    *x_lo = cx;
    *x_hi = cx + cw - 1;
    *y_lo = cy;
    *y_hi = cy + ch - 1;
    return;
  }
  const int64_t x_step = ((int64_t)sw << 16) / ow;
  const int64_t y_step = ((int64_t)sh << 16) / oh;
  int64_t fx0 = (int64_t)cx * x_step + (x_step >> 1) - (1 << 15);
  int64_t fx1 = (int64_t)(cx + cw - 1) * x_step + (x_step >> 1) - (1 << 15);
  int64_t fy0 = (int64_t)cy * y_step + (y_step >> 1) - (1 << 15);
  int64_t fy1 = (int64_t)(cy + ch - 1) * y_step + (y_step >> 1) - (1 << 15);
  if (fx0 < 0) fx0 = 0;
  if (fy0 < 0) fy0 = 0;
  if (fx1 < 0) fx1 = 0;
  if (fy1 < 0) fy1 = 0;
  *x_lo = static_cast<int>(fx0 >> 16);
  *y_lo = static_cast<int>(fy0 >> 16);
  *x_hi = static_cast<int>(fx1 >> 16) + 1;
  *y_hi = static_cast<int>(fy1 >> 16) + 1;
  if (*x_lo > sw - 1) *x_lo = sw - 1;
  if (*y_lo > sh - 1) *y_lo = sh - 1;
  if (*x_hi > sw - 1) *x_hi = sw - 1;
  if (*y_hi > sh - 1) *y_hi = sh - 1;
}

typedef int (*DecodeFn)(const uint8_t*, int64_t, uint8_t*, int32_t,
                        int32_t);
typedef int (*ScaleCropFn)(const uint8_t*, int64_t, uint8_t*, int32_t,
                           int32_t, int32_t, int32_t, int32_t);

struct BatchJob {
  DecodeFn decode;           // resize mode, or
  ScaleCropFn scale_crop;    // scale-and-crop mode when set
  const uint8_t* const* datas;
  const int64_t* lens;
  uint8_t* out;  // contiguous [n, th, tw, 3]
  int32_t th, tw;
  int32_t short_side, cy, cx;
  int n;
  int next;  // shared cursor
  int failures;
  pthread_mutex_t mu;
};

inline void* batch_worker(void* arg) {
  BatchJob* job = static_cast<BatchJob*>(arg);
  const size_t frame_bytes = static_cast<size_t>(job->th) * job->tw * 3;
  for (;;) {
    pthread_mutex_lock(&job->mu);
    int i = job->next++;
    pthread_mutex_unlock(&job->mu);
    if (i >= job->n) break;
    uint8_t* out = job->out + frame_bytes * i;
    int rc = job->scale_crop != nullptr
                 ? job->scale_crop(job->datas[i], job->lens[i], out,
                                   job->short_side, job->cy, job->cx,
                                   job->th, job->tw)
                 : job->decode(job->datas[i], job->lens[i], out, job->th,
                               job->tw);
    if (rc != 0) {
      pthread_mutex_lock(&job->mu);
      job->failures++;
      pthread_mutex_unlock(&job->mu);
      memset(job->out + frame_bytes * i, 0, frame_bytes);
    }
  }
  return nullptr;
}

inline int run_batch(BatchJob* job, int threads) {
  if (threads > job->n) threads = job->n;
  if (threads < 1) threads = 1;
  std::vector<pthread_t> tids(threads);
  for (int t = 0; t < threads; ++t)
    pthread_create(&tids[t], nullptr, batch_worker, job);
  for (int t = 0; t < threads; ++t) pthread_join(tids[t], nullptr);
  return job->failures;
}

// Decode n JPEGs into out[n, th, tw, 3] with `threads` workers; returns
// the number of failed decodes (failed frames are zeroed).
inline int decode_batch(DecodeFn decode, const uint8_t* const* datas,
                        const int64_t* lens, int n, uint8_t* out,
                        int32_t th, int32_t tw, int threads) {
  BatchJob job{decode, nullptr, datas, lens, out, th, tw, -1, 0, 0, n, 0, 0,
               PTHREAD_MUTEX_INITIALIZER};
  return run_batch(&job, threads);
}

// Scale-and-crop decode of n JPEGs sharing one window (the consistent
// augmentation contract) into out[n, ch, cw, 3]; a frame whose window
// falls outside its scaled image counts as failed.
inline int decode_batch_scale_crop(ScaleCropFn fn, const uint8_t* const* datas,
                                   const int64_t* lens, int n, uint8_t* out,
                                   int32_t short_side, int32_t cy, int32_t cx,
                                   int32_t ch, int32_t cw, int threads) {
  BatchJob job{nullptr, fn, datas, lens, out, ch, cw, short_side, cy, cx, n,
               0, 0, PTHREAD_MUTEX_INITIALIZER};
  return run_batch(&job, threads);
}

}  // namespace dpc_jpeg
