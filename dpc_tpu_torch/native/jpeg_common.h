// Shared by the two JPEG codec backends of dpc_tpu_torch (jpeg_libjpeg.cpp
// and jpeg_nvjpeg.cpp): the fixed-point bilinear resample that finishes a
// resized decode, and the pthread pool of the batched decode.  Both
// backends export the same C ABI:
//
//   const char* dpc_jpeg_backend();
//   int dpc_jpeg_init();                                    // 0: ready
//   int dpc_jpeg_dims(data, len, int32 dims[2]);            // (h, w)
//   int dpc_jpeg_decode_resize(data, len, out, th, tw);     // th/tw <= 0: native
//   int dpc_jpeg_decode_batch(datas, lens, n, out, th, tw, threads);
//   int64 dpc_jpeg_encode(rgb, h, w, quality, out, cap);    // bytes written
//
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

typedef int (*DecodeFn)(const uint8_t*, int64_t, uint8_t*, int32_t,
                        int32_t);

struct BatchJob {
  DecodeFn decode;
  const uint8_t* const* datas;
  const int64_t* lens;
  uint8_t* out;  // contiguous [n, th, tw, 3]
  int32_t th, tw;
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
    int rc = job->decode(job->datas[i], job->lens[i],
                         job->out + frame_bytes * i, job->th, job->tw);
    if (rc != 0) {
      pthread_mutex_lock(&job->mu);
      job->failures++;
      pthread_mutex_unlock(&job->mu);
      memset(job->out + frame_bytes * i, 0, frame_bytes);
    }
  }
  return nullptr;
}

// Decode n JPEGs into out[n, th, tw, 3] with `threads` workers; returns
// the number of failed decodes (failed frames are zeroed).
inline int decode_batch(DecodeFn decode, const uint8_t* const* datas,
                        const int64_t* lens, int n, uint8_t* out,
                        int32_t th, int32_t tw, int threads) {
  if (threads > n) threads = n;
  if (threads < 1) threads = 1;
  BatchJob job{decode, datas, lens, out, th, tw, n, 0, 0,
               PTHREAD_MUTEX_INITIALIZER};
  std::vector<pthread_t> tids(threads);
  for (int t = 0; t < threads; ++t)
    pthread_create(&tids[t], nullptr, batch_worker, &job);
  for (int t = 0; t < threads; ++t) pthread_join(tids[t], nullptr);
  return job.failures;
}

}  // namespace dpc_jpeg
