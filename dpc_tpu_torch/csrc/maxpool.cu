// The stem's ReLU + 3x3/s2/p1 max-pool for Hopper: K1 (forward), K2
// (backward by the forward's codes) and K8 (equality-routed backward).
//
// Replaces dpc_tpu/ops/maxpool_pallas.py: `_fwd_kernel` (pallas_call at
// :163), `_bwd_kernel` (:208) and `_bwd_eq_kernel` (:303).  The pool is the
// reference's only one (backbone/resnet_2d3d.py:214): kernel (1,3,3),
// stride (1,2,2), padding (0,1,1), over (H, W) of a channels-last
// activation viewed as z [M, H, W, C] (M = N*T, H and W even), giving
// [M, H/2, W/2, C].  Input row m of window o is m = 2*o + d - 1.
//
// What bounds them on this card: bytes.  Each does a handful of compares or
// adds per element, so one pass over device memory at 3.35 TB/s is the
// floor.  At the pretrain flagship the stem activation is
// [2560, 64, 64, 64] bf16 = 1.34 GB, its pooled output 0.34 GB and the
// uint8 code 0.17 GB:
//   K1: (1.34 + 0.34 + 0.17) GB / 3.35 TB/s ~ 0.55 ms
//   K2: (0.34 + 0.17 + 1.34) GB / 3.35 TB/s ~ 0.55 ms
//   K8: reads src and g, writes dz: (1.34 + 0.34 + 1.34) GB ~ 0.90 ms in
//       bf16; twice the bytes, ~1.80 ms, in f32.
// At the LC flagship (M = 32*8*5 = 1280) each figure is half.
//
// Design:
//  * K1: a thread owns one output cell and one 16-byte vector of channels
//    (8 bf16 or 4 f32).  It reads the <= 9 input vectors of its window;
//    neighbouring threads read neighbouring channels, so a warp's loads are
//    contiguous.  It compares in f32: the first strict > wins in window
//    order k = 3*dh + dw (ATen's first-max order), padding never wins.  It
//    writes relu(max) in the input type and a uint8 code per channel: the
//    winning k, or 9 when the max is <= 0 and the ReLU kills the gradient.
//    The TPU wrote an int32 code; the meaning is the same, at a quarter of
//    the bytes.
//  * K2: a thread owns the 2x2 block of input positions (2*o_h + {0,1},
//    2*o_w + {0,1}) for one channel vector and gathers from the <= 2x2
//    windows that cover them: an even row is covered at o = m/2 (d = 1), an
//    odd row at o = (m-1)/2 (d = 2) and o = (m+1)/2 (d = 0), and the same
//    for columns.  It accumulates in f32, rounds once and writes dz at input
//    resolution: no parity quadrants, no interleave pass, no atomics.
//  * K8: a block owns an 8x8 tile of window centres and 32 channels.  It
//    first computes each window's max (the stride-1 3x3 max M3 of src,
//    needed only at the even centres) and its gradient for the tile and a
//    one-window halo into shared memory, then every input position of the
//    tile adds the gradient of each covering window whose max it equals, in
//    the TPU kernel's shift order.  g is read in its compact
//    [M, H/2, W/2, C] form; nothing is interior-padded in device memory.
//  * A ragged M, H/2 or W/2 is masked in the kernels; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

// One 16-byte vector of channels, stored as raw words of the element type.
struct F32 {
  using word = float;
  static constexpr int VEC = 4;
  __device__ static float get(word w) { return w; }
  __device__ static word put(float f) { return f; }
};

struct BF16 {
  using word = unsigned short;
  static constexpr int VEC = 8;
  __device__ static float get(word w) { return __uint_as_float((unsigned)w << 16); }
  __device__ static word put(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
};

template <class T>
__device__ __forceinline__ void load_vec(const typename T::word* p, float v[T::VEC]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  typename T::word w[T::VEC];
  memcpy(w, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < T::VEC; ++e) v[e] = T::get(w[e]);
}

template <class T>
__device__ __forceinline__ void store_vec(typename T::word* p, const float v[T::VEC]) {
  typename T::word w[T::VEC];
#pragma unroll
  for (int e = 0; e < T::VEC; ++e) w[e] = T::put(v[e]);
  uint4 raw;
  memcpy(&raw, w, sizeof(raw));
  *reinterpret_cast<uint4*>(p) = raw;
}

// VEC uint8 codes as one 8- or 4-byte word.
template <int VEC>
struct CodeWord;
template <>
struct CodeWord<8> {
  using type = uint2;
};
template <>
struct CodeWord<4> {
  using type = unsigned;
};

constexpr int NT = 256;  // threads per block of K1 and K2

// max(a, b) that returns NaN when either is NaN (fmaxf returns the other)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <class T>
__global__ void __launch_bounds__(NT) pool_fwd_kernel(const typename T::word* __restrict__ z,
                                                      typename T::word* __restrict__ out,
                                                      unsigned char* __restrict__ code,
                                                      long long cells, int H, int W, int C) {
  constexpr int VEC = T::VEC;
  const int Ho = H / 2, Wo = W / 2, CV = C / VEC;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < cells;
       i += (long long)gridDim.x * NT) {
    const int cv = (int)(i % CV);
    long long r = i / CV;
    const int ow = (int)(r % Wo);
    r /= Wo;
    const int oh = (int)(r % Ho);
    const long long m = r / Ho;
    float best[VEC];
    unsigned char idx[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      best[e] = -INFINITY;
      idx[e] = 0;
    }
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int h = 2 * oh + dh - 1;  // never >= H: H is even
      if (h < 0) continue;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int w = 2 * ow + dw - 1;
        if (w < 0) continue;
        float v[VEC];
        load_vec<T>(z + ((m * H + h) * W + w) * C + cv * VEC, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (v[e] > best[e]) idx[e] = (unsigned char)(3 * dh + dw);
          best[e] = max_nan(best[e], v[e]);
        }
      }
    }
    // the TPU kernel's algorithm: a window that holds a NaN gives NaN and
    // keeps the code of its last max before the first NaN
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      o[e] = (best[e] > 0.f || best[e] != best[e]) ? best[e] : 0.f;
      if (best[e] <= 0.f) idx[e] = 9;
    }
    store_vec<T>(out + i * VEC, o);
    typename CodeWord<VEC>::type cw;
    memcpy(&cw, idx, sizeof(cw));
    *reinterpret_cast<typename CodeWord<VEC>::type*>(code + i * VEC) = cw;
  }
}

template <class T>
__global__ void __launch_bounds__(NT) pool_bwd_kernel(const typename T::word* __restrict__ dout,
                                                      const unsigned char* __restrict__ code,
                                                      typename T::word* __restrict__ dz,
                                                      long long cells, int H, int W, int C) {
  constexpr int VEC = T::VEC;
  using CW = typename CodeWord<VEC>::type;
  const int Ho = H / 2, Wo = W / 2, CV = C / VEC;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < cells;
       i += (long long)gridDim.x * NT) {
    const int cv = (int)(i % CV);
    long long r = i / CV;
    const int ow = (int)(r % Wo);
    r /= Wo;
    const int oh = (int)(r % Ho);
    const long long m = r / Ho;
    // the four windows (oh + a, ow + b) that cover the 2x2 input block
    float g[2][2][VEC];
    unsigned char k[2][2][VEC];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (oh + a < Ho && ow + b < Wo) {
          const long long o = ((m * Ho + oh + a) * Wo + ow + b) * C + cv * VEC;
          load_vec<T>(dout + o, g[a][b]);
          const CW cw = __ldg(reinterpret_cast<const CW*>(code + o));
          memcpy(k[a][b], &cw, sizeof(cw));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            g[a][b][e] = 0.f;
            k[a][b][e] = 9;
          }
        }
      }
    // input (2*oh + ph, 2*ow + pw) gets window (oh + a, ow + b) with code
    // 3*dh + dw, dh = ph - 2a + 1, dw = pw - 2b + 1; windows in (a, b) order
#pragma unroll
    for (int ph = 0; ph < 2; ++ph)
#pragma unroll
      for (int pw = 0; pw < 2; ++pw) {
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
        for (int a = 0; a <= ph; ++a)
#pragma unroll
          for (int b = 0; b <= pw; ++b) {
            const int want = 3 * (ph - 2 * a + 1) + (pw - 2 * b + 1);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (k[a][b][e] == want) acc[e] += g[a][b][e];
          }
        store_vec<T>(dz + ((m * H + 2 * oh + ph) * W + 2 * ow + pw) * C + cv * VEC, acc);
      }
  }
}

// K8 tile: TH x TW window centres, CT channels, one thread per channel lane.
constexpr int TH = 8, TW = 8, CT = 32, NT8 = 256;

template <class T>
__global__ void __launch_bounds__(NT8) pool_bwd_eq_kernel(const typename T::word* __restrict__ src,
                                                          const typename T::word* __restrict__ g,
                                                          typename T::word* __restrict__ dz,
                                                          int H, int W, int C, int tiles_h,
                                                          int tiles_w) {
  __shared__ float Ms[TH + 1][TW + 1][CT];
  __shared__ float Gs[TH + 1][TW + 1][CT];
  const int Ho = H / 2, Wo = W / 2;
  long long bid = blockIdx.x;
  const int tw = (int)(bid % tiles_w);
  bid /= tiles_w;
  const int th = (int)(bid % tiles_h);
  const long long m = bid / tiles_h;
  const int oh0 = th * TH, ow0 = tw * TW, c0 = blockIdx.y * CT;

  // window maxima and gradients of the tile's centres and the halo below
  // and to the right; a centre past the edge has no gradient
  for (int e = threadIdx.x; e < (TH + 1) * (TW + 1) * CT; e += NT8) {
    const int c = e % CT, cell = e / CT, a = cell / (TW + 1), b = cell % (TW + 1);
    const int oh = oh0 + a, ow = ow0 + b, gc = c0 + c;
    float mx = NAN, gv = 0.f;
    if (oh < Ho && ow < Wo && gc < C) {
      mx = -INFINITY;
      for (int dh = -1; dh <= 1; ++dh) {
        const int h = 2 * oh + dh;
        if (h < 0) continue;
        for (int dw = -1; dw <= 1; ++dw) {
          const int w = 2 * ow + dw;
          if (w < 0) continue;
          mx = fmaxf(mx, T::get(src[((m * H + h) * W + w) * C + gc]));
        }
      }
      gv = T::get(g[((m * Ho + oh) * Wo + ow) * C + gc]);
    }
    Ms[a][b][c] = mx;
    Gs[a][b][c] = gv;
  }
  __syncthreads();

  // dz[p] = sum over the shifts d of G[p + d] * (src[p] == M3[p + d]), in
  // row-major d; only window centres (even p + d) carry a gradient
  for (int e = threadIdx.x; e < 4 * TH * TW * CT; e += NT8) {
    const int c = e % CT, pos = e / CT, ph = pos / (2 * TW), pw = pos % (2 * TW);
    const int h = 2 * oh0 + ph, w = 2 * ow0 + pw, gc = c0 + c;
    if (h >= H || w >= W || gc >= C) continue;
    const size_t at = ((m * H + h) * W + w) * C + gc;
    const float v = T::get(src[at]);
    float acc = 0.f;
    for (int dh = -1; dh <= 1; ++dh) {
      if ((ph + dh) & 1) continue;  // not a centre row
      const int a = (ph + dh) / 2;
      if (a < 0) continue;
      for (int dw = -1; dw <= 1; ++dw) {
        if ((pw + dw) & 1) continue;
        const int b = (pw + dw) / 2;
        if (b < 0) continue;
        if (v == Ms[a][b][c]) acc += Gs[a][b][c];
      }
    }
    dz[at] = T::put(acc);
  }
}

int grid_for(long long cells) {
  const long long blocks = (cells + NT - 1) / NT;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

bool bad_shape(long long M, int H, int W, int C, int vec) {
  return M <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2 || C % vec;
}

}  // namespace

extern "C" {

// K1.  z [M, H, W, C] -> out [M, H/2, W/2, C] (same type), code uint8 of
// out's shape.  bf16 != 0 selects bfloat16 data, else float32.  C must be a
// multiple of 8 (bf16) or 4 (f32) and the pointers 16-byte aligned.
int maxpool_relu_fwd(const void* z, void* out, unsigned char* code, long long M, int H, int W,
                     int C, int bf16, void* stream) {
  const int vec = bf16 ? BF16::VEC : F32::VEC;
  if (bad_shape(M, H, W, C, vec)) return (int)cudaErrorInvalidValue;
  const long long cells = M * (H / 2) * (W / 2) * (C / vec);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    pool_fwd_kernel<BF16><<<grid_for(cells), NT, 0, s>>>(
        (const BF16::word*)z, (BF16::word*)out, code, cells, H, W, C);
  else
    pool_fwd_kernel<F32><<<grid_for(cells), NT, 0, s>>>(
        (const F32::word*)z, (F32::word*)out, code, cells, H, W, C);
  return (int)cudaGetLastError();
}

// K2.  dout [M, H/2, W/2, C] and K1's code -> dz [M, H, W, C], every
// element written.
int maxpool_relu_bwd(const void* dout, const unsigned char* code, void* dz, long long M, int H,
                     int W, int C, int bf16, void* stream) {
  const int vec = bf16 ? BF16::VEC : F32::VEC;
  if (bad_shape(M, H, W, C, vec)) return (int)cudaErrorInvalidValue;
  const long long cells = M * (H / 2) * (W / 2) * (C / vec);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    pool_bwd_kernel<BF16><<<grid_for(cells), NT, 0, s>>>(
        (const BF16::word*)dout, code, (BF16::word*)dz, cells, H, W, C);
  else
    pool_bwd_kernel<F32><<<grid_for(cells), NT, 0, s>>>(
        (const F32::word*)dout, code, (F32::word*)dz, cells, H, W, C);
  return (int)cudaGetLastError();
}

// K8.  src [M, H, W, C] and g [M, H/2, W/2, C] (one type) -> dz [M, H, W, C]
// in that type, every element written.  Any C.
int maxpool_bwd_eq(const void* src, const void* g, void* dz, long long M, int H, int W, int C,
                   int bf16, void* stream) {
  if (bad_shape(M, H, W, C, 1)) return (int)cudaErrorInvalidValue;
  const int tiles_h = (H / 2 + TH - 1) / TH, tiles_w = (W / 2 + TW - 1) / TW;
  const long long blocks = M * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (C + CT - 1) / CT);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    pool_bwd_eq_kernel<BF16><<<grid, NT8, 0, s>>>((const BF16::word*)src, (const BF16::word*)g,
                                                  (BF16::word*)dz, H, W, C, tiles_h, tiles_w);
  else
    pool_bwd_eq_kernel<F32><<<grid, NT8, 0, s>>>((const F32::word*)src, (const F32::word*)g,
                                                 (F32::word*)dz, H, W, C, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
