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
//       bf16; twice the bytes, ~1.80 ms, in f32.  (Before its redesign it
//       read each input about 2.25 times, with 2-byte loads.)
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
//    the bytes.  The ReLU-off instance (kRelu = false, entry point
//    maxpool_fwd: the fused stem's pool of the sign-folded conv output,
//    dpc_tpu's _maxpool_sas_raw) writes the window max itself and the
//    first-max code 0-8, never 9; K2 routes by either code.
//  * K2: a thread owns the 2x2 block of input positions (2*o_h + {0,1},
//    2*o_w + {0,1}) for one channel vector and gathers from the <= 2x2
//    windows that cover them: an even row is covered at o = m/2 (d = 1), an
//    odd row at o = (m-1)/2 (d = 2) and o = (m+1)/2 (d = 0), and the same
//    for columns.  It accumulates in f32, rounds once and writes dz at input
//    resolution: no parity quadrants, no interleave pass, no atomics.
//  * K8 (the vector path, when a pixel's channels are whole 16-byte
//    vectors): a persistent block, one a streaming multiprocessor, walks
//    tiles of 8x8 window centres by a chunk of up to 128 bytes of channels
//    (64 bf16 or 32 f32).  A tile's source rows and columns 2*o0 - 1 ..
//    2*o0 + 17 and the gradients of its windows and the next row and
//    column of windows arrive in shared memory as two TMA boxes of 4-D
//    maps over [M, H, W, C] and [M, H/2, W/2, C] (46 + 10 KB), three tiles
//    in flight, so every byte crosses device memory about once (the
//    halo's re-reads are L2 hits: neighbouring tiles run at the same time
//    on neighbouring blocks).  Each window's max is taken once, from
//    shared memory, with the top and left padding masked by coordinate
//    (TMA fills it with zeros, which would win a window of negatives).  A
//    thread then owns the 2x2 inputs of one window and one channel vector,
//    reads the maxima and gradients of the 2x2 windows covering them, and
//    writes dz with 16-byte stores, neighbouring threads on neighbouring
//    channels.  Equality is taken on the f32 widening of stored values,
//    which is exact; every tied max gets the window's gradient.  The
//    scalar path (any other C) tiles 8x8 centres by 32 channels, one
//    thread a channel lane, from global memory.  Both paths' window max
//    propagates NaN, as the TPU kernel's jnp.maximum does: a window that
//    holds a NaN routes nothing.  The relu variant (the stem's
//    relu-then-pool) routes nothing from a window whose max is not
//    positive, which gates dz by src > 0.
//  * A ragged M, H/2 or W/2 is masked in the kernels; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

// One 16-byte vector of channels, stored as raw words of the element type.
struct F32 {
  using word = float;
  static constexpr int VEC = 4;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ static float get(word w) { return w; }
  __device__ static word put(float f) { return f; }
};

struct BF16 {
  using word = unsigned short;
  static constexpr int VEC = 8;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
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

template <class T, bool kRelu>
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
      o[e] = best[e];
      if (kRelu) {
        if (!(best[e] > 0.f || best[e] != best[e])) o[e] = 0.f;
        if (best[e] <= 0.f) idx[e] = 9;
      }
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

// ---------------------------------------------------------------- K8
// dz[p] = sum over the windows w that cover p, in row-major order, of
// g[w] * [src[p] == M[w]], with M[w] the NaN-propagating max of window w.
// The product form keeps the TPU kernel's arithmetic: a NaN or inf in g
// reaches every input of its window.  kRelu (the pool of relu(src)) turns
// a window max that is not positive into NaN, once a window: then
// src[p] == M[w] only where src[p] > 0, the sum is unchanged there and 0
// elsewhere, as dpc_tpu's eqroute backward (_rmp_bwd) computes it.
template <bool kRelu>
__device__ __forceinline__ float relu_gate(float m) {
  return (kRelu && !(m > 0.f)) ? NAN : m;
}

// Scalar path (a C whose rows are not whole 16-byte vectors, or unaligned
// data): a block owns an 8x8 tile of window centres and 32 channels, one
// thread a channel lane.  It computes the window maxima and gradients of
// the tile and a one-window halo below and to the right into shared
// memory, then every input position of the tile adds the gradient of each
// covering window whose max it equals.
constexpr int TH = 8, TW = 8, CT = 32, NT8 = 256;

template <class T, bool kRelu>
__global__ void __launch_bounds__(NT8) pool_bwd_eq_scalar(const typename T::word* __restrict__ src,
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

  // a centre past the edge has no gradient and a max nothing equals
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
          mx = max_nan(mx, T::get(src[((m * H + h) * W + w) * C + gc]));
        }
      }
      mx = relu_gate<kRelu>(mx);
      gv = T::get(g[((m * Ho + oh) * Wo + ow) * C + gc]);
    }
    Ms[a][b][c] = mx;
    Gs[a][b][c] = gv;
  }
  __syncthreads();

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
        acc = fmaf(Gs[a][b][c], v == Ms[a][b][c] ? 1.f : 0.f, acc);
      }
    }
    dz[at] = T::put(acc);
  }
}

// Vector path: a persistent block walks tiles of KT x KT window centres by
// one chunk of up to 128 bytes of channels.  A tile reads the source rows
// and columns 2*o0 - 1 .. 2*(o0 + KT) + 1 (its windows and the next row and
// column of windows, which the odd inputs at its bottom and right edge also
// belong to) and the gradients of those (KT+1)^2 windows, as two TMA boxes
// of a 4-D map over [M, H, W, C]; NST stages in flight.
constexpr int KT = 8;                                  // window centres a tile side
constexpr int SRC_SIDE = 2 * KT + 3;                   // source rows (and columns) of a tile
constexpr int WIN_SIDE = KT + 1;                       // windows a tile reads, a side
constexpr int CHUNK = 128;                             // bytes of a pixel's channels, at most
constexpr int SRC_BYTES = SRC_SIDE * SRC_SIDE * CHUNK;  // 46,208
constexpr int WIN_BYTES = WIN_SIDE * WIN_SIDE * CHUNK;  // 10,368
constexpr int STAGE_BYTES = SRC_BYTES + WIN_BYTES;      // the g box after the src box
constexpr int NST = 3;                                 // stages of the ring
constexpr int NTV = 512;                               // threads of a block
constexpr int EQ_SMEM = NST * STAGE_BYTES + WIN_BYTES + 1024;  // + window maxima, alignment

struct EqMaps {
  CUtensorMap src, g;
};

template <class T>
__device__ __forceinline__ void lds_vec(const unsigned char* p, float v[T::VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  typename T::word w[T::VEC];
  memcpy(w, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < T::VEC; ++e) v[e] = T::get(w[e]);
}

template <class T, bool kRelu>
__global__ void __launch_bounds__(NTV, 1)
    pool_bwd_eq_tma(const __grid_constant__ EqMaps maps, typename T::word* __restrict__ dz, int H,
                    int W, int C, int bc, int tiles_h, int tiles_w, int chunks, long long tiles) {
  constexpr int VEC = T::VEC;
  extern __shared__ unsigned char dyn[];
  __shared__ uint64_t full[NST];
  const uint32_t base = (smem_u32(dyn) + 1023u) & ~1023u;
  unsigned char* sm = dyn + (base - smem_u32(dyn));
  unsigned char* mbuf = sm + NST * STAGE_BYTES;  // window maxima, in the data's type
  const int pitch = bc * (int)sizeof(typename T::word), nv = pitch / 16;
  const uint32_t tx_bytes = (SRC_SIDE * SRC_SIDE + WIN_SIDE * WIN_SIDE) * pitch;
  const int Ho = H / 2, Wo = W / 2;

  // tile t -> (m, window row o_h0, window column o_w0, first channel c0)
  auto decode = [&](long long t, int& m, int& oh0, int& ow0, int& c0) {
    c0 = (int)(t % chunks) * bc;
    t /= chunks;
    ow0 = (int)(t % tiles_w) * KT;
    t /= tiles_w;
    oh0 = (int)(t % tiles_h) * KT;
    m = (int)(t / tiles_h);
  };
  const CUtensorMap *src_map = &maps.src, *g_map = &maps.g;
  auto issue = [&](long long t, int q) {
    int m, oh0, ow0, c0;
    decode(t, m, oh0, ow0, c0);
    const uint32_t st = base + (q % NST) * STAGE_BYTES, bar = smem_u32(&full[q % NST]);
    mbar_expect_tx(bar, tx_bytes);
    tma_load_4d(st, src_map, c0, 2 * ow0 - 1, 2 * oh0 - 1, m, bar);
    tma_load_4d(st + SRC_BYTES, g_map, c0, ow0, oh0, m, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(smem_u32(&full[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int q = 0; q < NST - 1; ++q) {
      const long long t = blockIdx.x + (long long)q * gridDim.x;
      if (t < tiles) issue(t, q);
    }
  }
  __syncthreads();

  int q = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
    // the stage of tile q - 1, read by every thread before the last barrier
    if (threadIdx.x == 0) {
      const long long tn = t + (long long)(NST - 1) * gridDim.x;
      if (tn < tiles) {
        fence_proxy_async_shared();
        issue(tn, q + NST - 1);
      }
    }
    mbar_wait(smem_u32(&full[q % NST]), (q / NST) & 1);
    int m, oh0, ow0, c0;
    decode(t, m, oh0, ow0, c0);
    const unsigned char* src = sm + (q % NST) * STAGE_BYTES;  // [SRC_SIDE][SRC_SIDE][bc]
    const unsigned char* gs = src + SRC_BYTES;                 // [WIN_SIDE][WIN_SIDE][bc]

    // 1. each window's max, once: 9 reads of a 16-byte vector.  (A
    // separable row-then-column max saves nothing here: neighbouring
    // stride-2 windows share one row of three.)  The top and left padding
    // is skipped by coordinate: TMA filled it with zeros, which could win.
    for (int e = threadIdx.x; e < WIN_SIDE * WIN_SIDE * nv; e += NTV) {
      const int v = e % nv, cell = e / nv, a = cell / WIN_SIDE, b = cell % WIN_SIDE;
      float mx[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) mx[k] = -INFINITY;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int r = 2 * a + dh;
        if (r == 0 && oh0 == 0) continue;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int s = 2 * b + dw;
          if (s == 0 && ow0 == 0) continue;
          float x[VEC];
          lds_vec<T>(src + (r * SRC_SIDE + s) * pitch + v * 16, x);
#pragma unroll
          for (int k = 0; k < VEC; ++k) mx[k] = max_nan(mx[k], x[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) mx[k] = relu_gate<kRelu>(mx[k]);
      // a max of stored values (or NaN) is exact in the data's type
      store_vec<T>(reinterpret_cast<typename T::word*>(mbuf + cell * pitch + v * 16), mx);
    }
    __syncthreads();

    // 2. a thread owns the inputs (2*o_h + {0,1}, 2*o_w + {0,1}) of one
    // channel vector; they lie in the windows (o_h + {0,1}, o_w + {0,1})
    for (int e = threadIdx.x; e < KT * KT * nv; e += NTV) {
      const int v = e % nv, cell = e / nv, i = cell / KT, j = cell % KT;
      const int oh = oh0 + i, ow = ow0 + j, c = c0 + v * VEC;
      if (oh >= Ho || ow >= Wo || c >= C) continue;
      float mw[2][2][VEC], gw[2][2][VEC];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int off = ((i + a) * WIN_SIDE + j + b) * pitch + v * 16;
          lds_vec<T>(mbuf + off, mw[a][b]);
          lds_vec<T>(gs + off, gw[a][b]);
        }
#pragma unroll
      for (int ph = 0; ph < 2; ++ph)
#pragma unroll
        for (int pw = 0; pw < 2; ++pw) {
          float x[VEC], acc[VEC];
          lds_vec<T>(src + ((2 * i + 1 + ph) * SRC_SIDE + 2 * j + 1 + pw) * pitch + v * 16, x);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
          for (int a = 0; a <= ph; ++a)
#pragma unroll
            for (int b = 0; b <= pw; ++b)
#pragma unroll
              for (int k = 0; k < VEC; ++k)
                acc[k] = fmaf(gw[a][b][k], x[k] == mw[a][b][k] ? 1.f : 0.f, acc[k]);
          store_vec<T>(dz + (((long long)m * H + 2 * oh + ph) * W + 2 * ow + pw) * C + c, acc);
        }
    }
    __syncthreads();
  }
}

template <class T, bool kRelu>
int launch_eq_scalar(const void* src, const void* g, void* dz, long long M, int H, int W, int C,
                     cudaStream_t s) {
  using word = typename T::word;
  const int tiles_h = (H / 2 + TH - 1) / TH, tiles_w = (W / 2 + TW - 1) / TW;
  const long long blocks = M * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (C + CT - 1) / CT);
  pool_bwd_eq_scalar<T, kRelu><<<grid, NT8, 0, s>>>((const word*)src, (const word*)g, (word*)dz,
                                                     H, W, C, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

template <class T, bool kRelu>
int launch_eq_tma(const void* src, const void* g, void* dz, long long M, int H, int W, int C,
                  cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t es = sizeof(typename T::word), c = C, w = W, h = H, wo = W / 2, ho = H / 2;
  const int bc = C * (int)es <= CHUNK ? C : CHUNK / (int)es;
  const int chunks = (C + bc - 1) / bc;
  const cuuint64_t src_dims[4] = {c, w, h, (cuuint64_t)M}, g_dims[4] = {c, wo, ho, (cuuint64_t)M};
  const cuuint64_t src_strides[3] = {c * es, w * c * es, h * w * c * es};
  const cuuint64_t g_strides[3] = {c * es, wo * c * es, ho * wo * c * es};
  const cuuint32_t src_box[4] = {(cuuint32_t)bc, SRC_SIDE, SRC_SIDE, 1};
  const cuuint32_t g_box[4] = {(cuuint32_t)bc, WIN_SIDE, WIN_SIDE, 1}, ones[4] = {1, 1, 1, 1};
  EqMaps maps;
  if (encode(&maps.src, T::TMA_TYPE, 4, const_cast<void*>(src), src_dims, src_strides, src_box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&maps.g, T::TMA_TYPE, 4, const_cast<void*>(g), g_dims, g_strides, g_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (H / 2 + KT - 1) / KT, tiles_w = (W / 2 + KT - 1) / KT;
  const long long tiles = M * tiles_h * tiles_w * chunks;
  const cudaError_t err = cudaFuncSetAttribute(
      pool_bwd_eq_tma<T, kRelu>, cudaFuncAttributeMaxDynamicSharedMemorySize, EQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long slots = sm_count();
  const int grid = (int)(tiles < slots ? tiles : slots);
  pool_bwd_eq_tma<T, kRelu><<<grid, NTV, EQ_SMEM, s>>>(
      maps, (typename T::word*)dz, H, W, C, bc, tiles_h, tiles_w, chunks, tiles);
  return (int)cudaGetLastError();
}

int grid_for(long long cells) {
  const long long blocks = (cells + NT - 1) / NT;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

bool bad_shape(long long M, int H, int W, int C, int vec) {
  return M <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2 || C % vec;
}

template <bool kRelu>
int launch_fwd(const void* z, void* out, unsigned char* code, long long M, int H, int W, int C,
               int bf16, cudaStream_t s) {
  const int vec = bf16 ? BF16::VEC : F32::VEC;
  if (bad_shape(M, H, W, C, vec)) return (int)cudaErrorInvalidValue;
  const long long cells = M * (H / 2) * (W / 2) * (C / vec);
  if (bf16)
    pool_fwd_kernel<BF16, kRelu><<<grid_for(cells), NT, 0, s>>>(
        (const BF16::word*)z, (BF16::word*)out, code, cells, H, W, C);
  else
    pool_fwd_kernel<F32, kRelu><<<grid_for(cells), NT, 0, s>>>(
        (const F32::word*)z, (F32::word*)out, code, cells, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  z [M, H, W, C] -> out = relu(max) [M, H/2, W/2, C] (same type), code
// uint8 of out's shape (9: max <= 0).  bf16 != 0 selects bfloat16 data, else
// float32.  C must be a multiple of 8 (bf16) or 4 (f32) and the pointers
// 16-byte aligned.
int maxpool_relu_fwd(const void* z, void* out, unsigned char* code, long long M, int H, int W,
                     int C, int bf16, void* stream) {
  return launch_fwd<true>(z, out, code, M, H, W, C, bf16, (cudaStream_t)stream);
}

// K1 without the ReLU: out = the window max, code 0-8.  As maxpool_relu_fwd.
int maxpool_fwd(const void* z, void* out, unsigned char* code, long long M, int H, int W, int C,
                int bf16, void* stream) {
  return launch_fwd<false>(z, out, code, M, H, W, C, bf16, (cudaStream_t)stream);
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
// in that type, every element written.  relu != 0 gates dz by src > 0 (the
// stem's relu-then-pool).  Any C: the vector path when a pixel's channels
// are whole 16-byte vectors and the data is 16-byte aligned (TMA's
// strides and addresses), else the scalar path.
int maxpool_bwd_eq(const void* src, const void* g, void* dz, long long M, int H, int W, int C,
                   int bf16, int relu, void* stream) {
  if (bad_shape(M, H, W, C, 1)) return (int)cudaErrorInvalidValue;
  const long long es = bf16 ? 2 : 4;
  const bool vec = (C * es) % 16 == 0 &&
                   (((uintptr_t)src | (uintptr_t)g | (uintptr_t)dz) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (bf16)
      return relu ? launch_eq_tma<BF16, true>(src, g, dz, M, H, W, C, s)
                  : launch_eq_tma<BF16, false>(src, g, dz, M, H, W, C, s);
    return relu ? launch_eq_tma<F32, true>(src, g, dz, M, H, W, C, s)
                : launch_eq_tma<F32, false>(src, g, dz, M, H, W, C, s);
  }
  if (bf16)
    return relu ? launch_eq_scalar<BF16, true>(src, g, dz, M, H, W, C, s)
                : launch_eq_scalar<BF16, false>(src, g, dz, M, H, W, C, s);
  return relu ? launch_eq_scalar<F32, true>(src, g, dz, M, H, W, C, s)
              : launch_eq_scalar<F32, false>(src, g, dz, M, H, W, C, s);
}

}  // extern "C"
