// Shared pieces of the hand-written Hopper kernels of dpc_tpu_torch.
//
// Every kernel here computes in f32 on the CUDA cores, as the TPU kernels
// they replace compute in f32 on the MXU.  The score tile below is the one
// matrix product the NCE kernels share: a 64x64 tile of A·Bᵀ over a
// reduction of length D, staged through shared memory in K-chunks of 32.
#pragma once

#include <cuda_runtime.h>

namespace dpct {

constexpr int TILE = 64;     // rows (and columns) of one score tile
constexpr int KT = 32;       // reduction chunk staged in shared memory
constexpr int NT = 256;      // threads per block: a 16x16 grid of 4x4 cells

// Half-warp reductions: the 16 threads that share one row of a tile sit in
// one half of a warp (tid = ty*16 + tx), so xor-shuffles below 16 stay in it.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] = dot(A[a0 + ty + 16i], B[b0 + tx + 16j]) over D, for the
// calling thread's 4x4 cell of the 64x64 tile.  Rows past nA / nB read as
// zero, so ragged edges need no padding in device memory.  Must be called
// by all NT threads of the block.
__device__ __forceinline__ void score_tile(const float* __restrict__ A, int nA, int a0,
                                           const float* __restrict__ B, int nB, int b0,
                                           int D, float (*As)[KT + 1], float (*Bs)[KT + 1],
                                           float acc[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KT) {
    for (int e = tid; e < TILE * KT; e += NT) {
      const int r = e / KT, k = e % KT, gk = k0 + k;
      const int ga = a0 + r, gb = b0 + r;
      As[r][k] = (ga < nA && gk < D) ? A[(size_t)ga * D + gk] : 0.f;
      Bs[r][k] = (gb < nB && gk < D) ? B[(size_t)gb * D + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace dpct
