// Flash-NCE for Hopper: K-NCE-F (forward) and K-NCE-B (backward).
//
// Replaces dpc_tpu/ops/nce_pallas.py: `_fwd_kernel` (forward, pallas_call
// at :97) and `_bwd_fused_kernel` / `_bwd_rows_kernel` / `_bwd_cols_kernel`
// (backward, pallas_calls at :224, :272, :291).  Neither direction writes
// the [R, C] score matrix to device memory.
//
// What bounds it on this card: the score product, 2·R·C·D multiply-adds in
// f32 on the CUDA cores (the TPU kernels compute in f32 too).  At the
// flagship R = C = 3072, D = 256 the inputs are 6 MB and the product is
// 4.8 GFLOP, so the kernels are bound by operations, not bytes.
//
// Design:
//  * Forward: one block per 64-row tile loops over every 64-column tile
//    inside the block.  That loop takes the place of the TPU's sequential
//    grid axis, which carried the running max and sum in scratch.  Each
//    row keeps an online logsumexp and the rank count
//    #{j != target : s_ij > pos_i} in registers, reduced across the 16
//    threads that share the row by warp shuffles.
//  * `pos` comes in from outside (the elementwise dot the JAX op uses);
//    the target column is excluded from the rank by index, never by
//    comparing it with itself, so reduction order cannot break the strict >.
//  * Backward: two deterministic sweeps instead of the TPU's one sweep
//    with the whole row block resident (3 MB at the flagship: more than a
//    block's 227 KB of shared memory).  Sweep 1: one block per (64-row
//    tile, 128-wide slice of D) accumulates drows over all column tiles.
//    Sweep 2: the same kernel with the roles of rows and columns swapped
//    accumulates dcols.  Each recomputes S; no atomics, so the result does
//    not depend on scheduling.
//  * Ragged R and C are masked in the kernels; nothing is padded.
#include <cuda_runtime.h>
#include <math.h>

#include "tile.cuh"

using namespace dpct;

namespace {

constexpr int DT = 128;  // width of the slice of D one backward block owns
constexpr int PK = 16;   // rows of the second operand staged per chunk

__global__ void __launch_bounds__(NT) nce_fwd_kernel(
    const float* __restrict__ rows, const float* __restrict__ cols,
    const float* __restrict__ pos, const int* __restrict__ targets,
    float* __restrict__ lse, float* __restrict__ rank, int R, int C, int D) {
  __shared__ float As[TILE][KT + 1];
  __shared__ float Bs[TILE][KT + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * TILE;

  float m[4], s[4], cnt[4], p[4];
  int t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    p[i] = r < R ? pos[r] : 0.f;
    t[i] = r < R ? targets[r] : -1;
    m[i] = -INFINITY;
    s[i] = 0.f;
    cnt[i] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += TILE) {
    float acc[4][4];
    score_tile(rows, R, r0, cols, C, c0, D, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + tx + 16 * j < C) tmax = fmaxf(tmax, acc[i][j]);
      // column c0 is always valid, so the tile max is finite
      const float mn = fmaxf(m[i], half_warp_max(tmax));
      float ps = 0.f, pc = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < C) {
          ps += expf(acc[i][j] - mn);
          if (acc[i][j] > p[i] && c != t[i]) pc += 1.f;
        }
      }
      ps = half_warp_sum(ps);
      pc = half_warp_sum(pc);
      s[i] = s[i] * expf(m[i] - mn) + ps;
      m[i] = mn;
      cnt[i] += pc;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r < R) {
        lse[r] = logf(s[i]) + m[i];
        rank[r] = cnt[i];
      }
    }
  }
}

// d_own[a, :] = sum_b P[a, b] · other[b, :], with P = exp(S - lse)·g masked
// to the valid R x C block and S[a, b] = dot(own[a], other[b]).  lse and g
// are indexed by the score row: by `a` when own = rows (drows), by `b`
// when own = cols (dcols).
template <bool OWN_IS_ROWS>
__global__ void __launch_bounds__(NT) nce_bwd_kernel(
    const float* __restrict__ own, int n_own, const float* __restrict__ other,
    int n_other, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ d_own, int D) {
  __shared__ float As[TILE][KT + 1];
  __shared__ float Bs[TILE][KT + 1];
  __shared__ float Ps[TILE][TILE + 1];
  __shared__ float Os[PK][DT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int a0 = blockIdx.x * TILE, d0 = blockIdx.y * DT;

  float l_own[4], g_own[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
    l_own[i] = (OWN_IS_ROWS && a < n_own) ? lse[a] : 0.f;
    g_own[i] = (OWN_IS_ROWS && a < n_own) ? g[a] : 0.f;
  }
  float out[4][DT / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) out[i][j] = 0.f;

  for (int b0 = 0; b0 < n_other; b0 += TILE) {
    float acc[4][4];
    score_tile(own, n_own, a0, other, n_other, b0, D, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = a0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b0 + tx + 16 * j;
        float pv = 0.f;
        if (a < n_own && b < n_other) {
          const float l = OWN_IS_ROWS ? l_own[i] : lse[b];
          const float gg = OWN_IS_ROWS ? g_own[i] : g[b];
          pv = expf(acc[i][j] - l) * gg;
        }
        Ps[ty + 16 * i][tx + 16 * j] = pv;
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < TILE; k0 += PK) {
      for (int e = tid; e < PK * DT; e += NT) {
        const int kk = e / DT, dd = e % DT;
        const int gb = b0 + k0 + kk, gd = d0 + dd;
        Os[kk][dd] = (gb < n_other && gd < D) ? other[(size_t)gb * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < PK; ++kk) {
        float pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = Ps[ty + 16 * i][k0 + kk];
#pragma unroll
        for (int j = 0; j < DT / 16; ++j) {
          const float o = Os[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) out[i][j] = fmaf(pa[i], o, out[i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) {
      const int d = d0 + tx + 16 * j;
      if (a < n_own && d < D) d_own[(size_t)a * D + d] = out[i][j];
    }
  }
}

}  // namespace

extern "C" {

// lse[r] = logsumexp_c(rows[r]·cols[c]); rank[r] = #{c != targets[r] :
// rows[r]·cols[c] > pos[r]}.  All pointers are device memory, f32 except
// targets (int32), row-major and contiguous.
int nce_fwd(const float* rows, const float* cols, const float* pos, const int* targets,
            float* lse, float* rank, int R, int C, int D, void* stream) {
  if (R <= 0 || C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((R + TILE - 1) / TILE);
  nce_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(rows, cols, pos, targets, lse,
                                                        rank, R, C, D);
  return (int)cudaGetLastError();
}

// drows = P·cols and dcols = Pᵀ·rows with P = exp(rows·colsᵀ − lse)·g.
int nce_bwd(const float* rows, const float* cols, const float* lse, const float* g,
            float* drows, float* dcols, int R, int C, int D, void* stream) {
  if (R <= 0 || C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int dslices = (D + DT - 1) / DT;
  nce_bwd_kernel<true><<<dim3((R + TILE - 1) / TILE, dslices), NT, 0, s>>>(
      rows, R, cols, C, lse, g, drows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nce_bwd_kernel<false><<<dim3((C + TILE - 1) / TILE, dslices), NT, 0, s>>>(
      cols, C, rows, R, lse, g, dcols, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
