// Whole-sequence ConvGRU (kernel_size 1) for Hopper: K-GRU-F and K-GRU-B.
//
// Replaces dpc_tpu/ops/convgru_pallas.py: `_fwd_kernel` (pallas_call at
// :88) and `_bwd_kernel` (pallas_call at :207).  With a 1x1 kernel every
// spatial cell is an independent row, and one step is
//   z, r = sigmoid(x·Wzr_x + h·Wzr_h + b_zr)      (update ‖ reset)
//   o    = tanh(x·Wo_x + (h⊙r)·Wo_h + b_o)
//   h    = (h⊙(1−z) + o⊙z) ⊙ mask_t               (mask: inverted dropout)
// Weight layout is `pack_weights` of the JAX op: Wzr_x [Cin, 2Ch],
// Wzr_h [Ch, 2Ch], Wo_x [Cin, Ch], Wo_h [Ch, Ch], all row-major f32.
//
// What bounds it on this card: the gate products, 6·Ch·(Cin+Ch) f32
// multiply-adds per row and step on the CUDA cores (8 GFLOP forward at the
// flagship T=5, R=1024, Cin=Ch=256).  The bytes (x, masks, outputs: 16 MB)
// are far below that line.
//
// Design:
//  * A block owns RT rows across all channels and walks the T steps itself,
//    with __syncthreads() between the phases of a step.  Rows never talk
//    to each other, so no synchronisation across blocks is needed.
//  * The TPU kept all weights resident in VMEM (1.5 MB at Ch=256, 24 MB at
//    Ch=1024); that does not fit in shared memory.  Instead each thread
//    owns output channels and streams its weight column from L2 once per
//    step, using each weight RT times from registers.  The hidden state,
//    the input rows and the gates stay in shared memory for the sequence.
//  * Backward: the reverse recurrence recomputes the gates from the saved
//    h_{t-1} (as the TPU kernel and `_core_bwd_jax` do), emits dx and dh0,
//    and writes the per-step gate cotangents.  The TPU accumulated the
//    weight gradients in place across its sequential grid; blocks here run
//    in no order, so a second kernel computes them as deterministic
//    reductions over all T·R rows (one block per 64x64 tile of a weight
//    gradient, bias gradients as an extra row).  No atomics.
//  * Ragged row counts are masked in the kernels; nothing is padded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

template <int RT>
__global__ void __launch_bounds__(NT) gru_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ h0,
    const float* __restrict__ wzr_x, const float* __restrict__ wzr_h,
    const float* __restrict__ b_zr, const float* __restrict__ wo_x,
    const float* __restrict__ wo_h, const float* __restrict__ b_o,
    const float* __restrict__ masks, float* __restrict__ out, int T, int R, int Cin,
    int Ch) {
  extern __shared__ float sm[];
  float* xs = sm;              // [RT][Cin]  x_t
  float* hs = xs + RT * Cin;   // [RT][Ch]   h
  float* zs = hs + RT * Ch;    // [RT][Ch]   update gate
  float* hr = zs + RT * Ch;    // [RT][Ch]   h ⊙ reset gate
  const int tid = threadIdx.x, r0 = blockIdx.x * RT, N2 = 2 * Ch;

  for (int e = tid; e < RT * Ch; e += NT) {
    const int r = e / Ch, c = e % Ch;
    hs[e] = (r0 + r < R) ? h0[(size_t)(r0 + r) * Ch + c] : 0.f;
  }
  for (int t = 0; t < T; ++t) {
    for (int e = tid; e < RT * Cin; e += NT) {
      const int r = e / Cin, k = e % Cin;
      xs[e] = (r0 + r < R) ? x[((size_t)t * R + r0 + r) * Cin + k] : 0.f;
    }
    __syncthreads();
    for (int n = tid; n < N2; n += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = b_zr[n];
      for (int k = 0; k < Cin; ++k) {
        const float w = wzr_x[(size_t)k * N2 + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xs[r * Cin + k], w, acc[r]);
      }
      for (int k = 0; k < Ch; ++k) {
        const float w = wzr_h[(size_t)k * N2 + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(hs[r * Ch + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float gv = sigm(acc[r]);
        if (n < Ch) zs[r * Ch + n] = gv;
        else hr[r * Ch + n - Ch] = hs[r * Ch + n - Ch] * gv;
      }
    }
    __syncthreads();
    for (int n = tid; n < Ch; n += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = b_o[n];
      for (int k = 0; k < Cin; ++k) {
        const float w = wo_x[(size_t)k * Ch + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xs[r * Cin + k], w, acc[r]);
      }
      for (int k = 0; k < Ch; ++k) {
        const float w = wo_h[(size_t)k * Ch + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(hr[r * Ch + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r0 + r < R) {
          const size_t gi = ((size_t)t * R + r0 + r) * Ch + n;
          const float o = tanhf(acc[r]), z = zs[r * Ch + n], h = hs[r * Ch + n];
          const float hn = (h * (1.f - z) + o * z) * masks[gi];
          hs[r * Ch + n] = hn;
          out[gi] = hn;
        }
      }
    }
    __syncthreads();
  }
}

template <int RT>
__global__ void __launch_bounds__(NT) gru_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ hin_seq,
    const float* __restrict__ masks, const float* __restrict__ gout,
    const float* __restrict__ wzr_x, const float* __restrict__ wzr_h,
    const float* __restrict__ b_zr, const float* __restrict__ wo_x,
    const float* __restrict__ wo_h, const float* __restrict__ b_o,
    const float* __restrict__ wzr_xT, const float* __restrict__ wzr_hT,
    const float* __restrict__ wo_xT, const float* __restrict__ wo_hT,
    float* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ dazr_g,
    float* __restrict__ dao_g, float* __restrict__ hr_g, int T, int R, int Cin, int Ch) {
  extern __shared__ float sm[];
  float* xs = sm;                // [RT][Cin]  x_t
  float* hin = xs + RT * Cin;    // [RT][Ch]   h_{t-1}
  float* zs = hin + RT * Ch;     // [RT][Ch]   update gate
  float* rs = zs + RT * Ch;      // [RT][Ch]   reset gate
  float* hr = rs + RT * Ch;      // [RT][Ch]   h_{t-1} ⊙ r
  float* dh = hr + RT * Ch;      // [RT][Ch]   cotangent of h_{t-1} (carried)
  float* dao = dh + RT * Ch;     // [RT][Ch]   cotangent of the o pre-activation
  float* dazr = dao + RT * Ch;   // [RT][2Ch]  cotangents of the z ‖ r pre-activations
  const int tid = threadIdx.x, r0 = blockIdx.x * RT, N2 = 2 * Ch;

  for (int e = tid; e < RT * Ch; e += NT) dh[e] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    for (int e = tid; e < RT * Cin; e += NT) {
      const int r = e / Cin, k = e % Cin;
      xs[e] = (r0 + r < R) ? x[((size_t)t * R + r0 + r) * Cin + k] : 0.f;
    }
    for (int e = tid; e < RT * Ch; e += NT) {
      const int r = e / Ch, k = e % Ch;
      hin[e] = (r0 + r < R) ? hin_seq[((size_t)t * R + r0 + r) * Ch + k] : 0.f;
    }
    __syncthreads();
    // recompute z and r
    for (int n = tid; n < N2; n += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = b_zr[n];
      for (int k = 0; k < Cin; ++k) {
        const float w = wzr_x[(size_t)k * N2 + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xs[r * Cin + k], w, acc[r]);
      }
      for (int k = 0; k < Ch; ++k) {
        const float w = wzr_h[(size_t)k * N2 + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(hin[r * Ch + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float gv = sigm(acc[r]);
        if (n < Ch) {
          zs[r * Ch + n] = gv;
        } else {
          const int c = n - Ch;
          const float v = hin[r * Ch + c] * gv;
          rs[r * Ch + c] = gv;
          hr[r * Ch + c] = v;
          if (r0 + r < R) hr_g[((size_t)t * R + r0 + r) * Ch + c] = v;
        }
      }
    }
    __syncthreads();
    // recompute o, then the elementwise part of the step's backward
    for (int n = tid; n < Ch; n += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = b_o[n];
      for (int k = 0; k < Cin; ++k) {
        const float w = wo_x[(size_t)k * Ch + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(xs[r * Cin + k], w, acc[r]);
      }
      for (int k = 0; k < Ch; ++k) {
        const float w = wo_h[(size_t)k * Ch + n];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(hr[r * Ch + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bool valid = r0 + r < R;
        const size_t gi = ((size_t)t * R + r0 + r) * Ch + n;
        const float o = tanhf(acc[r]), z = zs[r * Ch + n], hi = hin[r * Ch + n];
        const float gh = dh[r * Ch + n] + (valid ? gout[gi] : 0.f);
        const float draw = gh * (valid ? masks[gi] : 0.f);
        const float dz = draw * (o - hi);
        const float dov = draw * z;
        dh[r * Ch + n] = draw * (1.f - z);
        const float dao_v = dov * (1.f - o * o);
        const float daz = dz * z * (1.f - z);
        dao[r * Ch + n] = dao_v;
        dazr[r * N2 + n] = daz;
        if (valid) {
          dao_g[gi] = dao_v;
          dazr_g[((size_t)t * R + r0 + r) * N2 + n] = daz;
        }
      }
    }
    __syncthreads();
    // dhr = dao · Wo_hᵀ, then the reset-gate cotangent
    for (int k = tid; k < Ch; k += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      for (int n = 0; n < Ch; ++n) {
        const float w = wo_hT[(size_t)n * Ch + k];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(dao[r * Ch + n], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float rr = rs[r * Ch + k];
        dh[r * Ch + k] += acc[r] * rr;
        const float dr = acc[r] * hin[r * Ch + k];
        const float dar = dr * rr * (1.f - rr);
        dazr[r * N2 + Ch + k] = dar;
        if (r0 + r < R) dazr_g[((size_t)t * R + r0 + r) * N2 + Ch + k] = dar;
      }
    }
    __syncthreads();
    // dx_t = dazr · Wzr_xᵀ + dao · Wo_xᵀ
    for (int k = tid; k < Cin; k += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      for (int n = 0; n < N2; ++n) {
        const float w = wzr_xT[(size_t)n * Cin + k];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(dazr[r * N2 + n], w, acc[r]);
      }
      for (int n = 0; n < Ch; ++n) {
        const float w = wo_xT[(size_t)n * Cin + k];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(dao[r * Ch + n], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r0 + r < R) dx[((size_t)t * R + r0 + r) * Cin + k] = acc[r];
    }
    // dh_{t-1} += dazr · Wzr_hᵀ
    for (int k = tid; k < Ch; k += NT) {
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      for (int n = 0; n < N2; ++n) {
        const float w = wzr_hT[(size_t)n * Ch + k];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(dazr[r * N2 + n], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) dh[r * Ch + k] += acc[r];
    }
    __syncthreads();
  }
  for (int e = tid; e < RT * Ch; e += NT) {
    const int r = e / Ch, c = e % Ch;
    if (r0 + r < R) dh0[(size_t)(r0 + r) * Ch + c] = dh[e];
  }
}

// out[k, n] = sum_m A[m, k] · B[m, n] for k < K, plus, when `bias`, a row
// out[K, n] = sum_m B[m, n].  One block per 64x64 output tile; the sum over
// m runs in order inside the block, so the result is deterministic.
struct WGradJob {
  const float* A;
  const float* B;
  float* out;
  int K, N, bias;
};
struct WGradJobs {
  WGradJob job[4];
};

__global__ void __launch_bounds__(NT) gru_wgrad_kernel(WGradJobs jobs, int M) {
  const WGradJob jb = jobs.job[blockIdx.z];
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64, Kt = jb.K + jb.bias;
  if (n0 >= jb.N || k0 >= Kt) return;  // the whole block leaves together
  __shared__ float As[16][64];
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m0 = 0; m0 < M; m0 += 16) {
    for (int e = tid; e < 16 * 64; e += NT) {
      const int mm = e / 64, c = e % 64, m = m0 + mm, k = k0 + c, n = n0 + c;
      float a = 0.f;
      if (m < M) {
        if (k < jb.K) a = jb.A[(size_t)m * jb.K + k];
        else if (k == jb.K && jb.bias) a = 1.f;
      }
      As[mm][c] = a;
      Bs[mm][c] = (m < M && n < jb.N) ? jb.B[(size_t)m * jb.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < 16; ++mm) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (k < Kt && n < jb.N) jb.out[(size_t)k * jb.N + n] = acc[i][j];
    }
  }
}

constexpr size_t kMaxSmem = 200 * 1024;

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Rows per block: as many as shared memory holds, at most 8.
int pick_rows(size_t floats_per_row) {
  for (int rt = 8; rt >= 2; rt /= 2)
    if (rt * floats_per_row * sizeof(float) <= kMaxSmem) return rt;
  return 0;
}

template <int RT>
cudaError_t launch_fwd(const float* x, const float* h0, const float* wzr_x,
                       const float* wzr_h, const float* b_zr, const float* wo_x,
                       const float* wo_h, const float* b_o, const float* masks, float* out,
                       int T, int R, int Cin, int Ch, cudaStream_t s) {
  const size_t smem = (size_t)RT * (Cin + 3 * Ch) * sizeof(float);
  cudaError_t err = set_smem(gru_fwd_kernel<RT>, smem);
  if (err != cudaSuccess) return err;
  gru_fwd_kernel<RT><<<(R + RT - 1) / RT, NT, smem, s>>>(x, h0, wzr_x, wzr_h, b_zr, wo_x,
                                                         wo_h, b_o, masks, out, T, R, Cin, Ch);
  return cudaGetLastError();
}

template <int RT>
cudaError_t launch_bwd(const float* x, const float* hin_seq, const float* masks,
                       const float* gout, const float* wzr_x, const float* wzr_h,
                       const float* b_zr, const float* wo_x, const float* wo_h,
                       const float* b_o, const float* wzr_xT, const float* wzr_hT,
                       const float* wo_xT, const float* wo_hT, float* dx, float* dh0,
                       float* dazr, float* dao, float* hr, int T, int R, int Cin, int Ch,
                       cudaStream_t s) {
  const size_t smem = (size_t)RT * (Cin + 8 * Ch) * sizeof(float);
  cudaError_t err = set_smem(gru_bwd_kernel<RT>, smem);
  if (err != cudaSuccess) return err;
  gru_bwd_kernel<RT><<<(R + RT - 1) / RT, NT, smem, s>>>(
      x, hin_seq, masks, gout, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, wzr_xT, wzr_hT, wo_xT,
      wo_hT, dx, dh0, dazr, dao, hr, T, R, Cin, Ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[t] = h_t for t < T, from x [T, R, Cin], h0 [R, Ch], masks [T, R, Ch].
int convgru_fwd(const float* x, const float* h0, const float* wzr_x, const float* wzr_h,
                const float* b_zr, const float* wo_x, const float* wo_h, const float* b_o,
                const float* masks, float* out, int T, int R, int Cin, int Ch,
                void* stream) {
  if (T <= 0 || R <= 0 || Cin <= 0 || Ch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_rows((size_t)Cin + 3 * Ch)) {
    case 8: return (int)launch_fwd<8>(x, h0, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, masks, out, T, R, Cin, Ch, s);
    case 4: return (int)launch_fwd<4>(x, h0, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, masks, out, T, R, Cin, Ch, s);
    case 2: return (int)launch_fwd<2>(x, h0, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, masks, out, T, R, Cin, Ch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward of convgru_fwd.  hin_seq[t] = h_{t-1} (h0, then out[:-1]);
// gout [T, R, Ch] is the cotangent of out.  The *T weights are the
// transposes of the forward ones.  dazr [T, R, 2Ch], dao [T, R, Ch] and
// hr [T, R, Ch] are scratch.  dwzr_xb is [Cin + 1, 2Ch] and dwo_xb is
// [Cin + 1, Ch]: their last rows are the bias gradients.
int convgru_bwd(const float* x, const float* hin_seq, const float* masks, const float* gout,
                const float* wzr_x, const float* wzr_h, const float* b_zr,
                const float* wo_x, const float* wo_h, const float* b_o,
                const float* wzr_xT, const float* wzr_hT, const float* wo_xT,
                const float* wo_hT, float* dx, float* dh0, float* dazr, float* dao,
                float* hr, float* dwzr_xb, float* dwzr_h, float* dwo_xb, float* dwo_h,
                int T, int R, int Cin, int Ch, void* stream) {
  if (T <= 0 || R <= 0 || Cin <= 0 || Ch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (pick_rows((size_t)Cin + 8 * Ch)) {
    case 8: err = launch_bwd<8>(x, hin_seq, masks, gout, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, wzr_xT, wzr_hT, wo_xT, wo_hT, dx, dh0, dazr, dao, hr, T, R, Cin, Ch, s); break;
    case 4: err = launch_bwd<4>(x, hin_seq, masks, gout, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, wzr_xT, wzr_hT, wo_xT, wo_hT, dx, dh0, dazr, dao, hr, T, R, Cin, Ch, s); break;
    case 2: err = launch_bwd<2>(x, hin_seq, masks, gout, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, wzr_xT, wzr_hT, wo_xT, wo_hT, dx, dh0, dazr, dao, hr, T, R, Cin, Ch, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  WGradJobs jobs;
  jobs.job[0] = {x, dazr, dwzr_xb, Cin, 2 * Ch, 1};
  jobs.job[1] = {hin_seq, dazr, dwzr_h, Ch, 2 * Ch, 0};
  jobs.job[2] = {x, dao, dwo_xb, Cin, Ch, 1};
  jobs.job[3] = {hr, dao, dwo_h, Ch, Ch, 0};
  const int kmax = (Cin > Ch ? Cin : Ch) + 1;
  dim3 grid((2 * Ch + 63) / 64, (kmax + 63) / 64, 4);
  gru_wgrad_kernel<<<grid, NT, 0, s>>>(jobs, T * R);
  return (int)cudaGetLastError();
}

}  // extern "C"
