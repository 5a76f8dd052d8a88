// Whole-sequence ConvGRU (kernel_size 1) for Hopper: K-GRU-F (`convgru_fwd`)
// and K-GRU-B (`convgru_bwd`) on the tensor cores.
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
// What bounds it on this card: the products, 6·Ch·(Cin+Ch) multiply-adds
// per row and step forward (4 GFLOP at T=5, R=1024, Cin=Ch=256), three
// times that backward, which recomputes the gates.  The contract is f32, so
// every product runs as 3xTF32 `wgmma` (tf32_wgmma.cuh): 0.024 ms forward
// against the tensor cores' 495 TFLOP/s, where the bytes (x, masks,
// outputs: 16 MB) take 0.005 ms.  What bounds it in practice is the
// recurrence: 2T products that depend on each other, each too small to
// fill the card.
//
// Design:
//  * Only what carries h (forward) or dh (backward) runs in sequence; the
//    rest is hoisted into products over all T·R rows at once.
//  * Forward: Gx = x·[Wzr_x | Wo_x] for all steps in one product, then one
//    persistent cooperative kernel walks the T steps, as the TPU keeps the
//    step loop inside one program.  Each step is two dependent products:
//    (a) h·Wzr_h, whose epilogue forms z and writes h⊙r straight into
//    hi/lo planes; (b) (h⊙r)·Wo_h, whose epilogue forms h_t, writes out[t]
//    and h_t's planes for the next step.  h stays f32 and is split afresh
//    every step.  Rows never mix, so instead of a grid barrier a tile waits,
//    on a counter per 64-row tile, only for the tiles of its own rows that
//    it reads, and row tiles run ahead of each other.
//  * Backward: the gates are recomputed as the TPU kernel does, but all at
//    once from (x, h0, out): Gx and hin·Wzr_h in one launch, then z, r,
//    h⊙r elementwise, then (h⊙r)·Wo_h.  The persistent kernel walks t =
//    T−1 … 0 with two products a step: (c) dhr = dao·Wo_hᵀ, whose epilogue
//    forms the reset-gate cotangent; (d) dh += dazr·Wzr_hᵀ, whose epilogue
//    runs the elementwise head of step t−1 (gh, dz, dao, daz).  After the
//    scan one launch computes dX = dazr·Wzr_xᵀ + dao·Wo_xᵀ and the four
//    weight gradients, whose K = T·R is split across blocks to fill the
//    card; the partials are added in split order (no atomics, so the
//    result does not depend on scheduling).  The bias gradients come from
//    a row of ones appended to xᵀ.
//  * `.tf32` wgmma takes only K-major operands: prep passes write the
//    transposed weight planes for the forward products and xᵀ, hinᵀ,
//    (h⊙r)ᵀ, dazrᵀ, daoᵀ for the weight gradients; dhr, dh and dX use the
//    weights as stored.
//  * Planes written with ordinary stores and read by TMA in another block
//    are fenced with `fence.proxy.async.global` on both sides of the
//    counter's release and acquire.
//  * Parallel products: 128×128 tiles, two warpgroups sharing the B tile,
//    a 3-stage ring of 64 KB, one block an SM.  The recurrence: 64×32
//    tiles (twice the tiles of 64×64 at R = 512), one warpgroup, a 4-stage
//    ring, two blocks an SM, the grid at most the co-resident block count.
//    Ragged R and channel counts rely on TMA's zero fill and on the
//    epilogues' index masks; plane rows are padded to 16 bytes.
#include <algorithm>
#include <functional>
#include <queue>
#include <vector>

#include "tf32_wgmma.cuh"

namespace {

// Bytes of a ring stage: hi/lo of WG 64-row A boxes and of BN B rows.
__host__ __device__ constexpr int stage_bytes(int bn, int wg) {
  return 2 * wg * BOX_BYTES + 2 * bn * BK * 4;
}

// parallel products: 128 x 128 output tiles, two warpgroups sharing B
constexpr int GWG = 2;
constexpr int GN = 128;
constexpr int G_NST = 3;
constexpr int G_STAGE = stage_bytes(GN, GWG);
constexpr int G_SMEM = G_NST * G_STAGE + 1024;  // + 1024-byte alignment
// the recurrence: 64 x 32 output tiles, one warpgroup
constexpr int NT = 128;
constexpr int SN = 32;
constexpr int S_NST = 4;
constexpr int S_STAGE = stage_bytes(SN, 1);
constexpr int S_SMEM = S_NST * S_STAGE + 1024;

constexpr int MAX_PLANES = 10;
constexpr int MAX_JOBS = 6;
constexpr int MAX_SPLITS = 16;

// TMA maps of the hi/lo planes a kernel reads.
struct Planes {
  CUtensorMap hi[MAX_PLANES];
  CUtensorMap lo[MAX_PLANES];
};

// ---------------------------------------------------------------- device

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void put_split(float* hi, float* lo, size_t at, float v) {
  const float h = tf32_rna(v);
  hi[at] = h;
  lo[at] = tf32_rna(v - h);
}

// sum[64 x BN] = (accumulate ? sum : 0) + A[a0 + 64·wg .., chunks
// kc0..kc1) · B[b0 .. b0+BN−1, same chunks]ᵀ for warpgroup wg of WG, one
// fresh accumulator per 32-wide K chunk.  The warpgroups share the B tile.
// q counts the ring's stages across calls; thread 0 keeps NST − 1 stages
// in flight.  B boxes are min(BN, 64) rows (the maps' box height).
template <int BN, int WG, int NST>
__device__ __forceinline__ void tile_product(const Ring<NST, stage_bytes(BN, WG)>& ring, int& q,
                                             const CUtensorMap* ah, const CUtensorMap* al,
                                             int a0, const CUtensorMap* bh, const CUtensorMap* bl,
                                             int b0, int kc0, int kc1, float (&sum)[BN / 2],
                                             bool accumulate) {
  constexpr int ABOX = WG * BOX_BYTES, BBOX = BN * BK * 4, BR = BN < BM ? BN : BM;
  const int n = kc1 - kc0;
  auto load = [&](int i) {
    const uint32_t st = ring.stage(q + i), bar = ring.bar(q + i);
    const int x = (kc0 + i) * BK;
    mbar_expect_tx(bar, stage_bytes(BN, WG));
#pragma unroll
    for (int w = 0; w < WG; ++w) {
      tma_load(st + w * BOX_BYTES, ah, x, a0 + w * BM, bar);
      tma_load(st + ABOX + w * BOX_BYTES, al, x, a0 + w * BM, bar);
    }
#pragma unroll
    for (int b = 0; b < BN / BR; ++b) {
      tma_load(st + 2 * ABOX + b * BR * BK * 4, bh, x, b0 + b * BR, bar);
      tma_load(st + 2 * ABOX + BBOX + b * BR * BK * 4, bl, x, b0 + b * BR, bar);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < NST - 1 && i < n; ++i) load(i);
  const uint32_t wg = threadIdx.x / 128 * BOX_BYTES;
  float acc[BN / 2];
  for (int i = 0; i < n; ++i) {
    if (threadIdx.x == 0 && i + NST - 1 < n) load(i + NST - 1);
    ring.wait(q + i);
    const uint32_t st = ring.stage(q + i);
    wg_fence();
    reg_fence(acc);
    score_chunk(acc, st + wg, st + ABOX + wg, st + 2 * ABOX, st + 2 * ABOX + BBOX);
    wg_commit();
    wg_wait0();
    reg_fence(acc);
    const bool first = i == 0 && !accumulate;
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) sum[k] = first ? acc[k] : sum[k] + acc[k];
    __syncthreads();  // every wgmma of this stage is done: its slot may refill
  }
  q += n;
}

// The scans order their tiles by per-row-tile counters instead of grid
// barriers: a tile waits only for the tiles of its own 64 rows that it
// reads.  Each block walks its tiles in (step, product, tile) order and the
// launch is cooperative (every block resident), so the earliest unfinished
// tile can always run and the scan cannot deadlock.  A wait that never
// ends (a wrong count) traps instead of hanging the card.
//
// Marks this block's tile done: its plane stores (generic proxy) become
// visible to the TMA loads (async proxy) of the blocks that wait for it.
__device__ __forceinline__ void signal_done(unsigned int* flag) {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1u);
  }
}

// Waits until *flag ≥ target: the tiles this block's next tile reads are done.
__device__ __forceinline__ void wait_done(const unsigned int* flag, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v;
    long long spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
      if (++spins > (1ll << 22)) __trap();
    } while (v < target);
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
  __syncthreads();
}

// Calls f(row offset in tile, column offset in tile, accumulator index)
// for the elements of the 64 x BN accumulators this thread holds
// (warpgroup wg holds rows 64·wg ..).
template <int BN, typename F>
__device__ __forceinline__ void for_acc(F f) {
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, tq = tid % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(16 * w + g + 8 * h, 8 * j + 2 * tq + e, 4 * j + 2 * h + e);
}

// ---- parallel products: out[M, N] = A[M, K]·B[N, K]ᵀ (+ A2·B2ᵀ)

struct Job {
  int a, b;          // planes of A [M, K] and B [N, K]
  int a2, b2, K2;    // a second product added to the first (K2 = 0: none)
  int M, N, K;
  int splits;        // K split across blocks: split s writes out + s·M·N
  int ld;            // leading dimension of out
  int first;         // first block of the job
  float* out;
};

struct GemmArgs {
  Planes maps;
  Job job[MAX_JOBS];
  int njobs;
};

__global__ void __launch_bounds__(GWG * 128, 1) gru_gemm_kernel(const __grid_constant__ GemmArgs p) {
  __shared__ uint64_t full[G_NST];
  extern __shared__ uint8_t dyn[];
  const auto ring = make_ring<G_NST, G_STAGE>(dyn, full);
  int j = 0;
  while (j + 1 < p.njobs && static_cast<int>(blockIdx.x) >= p.job[j + 1].first) ++j;
  const Job& jb = p.job[j];
  const int local = blockIdx.x - jb.first, split = local % jb.splits, tile = local / jb.splits;
  const int tn = (jb.N + GN - 1) / GN, m0 = tile / tn * GWG * BM, n0 = tile % tn * GN;
  const int nk = (jb.K + BK - 1) / BK;
  int q = 0;
  float sum[GN / 2];
  tile_product<GN, GWG, G_NST>(ring, q, &p.maps.hi[jb.a], &p.maps.lo[jb.a], m0, &p.maps.hi[jb.b],
                          &p.maps.lo[jb.b], n0, split * nk / jb.splits,
                          (split + 1) * nk / jb.splits, sum, false);
  if (jb.K2 > 0)
    tile_product<GN, GWG, G_NST>(ring, q, &p.maps.hi[jb.a2], &p.maps.lo[jb.a2], m0,
                            &p.maps.hi[jb.b2], &p.maps.lo[jb.b2], n0, 0, (jb.K2 + BK - 1) / BK,
                            sum, true);
  float* out = jb.out + static_cast<size_t>(split) * jb.M * jb.N;
  for_acc<GN>([&](int r, int c, int i) {
    const int row = m0 + r, col = n0 + c;
    if (row < jb.M && col < jb.N) out[static_cast<size_t>(row) * jb.ld + col] = sum[i];
  });
}

// ---- forward recurrence

enum { F_H, F_HR, F_WZRH_T, F_WOH_T };  // planes of the forward scan

struct FwdScan {
  const float* gx;     // [T·R, 3Ch]  x·[Wzr_x | Wo_x]
  const float* b_zr;
  const float* b_o;
  const float* masks;  // [T, R, Ch]
  const float* h0;     // [R, Ch]
  float* out;          // [T, R, Ch]
  float* z;            // [R, Ch]  update gate of the current step
  float *h_hi, *h_lo, *hr_hi, *hr_lo;  // planes [R, ldh]
  unsigned int* done;  // [2][row tiles]: tiles of (a), of (b) done so far
  int T, R, Ch, ldh;
};

__global__ void __launch_bounds__(NT, 2) gru_fwd_scan(const __grid_constant__ Planes maps,
                                                   const FwdScan a) {
  __shared__ uint64_t full[S_NST];
  extern __shared__ uint8_t dyn[];
  const auto ring = make_ring<S_NST, S_STAGE>(dyn, full);
  const int R = a.R, Ch = a.Ch, N3 = 3 * Ch, nk = (Ch + BK - 1) / BK;
  const int tiles_m = (R + BM - 1) / BM, tn_a = (2 * Ch + SN - 1) / SN, tn_b = (Ch + SN - 1) / SN;
  unsigned int* done_a = a.done;
  unsigned int* done_b = a.done + tiles_m;
  int q = 0;
  float sum[SN / 2];
  for (int t = 0; t < a.T; ++t) {
    const float* hp = t == 0 ? a.h0 : a.out + static_cast<size_t>(t - 1) * R * Ch;
    const float* gx = a.gx + static_cast<size_t>(t) * R * N3;
    // (a) z ‖ r = sigmoid(Gx_zr + h·Wzr_h + b_zr); writes z and h⊙r's planes.
    // Reads h_{t-1} of its rows: every (b) tile of those rows of step t−1.
    for (int tile = blockIdx.x; tile < tiles_m * tn_a; tile += gridDim.x) {
      const int mt = tile / tn_a, m0 = mt * BM, n0 = tile % tn_a * SN;
      wait_done(&done_b[mt], t * tn_b);
      tile_product<SN, 1, S_NST>(ring, q, &maps.hi[F_H], &maps.lo[F_H], m0, &maps.hi[F_WZRH_T],
                              &maps.lo[F_WZRH_T], n0, 0, nk, sum, false);
      for_acc<SN>([&](int r, int c, int i) {
        const int row = m0 + r, n = n0 + c;
        if (row >= R || n >= 2 * Ch) return;
        const float v = sigm(sum[i] + gx[static_cast<size_t>(row) * N3 + n] + a.b_zr[n]);
        if (n < Ch) {
          a.z[static_cast<size_t>(row) * Ch + n] = v;
        } else {
          const int k = n - Ch;
          put_split(a.hr_hi, a.hr_lo, static_cast<size_t>(row) * a.ldh + k,
                    hp[static_cast<size_t>(row) * Ch + k] * v);
        }
      });
      signal_done(&done_a[mt]);
    }
    // (b) o = tanh(Gx_o + (h⊙r)·Wo_h + b_o); h_t = (h(1−z) + o·z)·mask_t.
    // Reads z and h⊙r of its rows: every (a) tile of those rows of step t.
    for (int tile = blockIdx.x; tile < tiles_m * tn_b; tile += gridDim.x) {
      const int mt = tile / tn_b, m0 = mt * BM, n0 = tile % tn_b * SN;
      wait_done(&done_a[mt], (t + 1) * tn_a);
      tile_product<SN, 1, S_NST>(ring, q, &maps.hi[F_HR], &maps.lo[F_HR], m0, &maps.hi[F_WOH_T],
                              &maps.lo[F_WOH_T], n0, 0, nk, sum, false);
      for_acc<SN>([&](int r, int c, int i) {
        const int row = m0 + r, n = n0 + c;
        if (row >= R || n >= Ch) return;
        const size_t e = static_cast<size_t>(row) * Ch + n;
        const size_t gi = static_cast<size_t>(t) * R * Ch + e;
        const float o = tanhf(sum[i] + gx[static_cast<size_t>(row) * N3 + 2 * Ch + n] + a.b_o[n]);
        const float z = a.z[e], h = hp[e];
        const float hn = (h * (1.f - z) + o * z) * a.masks[gi];
        a.out[gi] = hn;
        put_split(a.h_hi, a.h_lo, static_cast<size_t>(row) * a.ldh + n, hn);
      });
      signal_done(&done_b[mt]);
    }
  }
}

// ---- backward

enum { B_DAO, B_DAZR, B_WOH, B_WZRH };  // planes of the backward scan

struct BwdScan {
  const float* zr;     // [T·R, 2Ch]  z ‖ r, recomputed
  const float* o;      // [T·R, Ch]   o, recomputed
  const float* hin;    // [T·R, Ch]   h_{t-1}
  const float* masks;
  const float* gout;   // [T·R, Ch]   cotangent of out
  float* dh;           // [R, Ch]     the carried cotangent
  float* dh0;
  float* dazr;         // [T·R, 2Ch]  cotangents of the z ‖ r pre-activations
  float* dao;          // [T·R, Ch]   cotangent of the o pre-activation
  float *dazr_hi, *dazr_lo, *dao_hi, *dao_lo;  // planes [T·R, ld2], [T·R, ldh]
  unsigned int* done;  // [2][row tiles]: tiles of (c), of (d) done so far
  int T, R, Ch, ld2, ldh;
};

// The elementwise head of step t at (row, c), with dh the cotangent of h_t
// carried from step t+1: leaves draw·(1−z) in dh, writes dao and daz.
__device__ __forceinline__ void step_head(const BwdScan& a, int t, int row, int c, float dh,
                                          float o) {
  const size_t m = static_cast<size_t>(t) * a.R + row;
  const size_t gi = m * a.Ch + c, zi = m * 2 * a.Ch + c;
  const float draw = (dh + a.gout[gi]) * a.masks[gi];
  const float z = a.zr[zi];
  const float dz = draw * (o - a.hin[gi]);
  a.dh[static_cast<size_t>(row) * a.Ch + c] = draw * (1.f - z);
  const float dao = draw * z * (1.f - o * o);
  const float daz = dz * z * (1.f - z);
  a.dao[gi] = dao;
  put_split(a.dao_hi, a.dao_lo, m * a.ldh + c, dao);
  a.dazr[zi] = daz;
  put_split(a.dazr_hi, a.dazr_lo, m * a.ld2 + c, daz);
}

// z, r = sigmoid(Gx_zr + hin·Wzr_h + b_zr) in place of the product; hr = hin⊙r.
__global__ void gate_kernel(const float* __restrict__ gx, float* __restrict__ zr,
                            const float* __restrict__ hin, const float* __restrict__ b_zr,
                            float* __restrict__ hr, size_t n, int Ch) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t m = i / Ch;
    const int c = static_cast<int>(i % Ch);
    const size_t zi = m * 2 * Ch + c, gi = m * 3 * Ch + c;
    const float z = sigm(gx[gi] + zr[zi] + b_zr[c]);
    const float r = sigm(gx[gi + Ch] + zr[zi + Ch] + b_zr[Ch + c]);
    zr[zi] = z;
    zr[zi + Ch] = r;
    hr[i] = hin[i] * r;
  }
}

// o = tanh(Gx_o + hr·Wo_h + b_o) in place of the product, and the head of
// step T−1, where the carried cotangent is zero.
__global__ void out_gate_kernel(const BwdScan a, const float* __restrict__ gx,
                                const float* __restrict__ b_o, float* o) {
  const int Ch = a.Ch;
  const size_t n = static_cast<size_t>(a.T) * a.R * Ch, last = static_cast<size_t>(a.T - 1) * a.R;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t m = i / Ch;
    const int c = static_cast<int>(i % Ch);
    const float v = tanhf(gx[m * 3 * Ch + 2 * Ch + c] + o[i] + b_o[c]);
    o[i] = v;
    if (m >= last) step_head(a, a.T - 1, static_cast<int>(m - last), c, 0.f, v);
  }
}

__global__ void __launch_bounds__(NT, 2) gru_bwd_scan(const __grid_constant__ Planes maps,
                                                   const BwdScan a) {
  __shared__ uint64_t full[S_NST];
  extern __shared__ uint8_t dyn[];
  const auto ring = make_ring<S_NST, S_STAGE>(dyn, full);
  const int R = a.R, Ch = a.Ch;
  const int tiles_m = (R + BM - 1) / BM, tn = (Ch + SN - 1) / SN;
  const int nk_c = (Ch + BK - 1) / BK, nk_d = (2 * Ch + BK - 1) / BK;
  unsigned int* done_c = a.done;
  unsigned int* done_d = a.done + tiles_m;
  int q = 0;
  float sum[SN / 2];
  for (int t = a.T - 1; t >= 0; --t) {
    const size_t m_t = static_cast<size_t>(t) * R;
    // (c) dhr = dao·Wo_hᵀ: dh += dhr⊙r, and the reset-gate cotangent.
    // Reads dao and dh of its rows: every (d) tile of those rows of step t+1.
    for (int tile = blockIdx.x; tile < tiles_m * tn; tile += gridDim.x) {
      const int mt = tile / tn, m0 = mt * BM, n0 = tile % tn * SN;
      wait_done(&done_d[mt], (a.T - 1 - t) * tn);
      tile_product<SN, 1, S_NST>(ring, q, &maps.hi[B_DAO], &maps.lo[B_DAO],
                              static_cast<int>(m_t) + m0, &maps.hi[B_WOH], &maps.lo[B_WOH], n0,
                              0, nk_c, sum, false);
      for_acc<SN>([&](int r, int c, int i) {
        const int row = m0 + r, k = n0 + c;
        if (row >= R || k >= Ch) return;
        const size_t m = m_t + row;
        const float rr = a.zr[m * 2 * Ch + Ch + k], dhr = sum[i];
        a.dh[static_cast<size_t>(row) * Ch + k] += dhr * rr;
        const float dar = dhr * a.hin[m * Ch + k] * rr * (1.f - rr);
        a.dazr[m * 2 * Ch + Ch + k] = dar;
        put_split(a.dazr_hi, a.dazr_lo, m * a.ld2 + Ch + k, dar);
      });
      signal_done(&done_c[mt]);
    }
    // (d) dh_{t-1} = dh + dazr·Wzr_hᵀ, then the head of step t−1.
    // Reads dazr and dh of its rows: every (c) tile of those rows of step t.
    for (int tile = blockIdx.x; tile < tiles_m * tn; tile += gridDim.x) {
      const int mt = tile / tn, m0 = mt * BM, n0 = tile % tn * SN;
      wait_done(&done_c[mt], (a.T - t) * tn);
      tile_product<SN, 1, S_NST>(ring, q, &maps.hi[B_DAZR], &maps.lo[B_DAZR],
                              static_cast<int>(m_t) + m0, &maps.hi[B_WZRH], &maps.lo[B_WZRH],
                              n0, 0, nk_d, sum, false);
      for_acc<SN>([&](int r, int c, int i) {
        const int row = m0 + r, k = n0 + c;
        if (row >= R || k >= Ch) return;
        const size_t e = static_cast<size_t>(row) * Ch + k;
        const float dh = a.dh[e] + sum[i];
        if (t > 0)
          step_head(a, t - 1, row, k, dh, a.o[(m_t - R) * Ch + e]);
        else
          a.dh0[e] = dh;
      });
      signal_done(&done_d[mt]);
    }
  }
}

__global__ void ones_row(float* __restrict__ hi, float* __restrict__ lo, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    hi[i] = 1.f;
    lo[i] = 0.f;
  }
}

// ------------------------------------------------------------------ host

// A pair of hi/lo planes [rows, cols] with leading dimension ld, at float
// offsets of the scratch buffer.
struct PlaneBuf {
  size_t hi = 0, lo = 0;
  int rows = 0, cols = 0, ld = 0;
};

struct Plan {
  int TR = 0, ldx = 0, ldh = 0, ld2 = 0, ldr = 0, splits = 1;
  PlaneBuf x, wxT, wzrhT, wohT, h, hr;
  PlaneBuf xT, hin, hinT, wzrx, wox, wzrh, woh, hrT, dazr, dazrT, dao, daoT;
  size_t done = 0, gx = 0, z = 0, zr = 0, o = 0, hrf = 0, dazrf = 0, daof = 0, dh = 0;
  size_t part[4] = {0, 0, 0, 0};
  int wM[4] = {0, 0, 0, 0}, wN[4] = {0, 0, 0, 0};
  size_t total = 0;
};

// Output tiles of an [m, n] parallel product.
inline int gemm_tiles(int m, int n) {
  return ((m + GWG * BM - 1) / (GWG * BM)) * ((n + GN - 1) / GN);
}

// Splits of the weight gradients' K = T·R (nk chunks): the fewest that
// minimise the makespan, in chunks, of the launch that also runs dX
// (dx_tiles blocks of dx_chunks), blocks taking the SMs (one block each)
// in launch order as they free, the weight gradients first.  At most
// MAX_SPLITS.
int pick_wgrad_splits(int wtiles, int nk, int dx_tiles, int dx_chunks) {
  thread_local long long key[4] = {-1, -1, -1, -1};
  thread_local int cached = 1;
  const long long k[4] = {wtiles, nk, dx_tiles, dx_chunks};
  if (std::equal(k, k + 4, key)) return cached;
  const int slots = sm_count();
  int best = 1;
  long long best_span = -1;
  for (int s = 1; s <= MAX_SPLITS && s <= nk; ++s) {
    std::priority_queue<long long, std::vector<long long>, std::greater<long long>> free_at;
    for (int i = 0; i < slots; ++i) free_at.push(0);
    long long span = 0;
    for (int b = 0; b < wtiles * s + dx_tiles; ++b) {
      const int sp = b % s;
      const long long c = b < wtiles * s ? (sp + 1) * nk / s - sp * nk / s : dx_chunks;
      const long long end = free_at.top() + c;
      free_at.pop();
      free_at.push(end);
      span = end > span ? end : span;
    }
    if (best_span < 0 || span < best_span) {
      best = s;
      best_span = span;
    }
  }
  std::copy(k, k + 4, key);
  cached = best;
  return best;
}

Plan plan(int T, int R, int Cin, int Ch, bool backward) {
  Plan p;
  p.TR = T * R;
  p.ldx = round_up(Cin, 4);  // TMA strides are multiples of 16 bytes
  p.ldh = round_up(Ch, 4);
  p.ld2 = round_up(2 * Ch, 4);
  p.ldr = round_up(p.TR, 4);
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off = align64(off + n);
    return at;
  };
  auto plane = [&](int rows, int cols, int ld) {
    PlaneBuf b;
    b.rows = rows;
    b.cols = cols;
    b.ld = ld;
    b.hi = take(static_cast<size_t>(rows) * ld);
    b.lo = take(static_cast<size_t>(rows) * ld);
    return b;
  };
  const size_t TR = p.TR;
  p.done = take(2 * ((R + BM - 1) / BM));
  p.x = plane(p.TR, Cin, p.ldx);
  p.wxT = plane(3 * Ch, Cin, p.ldx);
  p.wzrhT = plane(2 * Ch, Ch, p.ldh);
  p.wohT = plane(Ch, Ch, p.ldh);
  p.gx = take(TR * 3 * Ch);
  if (!backward) {
    p.h = plane(R, Ch, p.ldh);
    p.hr = plane(R, Ch, p.ldh);
    p.z = take(static_cast<size_t>(R) * Ch);
  } else {
    p.xT = plane(Cin + 1, p.TR, p.ldr);
    p.hin = plane(p.TR, Ch, p.ldh);
    p.hinT = plane(Ch, p.TR, p.ldr);
    p.wzrx = plane(Cin, 2 * Ch, p.ld2);
    p.wox = plane(Cin, Ch, p.ldh);
    p.wzrh = plane(Ch, 2 * Ch, p.ld2);
    p.woh = plane(Ch, Ch, p.ldh);
    p.zr = take(TR * 2 * Ch);
    p.o = take(TR * Ch);
    p.hrf = take(TR * Ch);
    p.hr = plane(p.TR, Ch, p.ldh);
    p.hrT = plane(Ch, p.TR, p.ldr);
    p.dazrf = take(TR * 2 * Ch);
    p.dazr = plane(p.TR, 2 * Ch, p.ld2);
    p.dazrT = plane(2 * Ch, p.TR, p.ldr);
    p.daof = take(TR * Ch);
    p.dao = plane(p.TR, Ch, p.ldh);
    p.daoT = plane(Ch, p.TR, p.ldr);
    p.dh = take(static_cast<size_t>(R) * Ch);
    // dWzr_x‖db_zr [Cin+1, 2Ch], dWo_x‖db_o [Cin+1, Ch], dWzr_h, dWo_h
    const int M[4] = {Cin + 1, Cin + 1, Ch, Ch}, N[4] = {2 * Ch, Ch, 2 * Ch, Ch};
    int wtiles = 0;
    for (int i = 0; i < 4; ++i) {
      p.wM[i] = M[i];
      p.wN[i] = N[i];
      wtiles += gemm_tiles(M[i], N[i]);
    }
    p.splits = pick_wgrad_splits(wtiles, (p.TR + BK - 1) / BK, gemm_tiles(p.TR, Cin),
                                 (2 * Ch + BK - 1) / BK + (Ch + BK - 1) / BK);
    for (int i = 0; i < 4; ++i)
      p.part[i] = p.splits > 1 ? take(static_cast<size_t>(p.splits) * M[i] * N[i]) : 0;
  }
  p.total = off;
  return p;
}

int split_into(const float* x, int n, int D, float* hi, float* lo, int ld, float* hiT,
               float* loT, int ldT, cudaStream_t s) {
  const dim3 grid((D + 31) / 32, (n + 31) / 32), block(32, 8);
  split_kernel<false><<<grid, block, 0, s>>>(x, n, D, hi, lo, ld, hiT, loT, ldT);
  return static_cast<int>(cudaGetLastError());
}

// The maps of plane b into slot i of a Planes, in boxes of box_rows rows.
bool set_maps(Planes& m, int i, float* w, const PlaneBuf& b, int box_rows) {
  return make_map(&m.hi[i], w + b.hi, b.cols, b.rows, b.ld, box_rows) &&
         make_map(&m.lo[i], w + b.lo, b.cols, b.rows, b.ld, box_rows);
}

// One launch of gru_gemm_kernel over a list of jobs.
struct Gemm {
  GemmArgs args;
  float* w;
  int nplanes = 0, blocks = 0;
  bool ok = true;

  explicit Gemm(float* scratch) : w(scratch) { args.njobs = 0; }

  int plane(const PlaneBuf& b) {
    if (nplanes == MAX_PLANES || !set_maps(args.maps, nplanes, w, b, BM)) ok = false;
    return nplanes++;
  }

  void job(int a, int b, int M, int N, int K, float* out, int ld, int splits = 1, int a2 = 0,
           int b2 = 0, int K2 = 0) {
    if (args.njobs == MAX_JOBS) {
      ok = false;
      return;
    }
    Job& j = args.job[args.njobs++];
    j = Job{a, b, a2, b2, K2, M, N, K, splits, ld, blocks, out};
    blocks += gemm_tiles(M, N) * splits;
  }

  int run(cudaStream_t s) {
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(gru_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    gru_gemm_kernel<<<blocks, GWG * 128, G_SMEM, s>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

// Cooperative launch of a scan kernel: at most the co-resident block
// count, at most `tiles` blocks.  A grid the card cannot hold at once is
// refused, never run.
template <typename Args>
int launch_scan(void (*kernel)(Planes, Args), const Planes& maps, const Args& args, int tiles,
                cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, S_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = per_sm * sm_count();
  if (grid > tiles) grid = tiles;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = S_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The transposed weight planes both directions read: [Wzr_x | Wo_x]ᵀ
// [3Ch, Cin], Wzr_hᵀ [2Ch, Ch], Wo_hᵀ [Ch, Ch]; with `stored`, also the
// weights as they are stored (the backward's dX, dhr and dh products).
int split_weights(const Plan& p, float* w, const float* wzr_x, const float* wzr_h,
                  const float* wo_x, const float* wo_h, int Cin, int Ch, bool stored,
                  cudaStream_t s) {
  auto hi = [&](const PlaneBuf& b) { return stored ? w + b.hi : nullptr; };
  auto lo = [&](const PlaneBuf& b) { return stored ? w + b.lo : nullptr; };
  const size_t o_rows = static_cast<size_t>(2 * Ch) * p.ldx;
  int err = split_into(wzr_x, Cin, 2 * Ch, hi(p.wzrx), lo(p.wzrx), p.ld2, w + p.wxT.hi,
                       w + p.wxT.lo, p.ldx, s);
  if (err == 0)
    err = split_into(wo_x, Cin, Ch, hi(p.wox), lo(p.wox), p.ldh, w + p.wxT.hi + o_rows,
                     w + p.wxT.lo + o_rows, p.ldx, s);
  if (err == 0)
    err = split_into(wzr_h, Ch, 2 * Ch, hi(p.wzrh), lo(p.wzrh), p.ld2, w + p.wzrhT.hi,
                     w + p.wzrhT.lo, p.ldh, s);
  if (err == 0)
    err = split_into(wo_h, Ch, Ch, hi(p.woh), lo(p.woh), p.ldh, w + p.wohT.hi, w + p.wohT.lo,
                     p.ldh, s);
  return err;
}

// Bytes of the scans' done counters: two per 64-row tile.
size_t done_bytes(int R) {
  return 2 * static_cast<size_t>((R + BM - 1) / BM) * sizeof(unsigned int);
}

int elementwise_blocks(size_t n) {
  const size_t b = (n + 255) / 256, cap = static_cast<size_t>(8) * sm_count();
  return static_cast<int>(b < cap ? b : cap);
}

}  // namespace

extern "C" {

// Floats of scratch that convgru_fwd / convgru_bwd need for these sizes.
long long convgru_fwd_scratch_floats(int T, int R, int Cin, int Ch) {
  return static_cast<long long>(plan(T, R, Cin, Ch, false).total);
}

long long convgru_bwd_scratch_floats(int T, int R, int Cin, int Ch) {
  return static_cast<long long>(plan(T, R, Cin, Ch, true).total);
}

// out[t] = h_t for t < T, from x [T, R, Cin], h0 [R, Ch], masks [T, R, Ch];
// all f32, contiguous, on the device; scratch holds
// convgru_fwd_scratch_floats(T, R, Cin, Ch) floats.
int convgru_fwd(const float* x, const float* h0, const float* wzr_x, const float* wzr_h,
                const float* b_zr, const float* wo_x, const float* wo_h, const float* b_o,
                const float* masks, float* out, float* scratch, long long scratch_floats, int T,
                int R, int Cin, int Ch, void* stream) {
  if (T <= 0 || R <= 0 || Cin <= 0 || Ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(T, R, Cin, Ch, false);
  if (scratch_floats < static_cast<long long>(p.total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = scratch;
  int err = split_into(x, p.TR, Cin, w + p.x.hi, w + p.x.lo, p.ldx, nullptr, nullptr, 0, s);
  if (err == 0) err = split_weights(p, w, wzr_x, wzr_h, wo_x, wo_h, Cin, Ch, false, s);
  if (err == 0)
    err = split_into(h0, R, Ch, w + p.h.hi, w + p.h.lo, p.ldh, nullptr, nullptr, 0, s);
  if (err != 0) return err;

  Gemm gx(w);  // Gx = x·[Wzr_x | Wo_x] for every step at once
  gx.job(gx.plane(p.x), gx.plane(p.wxT), p.TR, 3 * Ch, Cin, w + p.gx, 3 * Ch);
  err = gx.run(s);
  if (err != 0) return err;

  Planes maps;
  if (!set_maps(maps, F_H, w, p.h, BM) || !set_maps(maps, F_HR, w, p.hr, BM) ||
      !set_maps(maps, F_WZRH_T, w, p.wzrhT, SN) || !set_maps(maps, F_WOH_T, w, p.wohT, SN))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdScan a{w + p.gx, b_zr, b_o, masks, h0, out, w + p.z,
            w + p.h.hi, w + p.h.lo, w + p.hr.hi, w + p.hr.lo,
            reinterpret_cast<unsigned int*>(w + p.done), T, R, Ch, p.ldh};
  cudaError_t e = cudaMemsetAsync(w + p.done, 0, done_bytes(R), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((R + BM - 1) / BM) * ((2 * Ch + SN - 1) / SN);
  return launch_scan(gru_fwd_scan, maps, a, tiles, s);
}

// Backward of convgru_fwd.  hin_seq[t] = h_{t-1} (h0, then out[:-1]);
// gout [T, R, Ch] is the cotangent of out.  dwzr_xb is [Cin + 1, 2Ch] and
// dwo_xb is [Cin + 1, Ch]: their last rows are the bias gradients.  scratch
// holds convgru_bwd_scratch_floats(T, R, Cin, Ch) floats.
int convgru_bwd(const float* x, const float* hin_seq, const float* masks, const float* gout,
                const float* wzr_x, const float* wzr_h, const float* b_zr, const float* wo_x,
                const float* wo_h, const float* b_o, float* dx, float* dh0, float* dwzr_xb,
                float* dwzr_h, float* dwo_xb, float* dwo_h, float* scratch,
                long long scratch_floats, int T, int R, int Cin, int Ch, void* stream) {
  if (T <= 0 || R <= 0 || Cin <= 0 || Ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(T, R, Cin, Ch, true);
  if (scratch_floats < static_cast<long long>(p.total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = scratch;
  const size_t TR = p.TR, n_h = TR * Ch;

  // operand planes: x and hin both ways (xᵀ with a row of ones), weights
  int err = split_into(x, p.TR, Cin, w + p.x.hi, w + p.x.lo, p.ldx, w + p.xT.hi, w + p.xT.lo,
                       p.ldr, s);
  if (err == 0)
    err = split_into(hin_seq, p.TR, Ch, w + p.hin.hi, w + p.hin.lo, p.ldh, w + p.hinT.hi,
                     w + p.hinT.lo, p.ldr, s);
  if (err == 0) err = split_weights(p, w, wzr_x, wzr_h, wo_x, wo_h, Cin, Ch, true, s);
  if (err != 0) return err;
  const size_t ones = static_cast<size_t>(Cin) * p.ldr;
  ones_row<<<elementwise_blocks(TR), 256, 0, s>>>(w + p.xT.hi + ones, w + p.xT.lo + ones, p.TR);

  // the gates, recomputed for every step at once
  Gemm g1(w);
  g1.job(g1.plane(p.x), g1.plane(p.wxT), p.TR, 3 * Ch, Cin, w + p.gx, 3 * Ch);
  g1.job(g1.plane(p.hin), g1.plane(p.wzrhT), p.TR, 2 * Ch, Ch, w + p.zr, 2 * Ch);
  err = g1.run(s);
  if (err != 0) return err;
  gate_kernel<<<elementwise_blocks(n_h), 256, 0, s>>>(w + p.gx, w + p.zr, hin_seq, b_zr,
                                                      w + p.hrf, n_h, Ch);
  err = split_into(w + p.hrf, p.TR, Ch, w + p.hr.hi, w + p.hr.lo, p.ldh, w + p.hrT.hi,
                   w + p.hrT.lo, p.ldr, s);
  if (err != 0) return err;
  Gemm g2(w);
  g2.job(g2.plane(p.hr), g2.plane(p.wohT), p.TR, Ch, Ch, w + p.o, Ch);
  err = g2.run(s);
  if (err != 0) return err;

  BwdScan a{w + p.zr, w + p.o, hin_seq, masks, gout, w + p.dh, dh0, w + p.dazrf, w + p.daof,
            w + p.dazr.hi, w + p.dazr.lo, w + p.dao.hi, w + p.dao.lo,
            reinterpret_cast<unsigned int*>(w + p.done), T, R, Ch, p.ld2, p.ldh};
  out_gate_kernel<<<elementwise_blocks(n_h), 256, 0, s>>>(a, w + p.gx, b_o, w + p.o);
  cudaError_t e = cudaMemsetAsync(w + p.done, 0, done_bytes(R), s);
  if (e != cudaSuccess) return static_cast<int>(e);

  // the reverse scan: only what carries dh
  Planes maps;
  if (!set_maps(maps, B_DAO, w, p.dao, BM) || !set_maps(maps, B_DAZR, w, p.dazr, BM) ||
      !set_maps(maps, B_WOH, w, p.woh, SN) || !set_maps(maps, B_WZRH, w, p.wzrh, SN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((R + BM - 1) / BM) * ((Ch + SN - 1) / SN);
  err = launch_scan(gru_bwd_scan, maps, a, tiles, s);
  if (err != 0) return err;

  // dX and the weight gradients, over all T·R rows at once
  err = split_into(w + p.dazrf, p.TR, 2 * Ch, nullptr, nullptr, 0, w + p.dazrT.hi,
                   w + p.dazrT.lo, p.ldr, s);
  if (err == 0)
    err = split_into(w + p.daof, p.TR, Ch, nullptr, nullptr, 0, w + p.daoT.hi, w + p.daoT.lo,
                     p.ldr, s);
  if (err != 0) return err;
  Gemm g3(w);
  const int xT = g3.plane(p.xT), hinT = g3.plane(p.hinT), hrT = g3.plane(p.hrT);
  const int dazrT = g3.plane(p.dazrT), daoT = g3.plane(p.daoT);
  float* wout[4] = {dwzr_xb, dwo_xb, dwzr_h, dwo_h};
  const int wa[4] = {xT, xT, hinT, hrT}, wb[4] = {dazrT, daoT, dazrT, daoT};
  for (int i = 0; i < 4; ++i)  // the long jobs first
    g3.job(wa[i], wb[i], p.wM[i], p.wN[i], p.TR, p.splits > 1 ? w + p.part[i] : wout[i],
           p.wN[i], p.splits);
  g3.job(g3.plane(p.dazr), g3.plane(p.wzrx), p.TR, Cin, 2 * Ch, dx, Cin, 1, g3.plane(p.dao),
         g3.plane(p.wox), Ch);
  err = g3.run(s);
  if (err != 0 || p.splits == 1) return err;
  for (int i = 0; i < 4; ++i) {
    const size_t n = static_cast<size_t>(p.wM[i]) * p.wN[i];
    reduce_splits<<<elementwise_blocks(n), 256, 0, s>>>(w + p.part[i], n, p.splits, wout[i]);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
