// Flash-NCE for Hopper: K5 (forward, `nce_fwd`) and K6 (backward, `nce_bwd`)
// on the tensor cores.
//
// Replaces dpc_tpu/ops/nce_pallas.py: `_fwd_kernel` (forward, pallas_call
// at :97) and `_bwd_fused_kernel` / `_bwd_rows_kernel` / `_bwd_cols_kernel`
// (backward, pallas_calls at :224, :272, :291).  Neither direction writes
// the [R, C] score matrix to device memory.
//
// What bounds it on this card: the products, 2·R·C·D multiply-adds forward
// and three times that backward.  The contract is f32 (the TPU kernels
// compute in f32), and one TF32 pass loses the gradient tolerance, so every
// product runs as 3xTF32 on the tensor cores: x = hi + lo with
// hi = tf32(x), lo = tf32(x − hi), and a·b ≈ hi·hi + hi·lo + lo·hi in f32.
// That is 3 × 2·R·C·D TF32 operations forward (0.029 ms at R = C = 3072,
// D = 256 against 495 TFLOP/s) and 3 × 6·R·C·D backward (0.088 ms); the
// 6 MB of inputs take 0.002 ms, so the bound is the tensor cores.  The
// tensor cores truncate as they accumulate, an error that grows with the
// length of the chain, so each 32-wide D chunk of a score tile starts a
// fresh accumulator and the chunks are added in f32 on the CUDA cores.
//
// Design:
//  * A prep pass splits each operand once into hi/lo planes in scratch
//    (12 MB forward, 24 MB backward at the flagship, all L2-resident), so
//    TMA loads them as they are and the main loops convert nothing.  The
//    split on the way into shared memory would need every thread to read,
//    convert and store each tile, which is the work TMA exists to take off
//    the threads.  The backward's prep also writes the transposed planes
//    rowsᵀ [D, R] and colsᵀ [D, C]: P·cols has the column index as its K,
//    and `.tf32` wgmma takes only K-major operands (its transpose bits are
//    for 16-bit types), so colsᵀ is the K-major B of that product.
//  * One warpgroup per block runs `wgmma.m64n64k8.f32.tf32.tf32`.  Tiles
//    arrive by TMA (128-byte swizzle, boxes of 64 rows × 32 f32) in a ring
//    of NST stages of 32 KB, each guarded by an mbarrier; thread 0 keeps
//    NST − 1 stages in flight.  97 KB a block, so two blocks share an SM.
//    TMA fills out-of-range rows and columns with zeros, so ragged R, C
//    and any D need no padding in memory; the epilogues mask by index.
//  * Forward: the column tiles are split across blocks (flash-decoding):
//    a grid of (R/64) × S, S picked for the fewest waves of two blocks an
//    SM times column tiles a block (48 × 5 at the flagship).  Each block keeps an online (max, sum, rank count) per row
//    on the accumulator registers, reduced across the four threads of a
//    row by shuffles, and writes them as partials; a second kernel merges
//    the S partials of each row in split order.  `pos` comes in from
//    outside, and the target column is excluded from the rank by index,
//    never by comparing it with itself.
//  * Backward: one launch, `blockIdx` picking the sweep.  A drows block
//    owns a 64-row tile at a 256-wide slice of D (the whole D up to 256;
//    D = 1024 takes four slices, each recomputing the score), so its
//    accumulator is 64 × 256 f32, 128 registers a thread.  It computes each
//    64 × 64 score tile once, turns it into P = exp(S − lse)·g in registers,
//    splits P into hi/lo and feeds them straight from the accumulator
//    registers as wgmma's A operand: the accumulator holds P[g][2t], P[g][2t+1]
//    where the A fragment wants P[g][t], P[g][t+4], so the K order within
//    each group of 8 columns is permuted instead of the registers, and the
//    prep pass writes the transposed planes with the same permutation.  The
//    dcols blocks do the same with rows and columns swapped.  The other
//    dimension is split across blocks to fill the SMs, each split writing
//    its own partial sum; a reduce kernel adds them in split order.  No
//    atomics: the result does not depend on scheduling.
#include <algorithm>

#include "tf32_wgmma.cuh"

namespace {

constexpr int BN = 64;                       // columns of a score tile
constexpr int STAGE_BYTES = 4 * BOX_BYTES;   // four boxes a stage
constexpr int NST = 3;                       // stages in the ring
constexpr int NT = 128;                      // one warpgroup
constexpr int DS = 256;                      // D a backward block accumulates
constexpr int SMEM_BYTES = NST * STAGE_BYTES + 1024;  // + 1024-byte alignment

// ---------------------------------------------------------------- device

// The score tile's chunk: acc holds it, sum gathers the chunks in f32.
__device__ __forceinline__ void score_stage(float (&acc)[32], float (&sum)[32], uint32_t st,
                                            bool first) {
  wg_fence();
  reg_fence(acc);
  score_chunk(acc, st, st + BOX_BYTES, st + 2 * BOX_BYTES, st + 3 * BOX_BYTES);
  wg_commit();
  wg_wait0();
  reg_fence(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = first ? acc[i] : sum[i] + acc[i];
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}


// Column tiles [tb, te) of split s out of `splits` over n columns.
__device__ __forceinline__ void split_range(int n, int s, int splits, int& tb, int& te) {
  const int nt = (n + BN - 1) / BN;
  tb = s * nt / splits;
  te = (s + 1) * nt / splits;
}

// Forward: block (row tile, split) writes per-row partial (max, sum, count)
// over its column tiles to part[0|1|2][split][row].
__global__ void __launch_bounds__(NT, 2)
    nce_fwd_kernel(const __grid_constant__ CUtensorMap rows_hi,
                   const __grid_constant__ CUtensorMap rows_lo,
                   const __grid_constant__ CUtensorMap cols_hi,
                   const __grid_constant__ CUtensorMap cols_lo, const float* __restrict__ pos,
                   const int* __restrict__ targets, float* __restrict__ part, int R, int C,
                   int D, int splits) {
  __shared__ uint64_t full[NST];
  extern __shared__ uint8_t dyn[];
  const auto ring = make_ring<NST, STAGE_BYTES>(dyn, full);
  const int tid = threadIdx.x, w = tid / 32, gq = (tid % 32) / 4, t = tid % 4;
  const int a0 = blockIdx.x * BM, split = blockIdx.y;
  int tb, te;
  split_range(C, split, splits, tb, te);
  const int nkd = (D + BK - 1) / BK, total = (te - tb) * nkd;

  auto load_stage = [&](int q) {
    const int b0 = (tb + q / nkd) * BN, x = (q % nkd) * BK;
    const uint32_t dst = ring.stage(q), bar = ring.bar(q);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(dst, &rows_hi, x, a0, bar);
    tma_load(dst + BOX_BYTES, &rows_lo, x, a0, bar);
    tma_load(dst + 2 * BOX_BYTES, &cols_hi, x, b0, bar);
    tma_load(dst + 3 * BOX_BYTES, &cols_lo, x, b0, bar);
  };
  if (tid == 0)
    for (int q = 0; q < NST - 1 && q < total; ++q) load_stage(q);

  float m[2], s[2], cnt[2], p[2];
  int tg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = a0 + 16 * w + gq + 8 * h;
    p[h] = r < R ? pos[r] : 0.f;
    tg[h] = r < R ? targets[r] : -1;
    m[h] = -INFINITY;
    s[h] = 0.f;
    cnt[h] = 0.f;
  }

  float acc[32], sc[32];
  for (int q = 0; q < total; ++q) {
    if (tid == 0 && q + NST - 1 < total) load_stage(q + NST - 1);
    const int kc = q % nkd;
    ring.wait(q);
    score_stage(acc, sc, ring.stage(q), kc == 0);
    if (kc == nkd - 1) {
      // sc[4j + 2h + e] = S[row 16w + gq + 8h, column 8j + 2t + e]
      const int b0 = (tb + q / nkd) * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (b0 + 8 * j + 2 * t + e < C) tmax = fmaxf(tmax, sc[4 * j + 2 * h + e]);
        // column b0 is always valid, so the tile max is finite
        const float mn = fmaxf(m[h], quad_max(tmax));
        float ps = 0.f, pc = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = b0 + 8 * j + 2 * t + e;
            const float v = sc[4 * j + 2 * h + e];
            if (c < C) {
              ps += expf(v - mn);
              if (v > p[h] && c != tg[h]) pc += 1.f;
            }
          }
        s[h] = s[h] * expf(m[h] - mn) + quad_sum(ps);
        m[h] = mn;
        cnt[h] += quad_sum(pc);
      }
    }
    __syncthreads();  // every wgmma of stage q is done: its slot may refill
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = a0 + 16 * w + gq + 8 * h;
      if (r < R) {
        const size_t o = static_cast<size_t>(split) * R + r, plane = static_cast<size_t>(splits) * R;
        part[o] = m[h];
        part[plane + o] = s[h];
        part[2 * plane + o] = cnt[h];
      }
    }
  }
}

// Merges the partials of each row in split order.
__global__ void nce_fwd_combine(const float* __restrict__ part, int R, int splits,
                                float* __restrict__ lse, float* __restrict__ rank) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t plane = static_cast<size_t>(splits) * R;
  float mx = -INFINITY;
  for (int k = 0; k < splits; ++k) mx = fmaxf(mx, part[static_cast<size_t>(k) * R + r]);
  float sum = 0.f, cnt = 0.f;
  for (int k = 0; k < splits; ++k) {
    const size_t o = static_cast<size_t>(k) * R + r;
    sum += part[plane + o] * expf(part[o] - mx);
    cnt += part[2 * plane + o];
  }
  lse[r] = logf(sum) + mx;
  rank[r] = cnt;
}

struct BwdMaps {
  CUtensorMap rows_hi, rows_lo, cols_hi, cols_lo;      // [n, D], K-major
  CUtensorMap rowsT_hi, rowsT_lo, colsT_hi, colsT_lo;  // [D, n], K order permuted
};

// Backward: blocks [0, nA) accumulate drows (own = rows, other = cols),
// the rest dcols (own = cols, other = rows).  Each block owns a 64-row
// tile of its output at a DS-wide slice of D and one split of the other
// dimension, and writes dst[split] = Σ over its other tiles of P·other.
__global__ void __launch_bounds__(NT, 2)
    nce_bwd_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                   const float* __restrict__ g, float* __restrict__ drows_dst,
                   float* __restrict__ dcols_dst, int R, int C, int D, int splits_r,
                   int splits_c, int nds) {
  __shared__ uint64_t full[NST];
  extern __shared__ uint8_t dyn[];
  const auto ring = make_ring<NST, STAGE_BYTES>(dyn, full);
  const int tid = threadIdx.x, w = tid / 32, gq = (tid % 32) / 4, t = tid % 4;

  const int tiles_r = (R + BM - 1) / BM, n_a = tiles_r * splits_r * nds;
  const bool rows_sweep = static_cast<int>(blockIdx.x) < n_a;
  const int b = rows_sweep ? blockIdx.x : blockIdx.x - n_a;
  const int splits = rows_sweep ? splits_r : splits_c;
  const int a0 = b / (splits * nds) * BM, split = b % (splits * nds) / nds;
  const int d0 = b % nds * DS;
  const int n_own = rows_sweep ? R : C, n_other = rows_sweep ? C : R;
  const CUtensorMap* own_hi = rows_sweep ? &maps.rows_hi : &maps.cols_hi;
  const CUtensorMap* own_lo = rows_sweep ? &maps.rows_lo : &maps.cols_lo;
  const CUtensorMap* oth_hi = rows_sweep ? &maps.cols_hi : &maps.rows_hi;
  const CUtensorMap* oth_lo = rows_sweep ? &maps.cols_lo : &maps.rows_lo;
  const CUtensorMap* othT_hi = rows_sweep ? &maps.colsT_hi : &maps.rowsT_hi;
  const CUtensorMap* othT_lo = rows_sweep ? &maps.colsT_lo : &maps.rowsT_lo;
  float* dst = (rows_sweep ? drows_dst : dcols_dst) + static_cast<size_t>(split) * n_own * D;

  int tb, te;
  split_range(n_other, split, splits, tb, te);
  const int nkd = (D + BK - 1) / BK;
  const int ng = min(DS, D - d0 + 63) / 64;  // 64-wide column groups of dst
  const int npair = (ng + 1) / 2;            // P stages per 32 columns of P
  const int spt = nkd + 2 * npair;           // stages per other tile
  const int total = (te - tb) * spt;

  auto load_stage = [&](int q) {
    const int b0 = (tb + q / spt) * BN, sub = q % spt;
    const uint32_t dst_s = ring.stage(q), bar = ring.bar(q);
    if (sub < nkd) {
      const int x = sub * BK;
      mbar_expect_tx(bar, STAGE_BYTES);
      tma_load(dst_s, own_hi, x, a0, bar);
      tma_load(dst_s + BOX_BYTES, own_lo, x, a0, bar);
      tma_load(dst_s + 2 * BOX_BYTES, oth_hi, x, b0, bar);
      tma_load(dst_s + 3 * BOX_BYTES, oth_lo, x, b0, bar);
      return;
    }
    const int pp = sub - nkd, x = b0 + (pp / npair) * BK, gp = pp % npair;
    const int groups = x < n_other ? min(2, ng - 2 * gp) : 0;
    mbar_expect_tx(bar, groups * 2 * BOX_BYTES);
    for (int k = 0; k < groups; ++k) {
      const int y = d0 + 64 * (2 * gp + k);
      tma_load(dst_s + 2 * k * BOX_BYTES, othT_hi, x, y, bar);
      tma_load(dst_s + (2 * k + 1) * BOX_BYTES, othT_lo, x, y, bar);
    }
  };
  if (tid == 0)
    for (int q = 0; q < NST - 1 && q < total; ++q) load_stage(q);

  float l_own[2], g_own[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = a0 + 16 * w + gq + 8 * h;
    l_own[h] = rows_sweep && a < n_own ? lse[a] : 0.f;
    g_own[h] = rows_sweep && a < n_own ? g[a] : 0.f;
  }

  float out[4][32];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) out[k][i] = 0.f;
  float acc[32], sc[32], phi[32], plo[32];

  for (int q = 0; q < total; ++q) {
    if (tid == 0 && q + NST - 1 < total) load_stage(q + NST - 1);
    const int b0 = (tb + q / spt) * BN, sub = q % spt;
    const uint32_t st = ring.stage(q);
    if (sub < nkd) {
      ring.wait(q);
      score_stage(acc, sc, st, sub == 0);
      if (sub == nkd - 1) {
        // P = exp(S − lse)·g with lse, g of the score row: the own row in
        // the drows sweep, the other index in the dcols sweep
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = b0 + 8 * j + 2 * t + e;
            const bool o_in = o < n_other;
            const float l_o = !rows_sweep && o_in ? lse[o] : 0.f;
            const float g_o = !rows_sweep && o_in ? g[o] : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int a = a0 + 16 * w + gq + 8 * h, i = 4 * j + 2 * h + e;
              float pv = 0.f;
              if (o_in && a < n_own)
                pv = rows_sweep ? expf(sc[i] - l_own[h]) * g_own[h] : expf(sc[i] - l_o) * g_o;
              phi[i] = tf32_rna(pv);
              plo[i] = tf32_rna(pv - phi[i]);
            }
          }
      }
    } else {
      const int pp = sub - nkd, kk = pp / npair, gp = pp % npair;
      ring.wait(q);
      if (b0 + kk * BK < n_other) {
        wg_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) reg_fence(out[k]);
        // kc is the run-time kk spelled as a constant, so that phi and plo
        // are indexed at compile time and stay in registers
#pragma unroll
        for (int kc = 0; kc < BN / BK; ++kc) {
          if (kc != kk) continue;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            // K step jt of P: A fragment (g, t), (g+8, t), (g, t+4),
            // (g+8, t+4) is accumulator column 2t, 2t (row g+8), 2t+1,
            // 2t+1 (row g+8)
            const int i = 4 * (4 * kc + j);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k / 2 != gp || k >= ng) continue;
              const uint32_t bt = st + 2 * (k - 2 * gp) * BOX_BYTES;
              const uint64_t dh = desc_sw128(bt) + 2 * j;
              const uint64_t dl = desc_sw128(bt + BOX_BYTES) + 2 * j;
              mma_rs(out[k], phi[i], phi[i + 2], phi[i + 1], phi[i + 3], dh);
              mma_rs(out[k], phi[i], phi[i + 2], phi[i + 1], phi[i + 3], dl);
              mma_rs(out[k], plo[i], plo[i + 2], plo[i + 1], plo[i + 3], dh);
            }
          }
        }
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int k = 0; k < 4; ++k) reg_fence(out[k]);
        reg_fence(phi);  // the A operand stays put until the wgmmas are done
        reg_fence(plo);
      }
    }
    __syncthreads();  // every wgmma of stage q is done: its slot may refill
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= ng) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = a0 + 16 * w + gq + 8 * h, d = d0 + 64 * k + 8 * j + 2 * t + e;
          if (a < n_own && d < D) dst[static_cast<size_t>(a) * D + d] = out[k][4 * j + 2 * h + e];
        }
  }
}

// ------------------------------------------------------------------ host

// Splits of the other dimension (n_other columns) when each split has
// `own_blocks` blocks: the fewest that minimise waves × (column tiles per
// block + 1/2 for the block's fill and store), two blocks resident per SM.
// At most MAX_SPLITS, which bounds the partial sums' scratch.
constexpr int MAX_SPLITS = 16;

int pick_splits(int own_blocks, int n_other) {
  const int tiles = (n_other + BN - 1) / BN;
  const long long slots = 2 * sm_count();
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= tiles && s <= MAX_SPLITS; ++s) {
    const long long waves = (static_cast<long long>(own_blocks) * s + slots - 1) / slots;
    const long long cost = waves * (2 * ((tiles + s - 1) / s) + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// The backward's splits: drows blocks split the column tiles, dcols blocks
// the row tiles, and both sweeps run in one grid that ends with its
// longest block, so the two are picked together: the fewest waves × (the
// longest block's tiles + 1/2), ties to fewer blocks.  Picking each alone
// left the dcols blocks of a candidate shard (R = 2C) twice as long as the
// drows blocks.
void pick_bwd_splits(int tiles_r, int tiles_c, int nds, int& splits_r, int& splits_c) {
  const long long slots = 2 * sm_count();
  long long best_cost = -1, best_blocks = 0;
  for (int sr = 1; sr <= tiles_c && sr <= MAX_SPLITS; ++sr)
    for (int sc = 1; sc <= tiles_r && sc <= MAX_SPLITS; ++sc) {
      const long long blocks =
          (static_cast<long long>(tiles_r) * sr + static_cast<long long>(tiles_c) * sc) * nds;
      const long long waves = (blocks + slots - 1) / slots;
      const int longest = std::max((tiles_c + sr - 1) / sr, (tiles_r + sc - 1) / sc);
      const long long cost = waves * (2 * longest + 1);
      if (best_cost < 0 || cost < best_cost || (cost == best_cost && blocks < best_blocks)) {
        splits_r = sr;
        splits_c = sc;
        best_cost = cost;
        best_blocks = blocks;
      }
    }
}

// Scratch layout, in floats from the start of the buffer.
struct Plan {
  int splits_r = 1, splits_c = 1, nds = 1, ld = 0, ldr = 0, ldc = 0;
  size_t rows_hi, rows_lo, cols_hi, cols_lo, rowsT_hi, rowsT_lo, colsT_hi, colsT_lo;
  size_t part_r, part_c, total;
};

Plan plan(int R, int C, int D, bool backward) {
  Plan p;
  p.ld = round_up(D, 4);  // TMA strides are multiples of 16 bytes
  p.ldr = round_up(R, 8);
  p.ldc = round_up(C, 8);
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off = align64(off + n);
    return at;
  };
  p.rows_hi = take(static_cast<size_t>(R) * p.ld);
  p.rows_lo = take(static_cast<size_t>(R) * p.ld);
  p.cols_hi = take(static_cast<size_t>(C) * p.ld);
  p.cols_lo = take(static_cast<size_t>(C) * p.ld);
  const int tiles_r = (R + BM - 1) / BM, tiles_c = (C + BM - 1) / BM;
  if (!backward) {
    p.splits_r = pick_splits(tiles_r, C);
    p.part_r = take(3 * static_cast<size_t>(p.splits_r) * R);
  } else {
    p.rowsT_hi = take(static_cast<size_t>(D) * p.ldr);
    p.rowsT_lo = take(static_cast<size_t>(D) * p.ldr);
    p.colsT_hi = take(static_cast<size_t>(D) * p.ldc);
    p.colsT_lo = take(static_cast<size_t>(D) * p.ldc);
    p.nds = (D + DS - 1) / DS;
    pick_bwd_splits(tiles_r, tiles_c, p.nds, p.splits_r, p.splits_c);
    p.part_r = take(p.splits_r > 1 ? static_cast<size_t>(p.splits_r) * R * D : 0);
    p.part_c = take(p.splits_c > 1 ? static_cast<size_t>(p.splits_c) * C * D : 0);
  }
  p.total = off;
  return p;
}

int split_into(const float* x, int n, int D, float* hi, float* lo, int ld, float* hiT,
               float* loT, int ldT, cudaStream_t s) {
  const dim3 grid((D + 31) / 32, (n + 31) / 32), block(32, 8);
  split_kernel<true><<<grid, block, 0, s>>>(x, n, D, hi, lo, ld, hiT, loT, ldT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch that nce_fwd / nce_bwd need for these sizes.
long long nce_fwd_scratch_floats(int R, int C, int D) {
  return static_cast<long long>(plan(R, C, D, false).total);
}

long long nce_bwd_scratch_floats(int R, int C, int D) {
  return static_cast<long long>(plan(R, C, D, true).total);
}

// lse[r] = logsumexp_c(rows[r]·cols[c]); rank[r] = #{c != targets[r] :
// rows[r]·cols[c] > pos[r]}.  All pointers are device memory, f32 except
// targets (int32), row-major and contiguous; scratch holds
// nce_fwd_scratch_floats(R, C, D) floats.
int nce_fwd(const float* rows, const float* cols, const float* pos, const int* targets,
            float* lse, float* rank, float* scratch, long long scratch_floats, int R, int C, int D,
            void* stream) {
  if (R <= 0 || C <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(R, C, D, false);
  if (scratch_floats < static_cast<long long>(p.total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = scratch;
  int err = split_into(rows, R, D, w + p.rows_hi, w + p.rows_lo, p.ld, nullptr, nullptr, 0, s);
  if (err == 0)
    err = split_into(cols, C, D, w + p.cols_hi, w + p.cols_lo, p.ld, nullptr, nullptr, 0, s);
  if (err != 0) return err;
  CUtensorMap m[4];
  if (!make_map(&m[0], scratch + p.rows_hi, D, R, p.ld) ||
      !make_map(&m[1], scratch + p.rows_lo, D, R, p.ld) ||
      !make_map(&m[2], scratch + p.cols_hi, D, C, p.ld) ||
      !make_map(&m[3], scratch + p.cols_lo, D, C, p.ld))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(nce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((R + BM - 1) / BM, p.splits_r);
  nce_fwd_kernel<<<grid, NT, SMEM_BYTES, s>>>(m[0], m[1], m[2], m[3], pos, targets,
                                              scratch + p.part_r, R, C, D, p.splits_r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nce_fwd_combine<<<(R + 255) / 256, 256, 0, s>>>(scratch + p.part_r, R, p.splits_r, lse, rank);
  return static_cast<int>(cudaGetLastError());
}

// drows = P·cols and dcols = Pᵀ·rows with P = exp(rows·colsᵀ − lse)·g;
// scratch holds nce_bwd_scratch_floats(R, C, D) floats.
int nce_bwd(const float* rows, const float* cols, const float* lse, const float* g, float* drows,
            float* dcols, float* scratch, long long scratch_floats, int R, int C, int D,
            void* stream) {
  if (R <= 0 || C <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(R, C, D, true);
  if (scratch_floats < static_cast<long long>(p.total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = scratch;
  int err = split_into(rows, R, D, w + p.rows_hi, w + p.rows_lo, p.ld, w + p.rowsT_hi,
                       w + p.rowsT_lo, p.ldr, s);
  if (err == 0)
    err = split_into(cols, C, D, w + p.cols_hi, w + p.cols_lo, p.ld, w + p.colsT_hi,
                     w + p.colsT_lo, p.ldc, s);
  if (err != 0) return err;
  BwdMaps m;
  if (!make_map(&m.rows_hi, scratch + p.rows_hi, D, R, p.ld) ||
      !make_map(&m.rows_lo, scratch + p.rows_lo, D, R, p.ld) ||
      !make_map(&m.cols_hi, scratch + p.cols_hi, D, C, p.ld) ||
      !make_map(&m.cols_lo, scratch + p.cols_lo, D, C, p.ld) ||
      !make_map(&m.rowsT_hi, scratch + p.rowsT_hi, p.ldr, D, p.ldr) ||
      !make_map(&m.rowsT_lo, scratch + p.rowsT_lo, p.ldr, D, p.ldr) ||
      !make_map(&m.colsT_hi, scratch + p.colsT_hi, p.ldc, D, p.ldc) ||
      !make_map(&m.colsT_lo, scratch + p.colsT_lo, p.ldc, D, p.ldc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(nce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* dr = p.splits_r > 1 ? scratch + p.part_r : drows;
  float* dc = p.splits_c > 1 ? scratch + p.part_c : dcols;
  const int blocks = ((R + BM - 1) / BM * p.splits_r + (C + BM - 1) / BM * p.splits_c) * p.nds;
  nce_bwd_kernel<<<blocks, NT, SMEM_BYTES, s>>>(m, lse, g, dr, dc, R, C, D, p.splits_r,
                                                p.splits_c, p.nds);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.splits_r > 1)
    reduce_splits<<<264, 256, 0, s>>>(dr, static_cast<size_t>(R) * D, p.splits_r, drows);
  if (p.splits_c > 1)
    reduce_splits<<<264, 256, 0, s>>>(dc, static_cast<size_t>(C) * D, p.splits_c, dcols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
