// 3xTF32 products on Hopper's tensor cores: the device and host pieces
// shared by the flash-NCE kernels (nce.cu) and the ConvGRU kernels
// (convgru.cu).
//
// An f32 operand x is split once into two TF32 planes, hi = tf32(x) and
// lo = tf32(x − hi), and a·b ≈ hi·hi + hi·lo + lo·hi is summed in f32: the
// f32 contract at three times the TF32 work.  Planes live in device memory,
// row-major with a leading dimension that is a multiple of 4 floats (TMA
// strides are multiples of 16 bytes), and reach shared memory as TMA boxes
// of up to 64 rows × 32 f32 with 128-byte swizzle, each stage of a ring
// guarded by an mbarrier.  `.tf32` wgmma takes only K-major operands, so a
// product A·Bᵀ reads both A [M, K] and B [N, K] with K contiguous.  The
// tensor cores truncate as they accumulate, so every 32-wide K chunk starts
// a fresh accumulator and the chunks are added in f32 on the CUDA cores.
// The mbarrier and TMA pieces are in tma.cuh.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int BM = 64;                  // rows of an A box (wgmma M)
constexpr int BK = 32;                  // f32 per 128-byte swizzle row
constexpr int BOX_BYTES = BM * BK * 4;  // one 64 x 32 f32 TMA box

// ---------------------------------------------------------------- device

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart.  The tile starts 1024-aligned; a
// k-step of 8 f32 (32 bytes) adds 2 to the address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int H>
__device__ __forceinline__ void reg_fence(float (&d)[H]) {
#pragma unroll
  for (int i = 0; i < H; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC16(d)                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define ACC32(d)                                                                              \
  ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),     \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define D32                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define ACC64(d)                                                                              \
  ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),     \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])
#define D64                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x N] = A[64 x 8] · B[N x 8]ᵀ + (accumulate ? d : 0), both from
// shared memory; N = 2H (128 with 64 accumulator registers, 64 with 32,
// 32 with 16).
// Lane (g = lane/4, t = lane%4) of warp w holds d[4j + 2h + e] = (row
// 16w + g + 8h, column 8j + 2t + e).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32 ", %32, %33, p, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D64 ", %64, %65, p, 1, 1;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " D16 ", %16, %17, p, 1, 1;\n}\n"
      : ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 8] · B[64 x 8]ᵀ, A from registers: warp w of the
// warpgroup holds rows 16w..16w+15, and lane (g = lane/4, t = lane%4) holds
// a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4).
__device__ __forceinline__ void mma_rs(float (&d)[32], float a0, float a1, float a2, float a3,
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "l"(db), "r"(1));
}

// acc = hi·hi + hi·lo + lo·hi of one 32-wide K chunk (A tile hi/lo at a_hi,
// a_lo, B tile at b_hi, b_lo: shared addresses), started fresh: the tensor
// cores truncate as they accumulate, so the caller adds the chunks in f32
// and no chain of TF32 accumulations is longer than 12.
template <int H>
__device__ __forceinline__ void score_chunk(float (&acc)[H], uint32_t a_hi, uint32_t a_lo,
                                            uint32_t b_hi, uint32_t b_lo) {
  const uint64_t dah = desc_sw128(a_hi), dal = desc_sw128(a_lo);
  const uint64_t dbh = desc_sw128(b_hi), dbl = desc_sw128(b_lo);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mma_ss(acc, dah + 2 * j, dbh + 2 * j, j > 0);
    mma_ss(acc, dah + 2 * j, dbl + 2 * j, 1);
    mma_ss(acc, dal + 2 * j, dbh + 2 * j, 1);
  }
}

// Position of column c of a group of 8 in the permuted transposed planes:
// the A fragment's K position p holds accumulator column sigma(p) = 2p
// (p < 4) or 2(p − 4) + 1, so column c sits at its inverse.
__device__ __forceinline__ int sigma8(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

// Splits x [n, D] (row-major, contiguous) into hi/lo planes [n, ld] (when
// hi is given) and, when hiT is given, the transposed planes [D, ldT]
// (positions n..ldT−1 zero), with the columns of each group of 8 permuted
// by sigma8 when kPermute.  Block (32, 8) per 32 x 32 tile.
template <bool kPermute>
__global__ void split_kernel(const float* __restrict__ x, int n, int D, float* __restrict__ hi,
                             float* __restrict__ lo, int ld, float* __restrict__ hiT,
                             float* __restrict__ loT, int ldT) {
  __shared__ float th[32][33], tl[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * 32, d0 = blockIdx.x * 32;
  for (int k = ty; k < 32; k += 8) {
    const int i = i0 + k, d = d0 + tx;
    const bool in = i < n && d < D;
    const float v = in ? x[static_cast<size_t>(i) * D + d] : 0.f;
    const float h = tf32_rna(v), l = tf32_rna(v - h);
    if (in && hi != nullptr) {
      hi[static_cast<size_t>(i) * ld + d] = h;
      lo[static_cast<size_t>(i) * ld + d] = l;
    }
    th[k][tx] = h;
    tl[k][tx] = l;
  }
  if (hiT == nullptr) return;
  __syncthreads();
  const int q = i0 + tx, src = kPermute ? (tx & ~7) + sigma8(tx & 7) : tx;
  for (int k = ty; k < 32; k += 8) {
    const int d = d0 + k;
    if (d < D && q < ldT) {
      hiT[static_cast<size_t>(d) * ldT + q] = th[src][k];
      loT[static_cast<size_t>(d) * ldT + q] = tl[src][k];
    }
  }
}

// out[i] = Σ_k part[k][i], k in split order.
__global__ void reduce_splits(const float* __restrict__ part, size_t n, int splits,
                              float* __restrict__ out) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < splits; ++k) v += part[k * n + i];
    out[i] = v;
  }
}

// A ring of kStages stages of kStageBytes in dynamic shared memory, each
// guarded by one mbarrier; q counts stages from the start of the kernel.
template <int kStages, int kStageBytes>
struct Ring {
  uint32_t base;      // shared address of stage 0, 1024-aligned
  uint64_t* full;     // one mbarrier per stage

  __device__ uint32_t stage(int q) const { return base + (q % kStages) * kStageBytes; }
  __device__ uint32_t bar(int q) const { return smem_u32(&full[q % kStages]); }
  __device__ void wait(int q) const { mbar_wait(bar(q), (q / kStages) & 1); }
};

template <int kStages, int kStageBytes>
__device__ __forceinline__ Ring<kStages, kStageBytes> make_ring(uint8_t* dyn, uint64_t* full) {
  Ring<kStages, kStageBytes> r{(smem_u32(dyn) + 1023u) & ~1023u, full};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// ------------------------------------------------------------------ host

// Map of a row-major f32 plane [outer, inner] with leading dimension ld,
// loaded in boxes of box_rows rows x 32 columns with 128-byte swizzle;
// reads past inner or outer return zeros.
bool make_map(CUtensorMap* map, const float* base, int inner, int outer, int ld,
              int box_rows = BM) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)}, elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
inline size_t align64(size_t x) { return (x + 63) / 64 * 64; }  // 256 bytes

}  // namespace
