// tensor_core.cuh - the tensor-core pieces that nm_structured.cu (#12) and
// block_ell.cu (#13) share:
//
//   swizzle128_desc  a wgmma shared-memory descriptor of a tile in the
//       128-byte swizzle (16-byte chunk c of a 128-byte row r at chunk
//       c ^ (r % 8), 1024-byte aligned groups of eight rows);
//   wgmma_k16        d[64 x N] += A[64 x 16] . X[16 x N] in bf16 with fp32
//       sums, A K-major and X MN-major, N = 128 or 256; wgmma_k32_s8 the
//       int8 product with int32 sums, both operands K-major (8-bit wgmma
//       takes no transposed operand), N = 128;
//   pin, wait_steps  keep the compiler from moving the accumulators of an
//       asynchronous wgmma, and wait for its groups;
//   mma_tf32, split_tf32, step_tf32  3xTF32 on mma.sync m16n8k8: each fp32
//       operand split into a tf32 pair (hi = tf32(a), lo = tf32(a - hi)),
//       a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed into fresh registers over
//       one depth step, then added into the accumulators in fp32, so the
//       tensor cores' truncating accumulation never spans the whole depth.
//
// Everything is internal to the library that includes it (an unnamed
// namespace, as gather_common.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {
namespace {

// Start address, leading and stride byte offsets, swizzle mode 1 (128 B).
// A K-major tile [rows][128 bytes]: leading 16 (unused), stride 1024 (eight
// 128-byte rows).  An MN-major bf16 X stage of [64][64] blocks: leading
// 8192 (from one 64-column block to the next), stride 1024.
__device__ __forceinline__ uint64_t swizzle128_desc(const void* tile, uint32_t lead) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(tile));
  return ((a & 0x3FFFF) >> 4) | (uint64_t{lead >> 4} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

// d[64 x N of the warpgroup] += A[64 x 16] (K-major, descriptor a) .
// X[16 x N] (MN-major, descriptor b; the last immediate transposes it);
// asynchronous.  N = 128 or 256.
__device__ __forceinline__ void wgmma_k16(float (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_k16(float (&d)[32][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 128 of the warpgroup] += A[64 x 32] . X[32 x 128], int8 operands
// with exact int32 sums; A and X both K-major (descriptors a and b);
// asynchronous.
__device__ __forceinline__ void wgmma_k32_s8(int (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving the accumulators that an asynchronous
// wgmma reads and writes.
template <int NJ>
__device__ __forceinline__ void pin(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}
template <int NJ>
__device__ __forceinline__ void pin(int (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[j][i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's wgmma groups are in flight.
template <int N, typename T, int NJ>
__device__ __forceinline__ void wait_steps(T (&acc)[NJ][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  pin(acc);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v as a tf32 pair: hi = tf32(v), lo = tf32(v - hi), both rounded to nearest.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// One depth step (BK columns of A, rows of X) of a warp tile of MT m16 by
// NT n8 mma tiles by 3xTF32 into fresh registers, then added into acc in
// fp32.  A [rows][LDA] and X [BK][LDB] in shared memory, fp32; the warp
// tile's first row is wm * MT * 16 and its first column wn * NT * 8.
template <int MT, int NT, int LDA, int LDB, int BK>
__device__ __forceinline__ void step_tf32(float (&acc)[MT][NT][4], const float* A,
                                          const float* X, int wm, int wn, int lane) {
  const int g = lane / 4, t = lane % 4;
  float part[MT][NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = A + (wm * MT * 16 + mt * 16 + g) * LDA + kk + t;
      split_tf32(p[0], ah[mt][0], al[mt][0]);
      split_tf32(p[8 * LDA], ah[mt][1], al[mt][1]);
      split_tf32(p[4], ah[mt][2], al[mt][2]);
      split_tf32(p[8 * LDA + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* q = X + (kk + t) * LDB + wn * NT * 8 + nt * 8 + g;
      split_tf32(q[0], bh[nt][0], bl[nt][0]);
      split_tf32(q[4 * LDB], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(part[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
        mma_tf32(part[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
        mma_tf32(part[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

}  // namespace
}  // namespace tc
