// sddmm.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/sddmm.py, the gradients of Y = A(v) . X over a fixed
// span pattern with trainable values v:
//   sddmm_launch    replaces _sddmm_kernel (sddmm.py:72), the value gradient;
//   dx_walk_launch  replaces _dx_kernel    (sddmm.py:167), the input gradient.
//
// Function.  The format is the JAX package's SpanFormat (span_gather.cu):
// c0 [P,1,NC] each chunk's window start, cols [P,NC,G] a slot's column
// within the window, lrow [P,NC,G] its program-local row, nc_p [P] the real
// chunk count of each program.  dY_slots [P*rb, Kp] is dY in slot order
// (row p*rb + lrow of a slot is the slot's row of Y), X [N, Kp], both fp32,
// Kp a multiple of 4.  For program p, chunk j < nc_p[p], slot s, with
// col = c0[p,j] + cols[p,j,s] and row = p*rb + lrow[p,j,s]:
//   sddmm:  dv[p,j,s]   = sum_k dY_slots[row, k] * X[col, k]
//           (every slot of a walked chunk, padding too: the caller masks it
//           with occupancy_mask; slots of chunks past nc_p, and a column
//           past X, get 0 from the caller's zeroed dv);
//   dx:     dX[col, k] += vals[p,j,s] * dY_slots[row, k]
//           (slots whose value is not zero), dX [N, Kp] written whole.
// The TPU gathered both rows with one-hot MXU dots (_gather_rows) and ran a
// grid of K-tiles that added into one resident block; here the K-tiles are
// a loop inside the kernel.
//
// Precision.  fp32 and fp32x2: sddmm's tile kernel runs 3xTF32 (each
// operand split into a tf32 pair, three products, each depth step of 32
// summed in fresh registers and added in fp32: fp32's class), its per-slot
// kernel fp32 FMAs.  bf16: as the TPU kernels' bf16 operands, sddmm rounds
// X and dY to bf16 before each product (exact in fp32) and sums in fp32
// (bf16 mma with fp32 sums in the tile kernel); dx rounds dY to bf16 and
// then each product v * dY to bf16 before it is added (in fp32).
//
// Design of sddmm: staged tiles of the sampled product.  The wrapper cuts
// the (dY_slots row, X column) space into tiles of kBM x kBN and lists,
// once per pattern, every walked slot by tile (kernels/sddmm.py,
// sddmm_tiles: the slot's row, column and flat index, 12 bytes a slot),
// the tiles that hold the most slots first, each with its range in the
// lists.  The T tiles that hold at least the mode's threshold of slots are
// then a prefix of the tiles, their D slots a prefix of the lists.
//   sddmm_tf32_tile_kernel (fp32) and sddmm_bf16_tile_kernel: one block of
//   256 threads per dense tile, two an SM.  The tile's kBM rows of dY and
//   kBN rows of X are staged in shared memory kBK columns at a time by
//   cp.async, three stages deep, and multiplied on the tensor cores: in
//   fp32 each landed stage is split into tf32 pairs in shared memory and
//   each of two warpgroups runs wgmma (m64n64k8, both operands K-major in
//   the 128-byte swizzle) three times a depth step; in bf16 eight warps
//   run mma.sync m16n8k16 on pairs rounded as they are loaded.  The kBM x
//   kBN product is then written to shared memory and each of the tile's
//   slots reads its entry.  Each operand row comes from L2 once per tile
//   and K-slice instead of once per slot that needs it (about 800 slots a
//   tile at the 90 % pruned 4096^2 weight, whose dY rows the kernel this
//   replaces read 3.4 GB of a launch).
//   sddmm_slot_kernel: the other slots, flat in tile order, each served by
//   tps lanes of one warp (a power of two up to 32, as many as the row has
//   float4s) that read its dY and X rows, take the dot product and reduce
//   it by warp shuffles.  A dense tile costs kBM * kBN * Kp products
//   whatever it holds; below the threshold the per-slot dots cost less.
// A pattern with tiles of both kinds takes one launch of each; one kind,
// one launch.
//
// Design of dx: a column walk over staged windows of dY.  dX = A^T . dY
// reads each slot's dY row once per column of K it serves; the kernel this
// replaces (one block per chunk, each slot's row read from L2, runs of equal
// columns added by scalar fp32 atomics) read 2 KB a slot at the pruned
// 4096^2 weight, K = 512: 3.4 GB from L2 a launch, 0.40 ms at about the L2's
// rate, at 6 % of the operations' bound.  Here the wrapper lists every walked
// slot once per pattern (kernels/sddmm.py, dx_index: a slot's row and flat
// index, 8 bytes a slot), by tile of kDxCols columns of A (rows of dX), in a
// tile by window of kDxRows rows of dY_slots, in a window by column, then row.
// A window that holds at least the index's threshold of slots (kDxRows by
// default) is staged; its slots are cut into pieces of at most kDxPiece (in
// row order: a row may hold many slots of one column, a chunk's padding),
// each with its first dY row, its range in the lists and each column's range
// within it.  The other slots of a tile, the sparse windows',
// are listed by column, then row, apart from the pieces.
//   dx_prep_kernel: each listed slot's row beside its value, gathered once a
//   call from the caller's value plane (values change at every optimizer
//   step, the pattern does not); in bf16 also dY rounded to bf16 once.
//   dx_walk_kernel<TPS, BF16>: one block per (tile, panel of 4 * TPS columns
//   of K).  The tile's columns are dealt to groups of TPS lanes (one float4
//   of the panel a lane), CPG columns a group, by falling slot count (the
//   index's column order), and a group keeps its columns' sums in registers
//   over the whole walk.  It walks first its columns' sparse slots, each dY
//   row read from L2 (four slots' loads in flight), then the tile's pieces:
//   one more warp stages each piece's kDxRows x panel window of dY (by bulk
//   copies, the TMA: one where the panel is the whole row, else one a row),
//   its slots and its column ranges in shared memory,
//   kDxStages deep, on mbarriers that the walking warps wait on and release
//   warp by warp, so no warp waits for a slower one; a slot then costs one
//   float4 shared load and four FMAs a lane.  At the end each group writes
//   its columns' rows of dX once, plain stores: no atomics, no zero fill (a
//   block writes every column of its tile), and the same bits from run to
//   run (each column's sum in one order: its sparse slots, then the
//   pieces, rows rising).
// Bound on this card.  The operations' bound is 2 flops a slot and column of
// K (0.026 ms at the pruned weight, K = 512).  The design's own floor is
// shared memory: a slot is one 16-byte load a lane, 512 bytes a warp at 128
// bytes a clock an SM: 1.68M slots x 512 columns x 4 bytes = 3.44 GB of
// shared loads, 0.10 ms over 132 SMs at 1.98 GHz.  From L2 it reads dY once
// per tile (268 MB at that weight) and the lists once per panel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gather_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;  // sddmm_slot_kernel
constexpr int kSlotSteps = 8;  // sddmm_slot_kernel: rounds of slots a block

// The tile kernel: kBM rows of dY by kBN columns (rows of X), kBK deep a
// stage, 256 threads.
constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kTileThreads = 256;
constexpr int kStages = 3;
constexpr int kLDC = kBN + 8;  // the product's rows in shared memory (floats)
// fp32: two warpgroups, each 64 rows x 64 columns of the tile by wgmma; a
// stage is the dY rows then the X rows, 128 bytes (kBK floats) each in the
// 128-byte swizzle, split into tf32 pairs in place (hi) and into one more
// stage's room (lo).
constexpr int kSwStage = (kBM + kBN) * kBK * 4;  // 24 KB, a multiple of 1024
constexpr size_t kTf32Smem = (kStages + 1) * kSwStage + 1024;  // and 1 KB to align
// bf16: 8 warps, 4 x 2, each 32 x 32 of the tile by mma.sync m16n8k16; rows
// of kLD16 floats, whose pairs (g, 2t) at g * 40 + 2t cover the 32 banks.
constexpr int kLD16 = kBK + 8;
constexpr int kStage16 = (kBM + kBN) * kLD16;  // floats
constexpr size_t kBf16Smem = sizeof(float) * kStages * kStage16;
static_assert(kBM * kLDC * 4 <= kStages * kSwStage && kBM * kLDC <= kStages * kStage16,
              "the product fits the stages");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Threads per slot (sddmm) or per stream (dx): the largest power of two up
// to `cap` and up to the row's q4 float4s (1 for a row of one float4).
int threads_per_slot(int q4, int cap) {
  int t = 1;
  while (t * 2 <= cap && t * 2 <= q4) t *= 2;
  return t;
}

// a and b rounded to bf16 and packed as mma takes a pair (a in the low half).
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[64 x 64 of the warpgroup] (+)= A[64 x 8] . B[8 x 64], tf32 operands
// from shared memory, both K-major in the 128-byte swizzle (descriptors a,
// b), fp32 sums; accumulate false starts d afresh.  Asynchronous.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t a, uint64_t b,
                                           bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// cp.async of stage s of a tile: columns [s * kBK, s * kBK + kBK) of dY
// rows [r0, r0 + kBM) (tile rows 0..kBM-1) and of X rows [c0, c0 + kBN)
// (tile rows kBM..), 16 bytes a copy; rows past R or N and columns past Kp
// are zero-filled.  SWZ: rows of 128 bytes in the 128-byte swizzle, else
// rows of kLD16 floats.
template <bool SWZ>
__device__ __forceinline__ void stage_tile(float* st, const float* __restrict__ dy,
                                           const float* __restrict__ x, int r0, int c0, int s,
                                           int R, int N, int Kp) {
  const int k0 = s * kBK;
  for (int e = threadIdx.x; e < (kBM + kBN) * (kBK / 4); e += kTileThreads) {
    const int r = e / (kBK / 4), c = e % (kBK / 4);
    const bool is_dy = r < kBM;
    const int64_t src = is_dy ? r0 + r : c0 + (r - kBM);
    const bool valid = src < (is_dy ? R : N) && k0 + 4 * c < Kp;
    const float* from = is_dy ? dy : x;
    float* to = SWZ ? st + r * kBK + ((c ^ (r & 7)) << 2) : st + r * kLD16 + 4 * c;
    gather::cp_async<16>(to, valid ? from + src * Kp + k0 + 4 * c : from, valid);
  }
}

// The tile's product, in shared memory (c [kBM][kLDC]), sampled at the
// tile's slots [tile.z, tile.w) of the lists: slot e at (trow[e], tcol[e])
// written to dv[tslot[e]].
__device__ __forceinline__ void sample(const float* c, int4 tile, const int* __restrict__ trow,
                                       const int* __restrict__ tcol,
                                       const int* __restrict__ tslot, float* __restrict__ dv) {
  for (int e = tile.z + static_cast<int>(threadIdx.x); e < tile.w; e += kTileThreads) {
    dv[tslot[e]] = c[(trow[e] - tile.x) * kLDC + tcol[e] - tile.y];
  }
}

// Block b takes dense tile tiles[b] = (first row r0, first column c0, start,
// end): the product of dY_slots rows [r0, r0 + kBM) and X rows [c0, c0 +
// kBN) over all Kp columns (rows past R or N, columns past Kp staged as
// zeros), sampled at the slots [start, end) of the lists.  fp32 by 3xTF32
// on wgmma: each stage, once landed, is split into tf32 pairs (hi in place,
// lo beside it), then each warpgroup adds A_lo.B_hi + A_hi.B_lo + A_hi.B_hi
// over the stage's four depth steps into fresh registers, added into acc
// in fp32, so the tensor cores' accumulation never spans the whole depth.
__global__ void __launch_bounds__(kTileThreads, 2)
sddmm_tf32_tile_kernel(const int4* __restrict__ tiles, const int* __restrict__ trow,
                       const int* __restrict__ tcol, const int* __restrict__ tslot,
                       const float* __restrict__ dy, const float* __restrict__ x,
                       float* __restrict__ dv, int R, int N, int Kp) {
  uint8_t* raw = reinterpret_cast<uint8_t*>(gather::gather_smem);
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(raw));
  float* base = reinterpret_cast<float*>(raw + (1024u - at % 1024u) % 1024u);
  float* lo = base + kStages * (kSwStage / 4);
  const int4 tile = tiles[blockIdx.x];
  const int n = (Kp + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;  // rows [64 wg, 64 wg + 64) of the tile

  auto issue = [&](int s) {
    if (s < n) stage_tile<true>(base + (s % kStages) * (kSwStage / 4), dy, x, tile.x, tile.y, s,
                                R, N, Kp);
  };
  float acc[8][4] = {}, part[8][4];
  issue(0);
  gather::cp_async_commit();
  issue(1);
  gather::cp_async_commit();
  for (int s = 0; s < n; ++s) {
    gather::cp_async_wait<1>();
    __syncthreads();  // stage s has landed; stage s - 1 and lo are read by every warpgroup
    issue(s + 2);
    gather::cp_async_commit();
    float* st = base + (s % kStages) * (kSwStage / 4);
    for (int e = threadIdx.x; e < kSwStage / 16; e += kTileThreads) {
      float4 v = reinterpret_cast<float4*>(st)[e];
      unsigned h[4], l[4];
      tc::split_tf32(v.x, h[0], l[0]);
      tc::split_tf32(v.y, h[1], l[1]);
      tc::split_tf32(v.z, h[2], l[2]);
      tc::split_tf32(v.w, h[3], l[3]);
      reinterpret_cast<uint4*>(st)[e] = make_uint4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<uint4*>(lo)[e] = make_uint4(l[0], l[1], l[2], l[3]);
    }
    // the split is seen by wgmma (the async proxy), then by every warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint64_t ah = tc::swizzle128_desc(st + wg * 64 * kBK, 16);
    const uint64_t al = tc::swizzle128_desc(lo + wg * 64 * kBK, 16);
    const uint64_t bh = tc::swizzle128_desc(st + kBM * kBK, 16);
    const uint64_t bl = tc::swizzle128_desc(lo + kBM * kBK, 16);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // a depth step of 8: 32 bytes, 2 units
      wgmma_tf32(part, al + 2 * kk, bh + 2 * kk, kk > 0);
      wgmma_tf32(part, ah + 2 * kk, bl + 2 * kk, true);
      wgmma_tf32(part, ah + 2 * kk, bh + 2 * kk, true);
    }
    tc::wgmma_commit();
    tc::wait_steps<0>(part);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
  }
  gather::cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the stages: the product takes their place

  // warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8, columns
  // 8 j + 2 t and 8 j + 2 t + 1
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* crow = base + (wg * 64 + (threadIdx.x % 128) / 32 * 16 + g) * kLDC + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(crow + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(crow + 8 * kLDC + 8 * j) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  sample(base, tile, trow, tcol, tslot, dv);
}

// One stage (kBK deep) of a warp's 32 x 32 of the tile in bf16: A the dY
// rows [kBM][kLD16], B the X rows [kBN][kLD16] in shared memory, k
// contiguous in both (X's rows are mma's column-major B as they stand),
// each pair rounded to bf16 as it is loaded; summed into fresh registers
// over the stage, then added into acc in fp32.
__device__ __forceinline__ void bf16_step(float (&acc)[2][4][4], const float* A, const float* B,
                                          int wm, int wn, int lane) {
  const int g = lane / 4, t = lane % 4;
  float part[2][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* p = A + (wm * 32 + mt * 16 + g) * kLD16 + kk + 2 * t;
      const float2 p0 = *reinterpret_cast<const float2*>(p);
      const float2 p1 = *reinterpret_cast<const float2*>(p + 8 * kLD16);
      const float2 p2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 p3 = *reinterpret_cast<const float2*>(p + 8 * kLD16 + 8);
      a[mt][0] = pack_bf16(p0.x, p0.y);
      a[mt][1] = pack_bf16(p1.x, p1.y);
      a[mt][2] = pack_bf16(p2.x, p2.y);
      a[mt][3] = pack_bf16(p3.x, p3.y);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* q = B + (wn * 32 + nt * 8 + g) * kLD16 + kk + 2 * t;
      const float2 q0 = *reinterpret_cast<const float2*>(q);
      const float2 q1 = *reinterpret_cast<const float2*>(q + 8);
      b[nt][0] = pack_bf16(q0.x, q0.y);
      b[nt][1] = pack_bf16(q1.x, q1.y);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

// As sddmm_tf32_tile_kernel, in bf16 on mma.sync: X and dY rounded to bf16,
// products exact, sums in fp32.
__global__ void __launch_bounds__(kTileThreads, 2)
sddmm_bf16_tile_kernel(const int4* __restrict__ tiles, const int* __restrict__ trow,
                       const int* __restrict__ tcol, const int* __restrict__ tslot,
                       const float* __restrict__ dy, const float* __restrict__ x,
                       float* __restrict__ dv, int R, int N, int Kp) {
  float* base = reinterpret_cast<float*>(gather::gather_smem);
  const int4 tile = tiles[blockIdx.x];
  const int n = (Kp + kBK - 1) / kBK;
  auto issue = [&](int s) {
    if (s < n) stage_tile<false>(base + (s % kStages) * kStage16, dy, x, tile.x, tile.y, s, R,
                                 N, Kp);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  float acc[2][4][4] = {};
  issue(0);
  gather::cp_async_commit();
  issue(1);
  gather::cp_async_commit();
  for (int s = 0; s < n; ++s) {
    gather::cp_async_wait<1>();
    __syncthreads();  // stage s has landed; stage s - 1's is read by every warp
    issue(s + 2);
    gather::cp_async_commit();
    const float* st = base + (s % kStages) * kStage16;
    bf16_step(acc, st, st + kBM * kLD16, wm, wn, lane);
  }
  gather::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: the product takes their place

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* c = base + (wm * 32 + mt * 16 + g) * kLDC + wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(c + 8 * kLDC) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  sample(base, tile, trow, tcol, tslot, dv);
}

// Block b takes slots [lo + b * spb, lo + b * spb + spb) of the lists (not
// past S): slot e is dY_slots row trow[e] and X row tcol[e], each served by
// tps lanes of a warp that walk the rows' q4 float4s; the dot product,
// reduced by warp shuffles, goes to dv[tslot[e]].
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
sddmm_slot_kernel(const int* __restrict__ trow, const int* __restrict__ tcol,
                  const int* __restrict__ tslot, const float4* __restrict__ dy,
                  const float4* __restrict__ x, float* __restrict__ dv, int lo, int S, int q4,
                  int tps, int spb) {
  const int64_t b0 = lo + static_cast<int64_t>(blockIdx.x) * spb;  // sddmm_launch keeps
  const int s_lo = static_cast<int>(b0);                             // S + spb < 2^31
  const int s_hi = min(s_lo + spb, S);
  const int spi = kThreads / tps;  // slots per block iteration
  const int sub = threadIdx.x % tps;
  // every lane runs every iteration: the shuffles below need the whole warp
  for (int s0 = s_lo; s0 < s_hi; s0 += spi) {
    const int s = s0 + static_cast<int>(threadIdx.x) / tps;
    float acc = 0.f;
    if (s < s_hi) {
      const float4* xr = x + static_cast<int64_t>(tcol[s]) * q4;
      const float4* dr = dy + static_cast<int64_t>(trow[s]) * q4;
      for (int q = sub; q < q4; q += tps) {
        float4 a = xr[q];
        float4 b = dr[q];
        if constexpr (BF16) {
          a = make_float4(bf16_round(a.x), bf16_round(a.y), bf16_round(a.z), bf16_round(a.w));
          b = make_float4(bf16_round(b.x), bf16_round(b.y), bf16_round(b.z), bf16_round(b.w));
        }
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    }
    for (int off = tps / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (s < s_hi && sub == 0) dv[tslot[s]] = acc;
  }
}

// ---- dx: the column walk (#15).  The index's geometry (kernels/sddmm.py:
// DX_TILE_COLS, DX_WIN_ROWS, DX_PIECE_SLOTS, DX_OFF_LD).
constexpr int kDxCols = 128;           // columns of A (rows of dX) a tile
constexpr int kDxRows = 64;            // rows of dY_slots a window
constexpr int kDxPiece = 2048;         // the most slots a piece holds
constexpr int kDxOffLd = kDxCols + 4;  // a piece's column offsets, padded to 16 bytes
constexpr int kDxStages = 4;
constexpr int kDxUnroll = 4;           // slots whose loads are in flight together
constexpr int kDxPrepThreads = 256;    // dx_prep_kernel

// Columns a group of TPS lanes owns, the groups' threads (a multiple of 32)
// and the block's: one more warp, which stages.
__host__ __device__ constexpr int dx_cpg(int tps) { return tps >= 4 ? tps / 4 : 1; }
__host__ __device__ constexpr int dx_walkers(int tps) { return kDxCols / dx_cpg(tps) * tps; }
__host__ __device__ constexpr int dx_threads(int tps) { return dx_walkers(tps) + 32; }
// A stage: the piece's slots (row within the window, value) [kDxPiece + 2:
// copied from an even slot to an even slot, 16-byte aligned], the window of
// dY [kDxRows][TPS] float4, the column offsets [kDxOffLd].  The staged
// kernel's shared memory: the stages, then a stage's two mbarriers and the
// parity of its piece's first slot.
constexpr int kDxEntBytes = (kDxPiece + 2) * 8;
__host__ __device__ constexpr int dx_stage_bytes(int tps) {
  return kDxEntBytes + kDxRows * tps * 16 + kDxOffLd * 4;
}
__host__ __device__ constexpr int dx_smem_bytes(int tps) {
  return kDxStages * dx_stage_bytes(tps) + kDxStages * (8 + 8 + 4);
}

__device__ __forceinline__ float4 bf16_round4(float4 d) {
  return make_float4(bf16_round(d.x), bf16_round(d.y), bf16_round(d.z), bf16_round(d.w));
}

// ent[i] = (row[i], vals[slot[i]]): every listed slot's row beside its value;
// with dyr, also dyr = dY rounded to bf16 (n4 float4s).
__global__ void __launch_bounds__(kDxPrepThreads)
dx_prep_kernel(const int* __restrict__ row, const int* __restrict__ slot,
               const float* __restrict__ vals, int2* __restrict__ ent, int S,
               const float4* __restrict__ dy, float4* __restrict__ dyr, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kDxPrepThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kDxPrepThreads + threadIdx.x;
  for (int64_t i = first; i < S; i += stride) {
    ent[i] = make_int2(row[i], __float_as_int(vals[slot[i]]));
  }
  if (dyr != nullptr) {
    for (int64_t i = first; i < n4; i += stride) dyr[i] = bf16_round4(dy[i]);
  }
}

// acc += v * d, elementwise; BF16 (d already rounded to bf16): each product
// rounded to bf16, two by one conversion, and summed in fp32.
template <bool BF16>
__device__ __forceinline__ void add_product(float4& acc, float v, float4 d) {
  if constexpr (BF16) {
    const __nv_bfloat162 xy = __floats2bfloat162_rn(v * d.x, v * d.y);
    const __nv_bfloat162 zw = __floats2bfloat162_rn(v * d.z, v * d.w);
    acc.x += __low2float(xy);
    acc.y += __high2float(xy);
    acc.z += __low2float(zw);
    acc.w += __high2float(zw);
  } else {
    acc.x = fmaf(v, d.x, acc.x);
    acc.y = fmaf(v, d.y, acc.y);
    acc.z = fmaf(v, d.z, acc.z);
    acc.w = fmaf(v, d.w, acc.w);
  }
}

// Slots [lo, hi) of ent (rows ent.x of dy, float4 column qc) into acc,
// kDxUnroll slots' loads in flight together; a value of 0 is skipped.
template <bool BF16>
__device__ __forceinline__ void walk_from_l2(float4& acc, const int2* __restrict__ ent, int lo,
                                             int hi, const float4* __restrict__ dy, int q4,
                                             int qc) {
  int i = lo;
  for (; i + kDxUnroll <= hi; i += kDxUnroll) {
    int2 e[kDxUnroll];
    float4 d[kDxUnroll];
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) e[u] = ent[i + u];
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) {
      d[u] = __int_as_float(e[u].y) != 0.f ? dy[static_cast<int64_t>(e[u].x) * q4 + qc]
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) {
      const float v = __int_as_float(e[u].y);
      if (v != 0.f) add_product<BF16>(acc, v, d[u]);
    }
  }
  for (; i < hi; ++i) {
    const int2 e = ent[i];
    const float v = __int_as_float(e.y);
    if (v != 0.f) add_product<BF16>(acc, v, dy[static_cast<int64_t>(e.x) * q4 + qc]);
  }
}

// Slots [lo, hi) of a staged piece (se: its slots, sd: its window of dY)
// into acc, kDxUnroll slots' loads in flight together.
template <int TPS, bool BF16>
__device__ __forceinline__ void walk_staged(float4& acc, const int2* se, const float4* sd, int lo,
                                            int hi, int sub) {
  int i = lo;
  for (; i + kDxUnroll <= hi; i += kDxUnroll) {
    int2 e[kDxUnroll];
    float4 d[kDxUnroll];
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) e[u] = se[i + u];
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) d[u] = sd[e[u].x * TPS + sub];
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) {
      const float v = __int_as_float(e[u].y);
      if (v != 0.f) add_product<BF16>(acc, v, d[u]);
    }
  }
  for (; i < hi; ++i) {
    const int2 e = se[i];
    const float v = __int_as_float(e.y);
    if (v != 0.f) add_product<BF16>(acc, v, sd[e.x * TPS + sub]);
  }
}

// Block (t, z) computes rows [t * kDxCols, t * kDxCols + kDxCols) of dX (a
// row at or past N is not written), float4 columns [z * TPS, z * TPS + TPS)
// of its q4, from dy [R, q4] (in BF16, dY already rounded to bf16).  The
// index, for tile t:
//   colpos [T, kDxCols]  the tile's column (0..kDxCols-1) at each position;
//       group g owns positions [g * CPG, g * CPG + CPG);
//   uoff [T, kDxCols + 1]  each position's sparse slots, [uoff[p], uoff[p+1])
//       of ent (rows of dY_slots, rising);
//   tile_pieces [T + 1]  the tile's pieces [tile_pieces[t], tile_pieces[t+1]);
//   pieces [H] (first dY row, start, end, 0)  a piece's slots [start, end) of
//       ent, rows given within its window;
//   piece_off [H, kDxOffLd]  position p's slots [off[p], off[p+1]) of the
//       piece's, counted from its start.
// The last warp stages piece after piece by bulk copies (the TMA;
// kDxStages deep, each stage's landing counted in bytes on an mbarrier, its
// release by every walking warp on another), so a warp that finishes a
// piece goes on to the next without waiting for the others.
template <int TPS, bool BF16>
__global__ void __launch_bounds__(dx_threads(TPS), 1)
dx_walk_kernel(const int2* __restrict__ ent, const int4* __restrict__ pieces,
               const int* __restrict__ piece_off, const int* __restrict__ tile_pieces,
               const int* __restrict__ uoff, const int* __restrict__ colpos,
               const float4* __restrict__ dy, float4* __restrict__ dx, int R, int N, int q4) {
  constexpr int CPG = dx_cpg(TPS), NW = dx_walkers(TPS), kStage = dx_stage_bytes(TPS);
  uint8_t* raw = reinterpret_cast<uint8_t*>(gather::gather_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + kDxStages * kStage);  // after the stages
  uint64_t* empty = full + kDxStages;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * TPS;
  const int h0 = tile_pieces[t], n = tile_pieces[t + 1] - h0;
  int* skew = reinterpret_cast<int*>(empty + kDxStages);
  if (threadIdx.x == 0) {
    for (int b = 0; b < kDxStages; ++b) {
      gather::mbar_init(full + b, 1);
      gather::mbar_init(empty + b, NW / 32);
    }
  }
  __syncthreads();

  if (threadIdx.x >= NW) {  // the staging warp: bulk copies (the TMA)
    const int lane = threadIdx.x - NW;
    const unsigned row_bytes = 16u * min(TPS, q4 - q0);  // the panel's float4s present
    int4 pc = n > 0 ? pieces[h0] : make_int4(0, 0, 0, 0);
    for (int s = 0; s < n; ++s) {
      const int b = s % kDxStages;
      const int4 next = s + 1 < n ? pieces[h0 + s + 1] : pc;  // loaded while stage s is copied
      if (s >= kDxStages) gather::mbar_wait(empty + b, (s / kDxStages - 1) & 1);
      uint8_t* st = raw + b * kStage;
      const int lo = pc.y & ~1, hi = (pc.z + 1) & ~1;  // ent holds S + 1 slots
      const int rows = min(kDxRows, R - pc.x);         // rows past R are never read
      if (lane == 0) {
        skew[b] = pc.y & 1;
        gather::mbar_expect_tx(full + b, 8u * (hi - lo) + rows * row_bytes + kDxOffLd * 4);
      }
      __syncwarp();
      if (lane == 0 && hi > lo) gather::bulk_copy(st, ent + lo, 8u * (hi - lo), full + b);
      if (lane == 1) {
        gather::bulk_copy(st + kDxEntBytes + kDxRows * TPS * 16,
                          piece_off + static_cast<int64_t>(h0 + s) * kDxOffLd, kDxOffLd * 4,
                          full + b);
      }
      if (q4 == TPS) {  // the panel is the whole row: the window is one run of bytes
        if (lane == 2) {
          gather::bulk_copy(st + kDxEntBytes, dy + static_cast<int64_t>(pc.x) * q4,
                            rows * row_bytes, full + b);
        }
      } else {
        for (int r = lane; r < rows; r += 32) {
          gather::bulk_copy(st + kDxEntBytes + r * TPS * 16,
                            dy + (static_cast<int64_t>(pc.x) + r) * q4 + q0, row_bytes, full + b);
        }
      }
      pc = next;
    }
    return;
  }

  const int g = threadIdx.x / TPS, sub = threadIdx.x % TPS;
  const int q = q0 + sub;
  const int qc = min(q, q4 - 1);  // a lane past q4 reads a valid float4 and writes nothing
  const int p0 = g * CPG;
  float4 acc[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the sparse slots of the group's columns, while the first stages land
  {
    const int* uo = uoff + static_cast<int64_t>(t) * (kDxCols + 1) + p0;
    int lim[CPG + 1];
#pragma unroll
    for (int c = 0; c <= CPG; ++c) lim[c] = uo[c];
#pragma unroll
    for (int c = 0; c < CPG; ++c) walk_from_l2<BF16>(acc[c], ent, lim[c], lim[c + 1], dy, q4, qc);
  }

  // the pieces, as they land
  for (int s = 0; s < n; ++s) {
    const int b = s % kDxStages;
    gather::mbar_wait(full + b, (s / kDxStages) & 1);
    const uint8_t* st = raw + b * kStage;
    const int2* se = reinterpret_cast<const int2*>(st) + skew[b];
    const float4* sd = reinterpret_cast<const float4*>(st + kDxEntBytes);
    const int* so = reinterpret_cast<const int*>(st + kDxEntBytes + kDxRows * TPS * 16);
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      walk_staged<TPS, BF16>(acc[c], se, sd, so[p0 + c], so[p0 + c + 1], sub);
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) gather::mbar_arrive(empty + b);  // the warp is done with it
  }

  if (q < q4) {
    const int* cp = colpos + static_cast<int64_t>(t) * kDxCols + p0;
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      const int64_t col = static_cast<int64_t>(t) * kDxCols + cp[c];
      if (col < N) dx[col * q4 + q] = acc[c];
    }
  }
}

template <int TPS>
const void* dx_walk_kernel_of(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(dx_walk_kernel<TPS, true>)
              : reinterpret_cast<const void*>(dx_walk_kernel<TPS, false>);
}

// The walk kernel of TPS lanes a group (1, 2, 4, ..., 32), or nullptr.
const void* dx_walk_kernel_for(int tps, int bf16) {
  switch (tps) {
    case 1: return dx_walk_kernel_of<1>(bf16);
    case 2: return dx_walk_kernel_of<2>(bf16);
    case 4: return dx_walk_kernel_of<4>(bf16);
    case 8: return dx_walk_kernel_of<8>(bf16);
    case 16: return dx_walk_kernel_of<16>(bf16);
    case 32: return dx_walk_kernel_of<32>(bf16);
    default: return nullptr;
  }
}

// The OptIn of a kernel: log2(tps), the bf16 ones at + 6.
int dx_optin_index(int tps, int bf16) {
  int i = 0;
  while ((1 << i) < tps) ++i;
  return i + (bf16 ? 6 : 0);
}

}  // namespace

extern "C" {

// The tile index's dense tiles (tiles int32 [T, 4], 16-byte aligned: first
// row, first column, start, end) and its lists (row, col, slot int32 [S]:
// the T tiles' D slots first, then the sparser tiles'); dv fp32 zeroed by
// the caller; dy [R, Kp] and x [N, Kp] fp32, 16-byte aligned, Kp a
// multiple of 4.  Launches the tile kernel over the T tiles and the
// per-slot kernel over slots [D, S), each where it has work (the per-slot
// kernel also when neither has, so an empty index is a launch too).
// Returns the cudaError_t of the launches (0 on success).
int sddmm_launch(const void* tiles, const void* row, const void* col, const void* slot,
                 const void* dy, const void* x, void* dv, int T, int D, int S, int R, int N,
                 int Kp, int bf16, void* stream) {
  if (T < 0 || D < 0 || S < D || (T == 0) != (D == 0) || R < 1 || N < 1 || Kp < 4 || Kp % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int*>(row);
  const auto* c = static_cast<const int*>(col);
  const auto* sl = static_cast<const int*>(slot);
  auto* out = static_cast<float*>(dv);
  if (T > 0) {
    static gather::OptIn optin[2];  // one per kernel, in this library
    auto kernel = bf16 ? sddmm_bf16_tile_kernel : sddmm_tf32_tile_kernel;
    const size_t smem = bf16 ? kBf16Smem : kTf32Smem;
    const cudaError_t err = optin[bf16 ? 1 : 0].ensure(reinterpret_cast<const void*>(kernel));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<T, kTileThreads, smem, s>>>(static_cast<const int4*>(tiles), r, c, sl,
                                         static_cast<const float*>(dy),
                                         static_cast<const float*>(x), out, R, N, Kp);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  if (S > D || T == 0) {
    const int q4 = Kp / 4;
    const int tps = threads_per_slot(q4, 32);
    const int spb = kThreads / tps * kSlotSteps;
    if (static_cast<int64_t>(S) + spb >= (int64_t{1} << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int blocks = S > D ? (S - D + spb - 1) / spb : 1;
    auto kernel = bf16 ? sddmm_slot_kernel<true> : sddmm_slot_kernel<false>;
    kernel<<<blocks, kThreads, 0, s>>>(r, c, sl, static_cast<const float4*>(dy),
                                       static_cast<const float4*>(x), out, D, S, q4, tps, spb);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel (kind 0: sddmm_tf32_tile_kernel, or with bf16
// sddmm_bf16_tile_kernel), the per-slot kernel (kind 1) or dx's walk kernel
// at panels of 128 columns (kind 2), into out[0..3]: registers a thread,
// local (spill) bytes a thread, static shared bytes, blocks an SM holds (at
// the kernel's dynamic shared memory).  Returns a cudaError_t.
int sddmm_info(int kind, int bf16, int* out) {
  cudaFuncAttributes attr{};
  const void* kernel =
      kind == 0   ? (bf16 ? reinterpret_cast<const void*>(sddmm_bf16_tile_kernel)
                          : reinterpret_cast<const void*>(sddmm_tf32_tile_kernel))
      : kind == 1 ? (bf16 ? reinterpret_cast<const void*>(sddmm_slot_kernel<true>)
                          : reinterpret_cast<const void*>(sddmm_slot_kernel<false>))
                  : dx_walk_kernel_for(32, bf16);
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kind == 0   ? (bf16 ? kBf16Smem : kTf32Smem)
                      : kind == 1 ? 0
                                  : static_cast<size_t>(dx_smem_bytes(32));
  int blocks = 0;
  if (smem > static_cast<size_t>(attr.maxDynamicSharedSizeBytes)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gather::optin_shared_bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = kind == 0 ? kTileThreads : kind == 1 ? kThreads : dx_threads(32);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// The column walk of dX [N, Kp] fp32 (written whole; Kp a multiple of 4)
// from dy [R, Kp] fp32 (16-byte aligned) and the value plane vals fp32,
// through the index (kernels/sddmm.py, DxIndex): row, slot int32 [S] (the
// listed slots), pieces int32 [H, 4], piece_off int32 [H, kDxOffLd] (both
// 16-byte aligned), tile_pieces int32 [T + 1], uoff int32 [T, kDxCols + 1],
// colpos int32 [T, kDxCols].  Scratch: ent int2 [S + 1]; with bf16, dyr [R, Kp]
// fp32 (16-byte aligned; read only with bf16).
// Launches dx_prep_kernel (where S > 0 or with bf16), then dx_walk_kernel
// over T tiles by the panels of Kp.  Returns the cudaError_t of the
// launches (0 on success).
int dx_walk_launch(const void* row, const void* slot, const void* vals, const void* pieces,
                   const void* piece_off, const void* tile_pieces, const void* uoff,
                   const void* colpos, const void* dy, void* dx, void* ent, void* dyr, int S,
                   int T, int R, int N, int Kp, int bf16, void* stream) {
  if (S < 0 || T < 1 || R < 1 || N < 1 || static_cast<int64_t>(T) * kDxCols < N || Kp < 4 ||
      Kp % 4 || (bf16 && dyr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int q4 = Kp / 4;
  const int tps = threads_per_slot(q4, 32);
  const void* kernel = dx_walk_kernel_for(tps, bf16);
  static gather::OptIn optin[12];  // one per kernel, in this library
  cudaError_t err = optin[dx_optin_index(tps, bf16)].ensure(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto* e = static_cast<int2*>(ent);
  const auto* d = static_cast<const float4*>(bf16 ? dyr : dy);
  const int64_t n4 = bf16 ? static_cast<int64_t>(R) * q4 : 0;
  if (S > 0 || n4 > 0) {
    const int64_t work = std::max<int64_t>(S, n4);
    const int blocks = static_cast<int>(
        std::min<int64_t>((work + kDxPrepThreads - 1) / kDxPrepThreads, 132 * 16));
    dx_prep_kernel<<<blocks, kDxPrepThreads, 0, s>>>(
        static_cast<const int*>(row), static_cast<const int*>(slot),
        static_cast<const float*>(vals), e, S, static_cast<const float4*>(dy),
        static_cast<float4*>(bf16 ? dyr : nullptr), n4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* en = static_cast<const int2*>(e);
  const auto* pc = static_cast<const int4*>(pieces);
  const auto* po = static_cast<const int*>(piece_off);
  const auto* tp = static_cast<const int*>(tile_pieces);
  const auto* uo = static_cast<const int*>(uoff);
  const auto* cp = static_cast<const int*>(colpos);
  auto* out = static_cast<float4*>(dx);
  void* args[] = {&en, &pc, &po, &tp, &uo, &cp, &d, &out, &R, &N, &q4};
  const dim3 grid(T, (q4 + tps - 1) / tps);
  err = cudaLaunchKernel(kernel, grid, dim3(dx_threads(tps)), args,
                         dx_smem_bytes(tps), s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
