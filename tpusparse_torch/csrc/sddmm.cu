// sddmm.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/sddmm.py, the gradients of Y = A(v) . X over a fixed
// span pattern with trainable values v:
//   sddmm_launch  replaces _sddmm_kernel (sddmm.py:72), the value gradient;
//   dx_launch     replaces _dx_kernel    (sddmm.py:167), the input gradient.
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
//           (slots whose value is not zero), dX [N, Kp] zeroed by the caller.
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
// Design of dx:
//   dx_kernel: one block of 128 threads per (chunk, program), the chunk's
//   three planes staged in shared memory.  The threads split into streams
//   of tps threads (one float4 column of dY each, up to 128 threads); each
//   stream walks a contiguous run of the chunk's slots.  A chunk's slots
//   are sorted by column (pack_span), so a stream sums the products of
//   equal columns in registers and adds the sum into dX with one fp32
//   atomicAdd per column and k when the column changes.  A pruned weight's
//   chunk of 128 slots holds a few columns (about 51 nonzeros per column
//   per program at 90 % sparsity and rb = 512), so this takes about 40x
//   fewer atomics than one per product.  The atomics make the order of
//   the sums vary from run to run: dX agrees with its plain version to
//   rounding, not bit for bit.
//
// Bound.  Both do 2 flops per slot and column of K (1.72 GFLOP at the
// pruned 4096^2 weight, K = 512: 0.026 ms at the fp32 peak of 67 TFLOP/s;
// each input once is 37 MB, 0.011 ms at 3.35 TB/s).  The tile kernel does
// the dense product of its tiles instead, on the tensor cores; see PERF.md
// for the times against the bound on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;             // dx_kernel and sddmm_slot_kernel
constexpr int kMaxPlaneSmem = 48 * 1024;  // dx's staged planes: G <= 4096 slots
constexpr int kSlotSteps = 8;             // sddmm_slot_kernel: rounds of slots a block

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

// Adds one column's summed products into dX (a column at or past N, which
// a checked format has none of, is dropped).
__device__ __forceinline__ void flush(float* dx, int64_t col, int N, int q4, int q,
                                      const float4& acc) {
  if (col >= N) return;
  float* d = dx + (col * q4 + q) * 4;
  atomicAdd(d + 0, acc.x);
  atomicAdd(d + 1, acc.y);
  atomicAdd(d + 2, acc.z);
  atomicAdd(d + 3, acc.w);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const int* __restrict__ c0, const int* __restrict__ cols,
          const int* __restrict__ lrow, const float* __restrict__ vals,
          const int* __restrict__ nc_p, const float4* __restrict__ dy, float* __restrict__ dx,
          int NC, int G, int rb, int N, int q4, int tps) {
  extern __shared__ int planes[];  // cols [G], lrow [G], vals [G]
  const int j = blockIdx.x;
  const int p = blockIdx.y;
  if (j >= nc_p[p]) return;
  const int64_t chunk = static_cast<int64_t>(p) * NC + j;
  const int64_t base = chunk * G;
  int* cs = planes;
  int* ls = cs + G;
  float* vs = reinterpret_cast<float*>(ls + G);
  for (int e = threadIdx.x; e < G; e += kThreads) {
    cs[e] = cols[base + e];
    ls[e] = lrow[base + e];
    vs[e] = vals[base + e];
  }
  __syncthreads();
  const int streams = kThreads / tps;
  const int stream = static_cast<int>(threadIdx.x) / tps;
  const int sub = threadIdx.x % tps;
  const int per = (G + streams - 1) / streams;
  const int s_lo = min(stream * per, G);
  const int s_hi = min(s_lo + per, G);
  const int64_t start = c0[chunk];
  const float4* dprog = dy + static_cast<int64_t>(p) * rb * q4;
  for (int q = sub; q < q4; q += tps) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int cur = -1;
    for (int s = s_lo; s < s_hi; ++s) {
      const float v = vs[s];
      if (v == 0.f) continue;
      const int c = cs[s];
      if (c != cur) {
        if (cur >= 0) flush(dx, start + cur, N, q4, q, acc);
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        cur = c;
      }
      float4 d = dprog[static_cast<int64_t>(ls[s]) * q4 + q];
      if constexpr (BF16) {
        acc.x += bf16_round(v * bf16_round(d.x));
        acc.y += bf16_round(v * bf16_round(d.y));
        acc.z += bf16_round(v * bf16_round(d.z));
        acc.w += bf16_round(v * bf16_round(d.w));
      } else {
        acc.x = fmaf(v, d.x, acc.x);
        acc.y = fmaf(v, d.y, acc.y);
        acc.z = fmaf(v, d.z, acc.z);
        acc.w = fmaf(v, d.w, acc.w);
      }
    }
    if (cur >= 0) flush(dx, start + cur, N, q4, q, acc);
  }
}

bool bad_geometry(int P, int NC, int G, int rb, int N, int Kp) {
  return P < 1 || P > 65535 || NC < 1 || G < 1 || rb < 1 || N < 1 || Kp < 4 || Kp % 4;
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
// sddmm_bf16_tile_kernel) or the per-slot kernel (kind 1), into out[0..3]: registers a thread, local (spill) bytes a
// thread, static shared bytes, blocks an SM holds (at the tile kernel's
// dynamic shared memory).  Returns a cudaError_t.
int sddmm_info(int kind, int bf16, int* out) {
  cudaFuncAttributes attr{};
  const void* kernel =
      kind == 0 ? (bf16 ? reinterpret_cast<const void*>(sddmm_bf16_tile_kernel)
                        : reinterpret_cast<const void*>(sddmm_tf32_tile_kernel))
                : (bf16 ? reinterpret_cast<const void*>(sddmm_slot_kernel<true>)
                        : reinterpret_cast<const void*>(sddmm_slot_kernel<false>));
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kind == 0 ? (bf16 ? kBf16Smem : kTf32Smem) : 0;
  int blocks = 0;
  if (kind == 0 && smem > static_cast<size_t>(attr.maxDynamicSharedSizeBytes)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gather::optin_shared_bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kind == 0 ? kTileThreads : kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// dx [N, Kp] fp32 must be zeroed; vals [P,NC,G] fp32; dy [P*rb, Kp] fp32,
// 16-byte aligned, Kp a multiple of 4; G at most 4096.  Returns the
// cudaError_t of the launch.
int dx_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
              const void* nc_p, const void* dy, void* dx, int P, int NC, int G, int rb, int N,
              int Kp, int bf16, void* stream) {
  const size_t smem = static_cast<size_t>(3) * G * sizeof(int);
  if (bad_geometry(P, NC, G, rb, N, Kp) || smem > kMaxPlaneSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q4 = Kp / 4;
  const int tps = threads_per_slot(q4, kThreads);
  const dim3 grid(NC, P);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? dx_kernel<true> : dx_kernel<false>;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int*>(c0), static_cast<const int*>(cols), static_cast<const int*>(lrow),
      static_cast<const float*>(vals), static_cast<const int*>(nc_p),
      static_cast<const float4*>(dy), static_cast<float*>(dx), NC, G, rb, N, q4, tps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
