// block_ell.cu - the Hopper counterpart of the TPU kernel in
// tpusparse/kernels/block_ell.py:
//   bell_spmm_launch  replaces _bell_kernel (block_ell.py:136), and with int8
//                     operands serves the product of _bell_xla_int8 (:200).
//
// Function.  BlockEllFormat: row-block i holds BMAX slots; slot j is a dense
// BS x BS block (blkvals [MB, BMAX, BS, BS]) at block-column blkcol[i, j].
// For every row-block i, row a < BS and column k < K:
//     y[i*BS + a, k] = sum_{j < nb_p[i]} sum_{b < BS}
//                      blkvals[i, j, a, b] * X[blkcol[i, j]*BS + b, k]
// with X [NB*BS, K] and y [MB*BS, K].  nb_p[i] counts the row-block's real
// blocks: the padded slots that follow them hold zero blocks at
// block-column 0, which the TPU multiplies and this kernel never reads.
//
// Precision, each mode at least the TPU's class.  bf16: the values and X
// rounded to bf16 (the wrapper casts X once, and an fp32 plane once), their
// exact products summed in fp32 by bf16 wgmma.  fp32: 3xTF32 on mma.sync
// (tensor_core.cuh), each 64-deep step summed into fresh registers and
// then added in fp32, to 1e-5 of |A|.|x|.  int8 (W8A8): int8 values times
// int8 X (the wrapper's per-column quantization), int8 wgmma with exact
// int32 sums; the wrapper applies the rank-1 rescale afterwards.
//
// Bound.  At P14 (138 real 128 x 128 blocks of a 4096^2 weight, K = 256):
// 4.5 MB of bf16 blocks, 4 MB of X and 4 MB of y are 0.0039 ms at 3.35
// TB/s; the 1.16 GFLOP are 1.2 us on the bf16 tensor cores and 0.0173 ms
// on the fp32 CUDA cores.  A Block-ELL product is a GEMM over a gathered
// depth, so the design is a tensor-core GEMM whose depth for row-block i is
// the concatenation of its nb_p[i] blocks:
//   - a work item (built once per format from nb_p on the host, the
//     wrapper's `work` [n, 4] int32) names a row-block and a run of at most
//     a few of its blocks (four depth steps), so the longest row-block (10
//     blocks at P14, 2.3x the mean) is shared by several blocks of the
//     grid; an item that holds its row-block alone stores its tile of y,
//     the others add theirs into the zeroed y (float4 atomics, int32 in
//     int8, which stay exact);
//   - grid (item, 64-row tile of the row-block, 128-column tile of y);
//   - the depth is walked in steps of 128 bytes a row (64 bf16 or fp32
//     values, 128 int8): the A step is a slice of one dense block, already
//     K-major row-major [BS][BS], copied by cp.async into shared memory in
//     the layout its instruction reads (nothing is rebuilt); the X step is
//     64 rows of X at blkcol * BS + the step's offset (bf16: MN-major in
//     the 128-byte swizzle, as #12 stages its X; fp32: rows padded against
//     bank conflicts); int8 wgmma takes no MN-major operand, so the
//     wrapper hands X^T [K, NB*BS] and its step is K-major like A;
//   - bf16 and int8: one warpgroup, a ring of four (A, X) stages loaded two
//     steps ahead, one wgmma step in flight while the next is issued;
//     fp32: eight warps of 32 x 32 on mma.sync, three stages;
//   - the ragged edges: rows past BS (BS a multiple of 32, so a 64-row tile
//     may be half full), depth past BS within a step, columns past K: the
//     copies read nothing there and the stage holds zeros.

#include <type_traits>

#include "gather_common.cuh"
#include "tensor_core.cuh"

namespace {

using gather::OptIn;

constexpr int kBM = 64;         // rows of y a block takes
constexpr int kBN = 128;        // columns of y a block takes
constexpr int kRow = 128;       // bytes of a depth step in one row of A

// ---------------------------------------------------------------- wgmma (bf16, int8)

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kWgStages = 4;
constexpr int kAStage = kBM * kRow;      // 8 KB: A [64][128 bytes], K-major, swizzled
constexpr int kXStage = kBN * kRow;      // 16 KB: bf16 X [64][128] MN-major, or int8 X^T [128][128]
constexpr int kWgStageBytes = kAStage + kXStage;

// The 16-byte chunk c of 128-byte row r of a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) { return r * kRow + ((c ^ (r & 7)) << 4); }

// cp.async of the A step: rows [m0, m0 + 64) of the dense block ablk
// [BS][BS] of esize-byte values, depth elements [d0, d0 + 128 / esize),
// into a K-major swizzled tile; rows and depth past BS are zero-filled.
template <int NT>
__device__ __forceinline__ void stage_a(uint8_t* as, const uint8_t* ablk, int m0, int d0, int BS,
                                        int esize) {
  const int per = 16 / esize;  // values a chunk
  for (int e = threadIdx.x; e < kBM * 8; e += NT) {
    const int r = e >> 3, c = e & 7;
    const int d = d0 + c * per;
    const bool valid = m0 + r < BS && d < BS;
    const uint8_t* src = ablk + (static_cast<int64_t>(m0 + r) * BS + d) * esize;
    gather::cp_async<16>(as + swz(r, c), valid ? src : ablk, valid);
  }
}

// cp.async of a bf16 X step: X rows xr0 + k for k < 64 (those with
// d0 + k < BS), columns [n0, n0 + 128) (those < ldx) as two MN-major
// blocks [64][64] in the 128-byte swizzle.
__device__ __forceinline__ void stage_x_bf16(uint8_t* xs, const __nv_bfloat16* x, int64_t xr0,
                                             int d0, int BS, int n0, int ldx) {
  for (int e = threadIdx.x; e < 64 * (kBN / 8); e += kWgThreads) {
    const int k = e / (kBN / 8), cc = e % (kBN / 8);
    const bool valid = d0 + k < BS && n0 + cc * 8 < ldx;
    const __nv_bfloat16* src = valid ? x + (xr0 + k) * ldx + n0 + cc * 8 : x;
    gather::cp_async<16>(xs + (cc / 8) * (64 * kRow) + swz(k, cc % 8), src, valid);
  }
}

// cp.async of an int8 X^T step: rows n0 + n of X^T [K, ldt] for n < 128
// (those < K), bytes [c0 + d0, c0 + d0 + 128) (those with depth < BS), as a
// K-major swizzled tile [128][128].
__device__ __forceinline__ void stage_xt_int8(uint8_t* xs, const int8_t* xt, int64_t c0, int d0,
                                              int BS, int n0, int K, int ldt) {
  for (int e = threadIdx.x; e < kBN * 8; e += kWgThreads) {
    const int n = e >> 3, c = e & 7;
    const bool valid = n0 + n < K && d0 + c * 16 < BS;
    const int8_t* src = valid ? xt + static_cast<int64_t>(n0 + n) * ldt + c0 + d0 + c * 16 : xt;
    gather::cp_async<16>(xs + swz(n, c), src, valid);
  }
}

// The four values of lane (g, t) of an n8 tile (row g: v0, v1 at columns
// 2t, 2t + 1; row g + 8: v2, v3) regrouped across the lane pair (t, t ^ 1)
// into four consecutive columns: an even t gets row g, columns 2t..2t + 3,
// an odd t row g + 8, columns 2t - 2..2t + 1.  Then stored, or added with
// one vector atomic (fp32) or four int32 atomics.
template <typename T>
__device__ __forceinline__ void put4(T* y, int64_t ldy, int64_t row0, int rows, int g, int t,
                                     int col, int ncols, const T (&v)[4], bool alone) {
  const bool odd = t & 1;
  const T r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
  const T r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
  const int row = g + (odd ? 8 : 0);
  const int c = col + 2 * (t & ~1);
  if (row >= rows || c >= ncols) return;
  T* p = y + (row0 + row) * ldy + c;
  const T q[4] = {odd ? r0 : v[0], odd ? r1 : v[1], odd ? v[2] : r0, odd ? v[3] : r1};
  if constexpr (std::is_same<T, float>::value) {
    const float4 f = make_float4(q[0], q[1], q[2], q[3]);
    if (alone) {
      *reinterpret_cast<float4*>(p) = f;
    } else {
      atomicAdd(reinterpret_cast<float4*>(p), f);
    }
  } else {
    if (alone) {
      *reinterpret_cast<int4*>(p) = make_int4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) atomicAdd(p + i, q[i]);
    }
  }
}

// Block (item, m tile, n tile): the item's run of blocks [j0, j1) of
// row-block i, rows [m0, m0 + 64) of it, columns [n0, n0 + 128) of y.
// INT8: x is X^T [K, ldx] int8 and y int32; else x is bf16 X [NB*BS, ldx].
template <bool INT8>
__global__ void __launch_bounds__(kWgThreads)
bell_wgmma_kernel(const int* __restrict__ blkcol, const uint8_t* __restrict__ blkvals,
                  const int4* __restrict__ work, const void* __restrict__ x, void* __restrict__ y,
                  int BMAX, int BS, int K, int ldx, int ldy) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int esize = INT8 ? 1 : 2;
  constexpr int depth = kRow / esize;  // values of a step
  uint8_t* base = reinterpret_cast<uint8_t*>(gather::gather_smem);
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(base));
  base += (1024u - at % 1024u) % 1024u;  // the swizzled tiles are 1024-byte aligned
  const int4 item = work[blockIdx.x];
  const int i = item.x, j0 = item.y;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  const int spb = (BS + depth - 1) / depth;  // steps a block
  const int n = (item.z - j0) * spb;

  auto issue = [&](int s) {  // step s into stage s % kWgStages
    if (s >= n) return;
    const int64_t slot = static_cast<int64_t>(i) * BMAX + j0 + s / spb;
    const int d0 = (s % spb) * depth;
    uint8_t* st = base + (s % kWgStages) * kWgStageBytes;
    stage_a<kWgThreads>(st, blkvals + slot * BS * BS * esize, m0, d0, BS, esize);
    const int64_t c0 = static_cast<int64_t>(blkcol[slot]) * BS;
    if constexpr (INT8) {
      stage_xt_int8(st + kAStage, static_cast<const int8_t*>(x), c0, d0, BS, n0, K, ldx);
    } else {
      stage_x_bf16(st + kAStage, static_cast<const __nv_bfloat16*>(x), c0 + d0, d0, BS, n0, ldx);
    }
  };

  Acc acc[kBN / 8][4] = {};
  if (n > 0) {
    issue(0);
    gather::cp_async_commit();
    issue(1);
    gather::cp_async_commit();
    for (int s = 0; s < n; ++s) {
      gather::cp_async_wait<1>();  // step s has landed (this thread's copies)
      // the copies are seen by wgmma (the async proxy), then by every thread;
      // step s - 2's stage, which the next copies overwrite, was waited for
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      issue(s + 2);
      gather::cp_async_commit();
      const uint8_t* st = base + (s % kWgStages) * kWgStageBytes;
      tc::pin(acc);
      tc::wgmma_fence();
      const uint64_t da = tc::swizzle128_desc(st, 16);
      if constexpr (INT8) {
        const uint64_t db = tc::swizzle128_desc(st + kAStage, 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) tc::wgmma_k32_s8(acc, da + 2 * kk, db + 2 * kk);
      } else {
        const uint64_t db = tc::swizzle128_desc(st + kAStage, 64 * kRow);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) tc::wgmma_k16(acc, da + 2 * kk, db + 128 * kk);
      }
      tc::wgmma_commit();
      tc::pin(acc);
      tc::wait_steps<1>(acc);  // step s - 1 is done: its stage is free at the next barrier
    }
    tc::wait_steps<0>(acc);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(i) * BS + m0 + 16 * warp;
  const int rows = BS - m0 - 16 * warp;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    put4(static_cast<Acc*>(y), ldy, row0, rows, lane / 4, lane % 4, n0 + 8 * j, ldy, acc[j],
         item.w != 0);
  }
}

// ---------------------------------------------------------------- 3xTF32 (fp32)

constexpr int kF32Threads = 256;  // 8 warps, 2 x 4, each 32 x 32 of y
constexpr int kF32Stages = 3;
constexpr int kLDA = 64 + 4;      // A fragments (g, t): g*68 + t covers 32 banks
constexpr int kLDB = kBN + 8;     // X fragments (t, g): t*136 + g does too
constexpr int kF32Stage = (kBM * kLDA + 64 * kLDB) * 4;

__global__ void __launch_bounds__(kF32Threads, 1)
bell_tf32_kernel(const int* __restrict__ blkcol, const float* __restrict__ blkvals,
                 const int4* __restrict__ work, const float* __restrict__ x,
                 float* __restrict__ y, int BMAX, int BS, int ldx, int ldy) {
  float* base = reinterpret_cast<float*>(gather::gather_smem);
  const int4 item = work[blockIdx.x];
  const int i = item.x, j0 = item.y;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  const int spb = (BS + 63) / 64;
  const int n = (item.z - j0) * spb;

  auto issue = [&](int s) {
    if (s >= n) return;
    const int64_t slot = static_cast<int64_t>(i) * BMAX + j0 + s / spb;
    const int d0 = (s % spb) * 64;
    float* as = base + (s % kF32Stages) * (kF32Stage / 4);
    float* xs = as + kBM * kLDA;
    const float* ablk = blkvals + slot * BS * BS;
    for (int e = threadIdx.x; e < kBM * 16; e += kF32Threads) {
      const int r = e >> 4, c = (e & 15) * 4;
      const bool valid = m0 + r < BS && d0 + c < BS;
      const float* src = ablk + static_cast<int64_t>(m0 + r) * BS + d0 + c;
      gather::cp_async<16>(as + r * kLDA + c, valid ? src : ablk, valid);
    }
    const int64_t xr0 = static_cast<int64_t>(blkcol[slot]) * BS + d0;
    for (int e = threadIdx.x; e < 64 * (kBN / 4); e += kF32Threads) {
      const int k = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
      const bool valid = d0 + k < BS && n0 + c < ldx;
      const float* src = valid ? x + (xr0 + k) * ldx + n0 + c : x;
      gather::cp_async<16>(xs + k * kLDB + c, src, valid);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[2][4][4] = {};
  issue(0);
  gather::cp_async_commit();
  issue(1);
  gather::cp_async_commit();
  for (int s = 0; s < n; ++s) {
    gather::cp_async_wait<1>();
    __syncthreads();  // step s has landed; step s - 1's stage is read
    issue(s + 2);
    gather::cp_async_commit();
    const float* as = base + (s % kF32Stages) * (kF32Stage / 4);
    tc::step_tf32<2, 4, kLDA, kLDB, 64>(acc, as, as + kBM * kLDA, wm, wn, lane);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = m0 + wm * 32 + mt * 16;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      put4(y, ldy, static_cast<int64_t>(i) * BS + r, BS - r, lane / 4, lane % 4,
           n0 + wn * 32 + nt * 8, ldy, acc[mt][nt], item.w != 0);
    }
  }
}

// ---------------------------------------------------------------- launch

constexpr size_t kWgSmem = kWgStages * kWgStageBytes + 1024;  // and 1 KB to align
constexpr size_t kF32Smem = kF32Stages * kF32Stage;

const void* kernel_of(int mode) {
  switch (mode) {
    case 0: return reinterpret_cast<const void*>(bell_tf32_kernel);
    case 1: return reinterpret_cast<const void*>(bell_wgmma_kernel<false>);
    case 2: return reinterpret_cast<const void*>(bell_wgmma_kernel<true>);
    default: return nullptr;
  }
}

size_t smem_of(int mode) { return mode == 0 ? kF32Smem : kWgSmem; }
int threads_of(int mode) { return mode == 0 ? kF32Threads : kWgThreads; }

OptIn& optin_of(int mode) {  // one per kernel
  static OptIn optin[3];
  return optin[mode];
}

}  // namespace

extern "C" {

// y [MB*BS, ldy] (fp32, int32 in mode 2), zeroed by the caller: the items
// that share a row-block add into it.  work [n_items, 4] int32: (row-block,
// first block, end block, alone), the runs of each row-block's nb_p real
// blocks (a row-block with none has no item).  blkcol [MB, BMAX] int32;
// blkvals [MB, BMAX, BS, BS] of the mode's type: mode 0 (fp32) fp32, mode 1
// (bf16) bf16, mode 2 (int8) int8.  x: modes 0 and 1 X [NB*BS, ldx] (fp32,
// ldx a multiple of 4; bf16, a multiple of 8), mode 2 X^T [K, ldx] int8
// with ldx = NB*BS; 16-byte aligned.  Columns [0, ldy) of y are written (X
// reads zero past ldx, X^T past K rows); ldy a multiple of 4.  BS a
// multiple of 32.  Returns the cudaError_t of the launch (0 on success; no
// launch for no items).
int bell_spmm_launch(const void* blkcol, const void* blkvals, const void* work, const void* x,
                     void* y, int n_items, int BMAX, int BS, int K, int ldx, int ldy, int mode,
                     void* stream) {
  const void* kernel = kernel_of(mode);
  const int vec = mode == 1 ? 8 : mode == 0 ? 4 : 16;
  if (kernel == nullptr || BS <= 0 || BS % 32 || K <= 0 || n_items < 0 || ldy % 4 ||
      ldy < K || ldx % vec || (mode == 2 && ldx % BS) || (mode != 2 && ldx < K) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(blkvals) % 16 ||
      (ldy + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_items == 0) return 0;
  const cudaError_t err = optin_of(mode).ensure(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_items, (BS + kBM - 1) / kBM, (ldy + kBN - 1) / kBN);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bc = static_cast<const int*>(blkcol);
  const auto* w = static_cast<const int4*>(work);
  if (mode == 0) {
    bell_tf32_kernel<<<grid, kF32Threads, kF32Smem, s>>>(
        bc, static_cast<const float*>(blkvals), w, static_cast<const float*>(x),
        static_cast<float*>(y), BMAX, BS, ldx, ldy);
  } else if (mode == 1) {
    bell_wgmma_kernel<false><<<grid, kWgThreads, kWgSmem, s>>>(
        bc, static_cast<const uint8_t*>(blkvals), w, x, y, BMAX, BS, K, ldx, ldy);
  } else {
    bell_wgmma_kernel<true><<<grid, kWgThreads, kWgSmem, s>>>(
        bc, static_cast<const uint8_t*>(blkvals), w, x, y, BMAX, BS, K, ldx, ldy);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel of `mode` into out[0..4]: registers a thread, local (spill)
// bytes a thread, static shared bytes, dynamic shared bytes, blocks an SM
// holds.  Returns a cudaError_t.
int bell_spmm_info(int mode, int* out) {
  const void* kernel = kernel_of(mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = optin_of(mode).ensure(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads_of(mode),
                                                      smem_of(mode));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(smem_of(mode));
  out[4] = blocks;
  return 0;
}

}  // extern "C"
