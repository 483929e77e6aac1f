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
// with X [NB*BS, K] and y [MB*BS, K], written whole.  nb_p[i] counts the
// row-block's real blocks: the padded slots that follow them hold zero
// blocks at block-column 0, which the TPU multiplies and this kernel skips.
//
// Precision.  fp32: fp32 products and sums.  bf16 (ROUND): the value and X
// rounded to bf16 (round to nearest even), their exact product summed in
// fp32, as the TPU's bf16 dot with an fp32 result.  int8: int8 values times
// int8 X (the wrapper's per-column quantization), summed exactly in int32;
// the wrapper applies the rank-1 rescale afterwards.
//
// Design (simple and right first).  The TPU streams one (BS, ktile) X tile
// per grid step through a scalar-prefetched index map and accumulates into
// its revisited output block; blocks here run in parallel, so one block
// owns a 64-row x 64-column tile of y (a share of one row-block) and loops
// over the row-block's blocks itself.  Each 32-wide step of the
// contraction stages the A sub-tile [64, 32] and the X sub-tile [32, 64] in
// shared memory (converted, and rounded in the bf16 mode, once); each thread
// owns a 4 x 4 register tile of y and takes one A column of four values and
// one 16-byte X row slice per step.  CUDA cores only; tensor cores (mma,
// wgmma) and TMA are later work.
//
// Bound.  Memory: the real blocks, X and y once; 2 flops per real block
// entry and column.  See PERF.md for its time against the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // rows of y per block
constexpr int kBN = 64;  // columns of y per block
constexpr int kBK = 32;  // contraction step
constexpr int kT = 4;    // a thread's register tile: kT x kT

__device__ __forceinline__ float stage(float v, bool round) {
  return round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ float stage(__nv_bfloat16 v, bool) { return __bfloat162float(v); }
__device__ __forceinline__ int stage(int8_t v, bool) { return v; }

// AT: block value type (float, bf16, int8); XT: X type (float or int8);
// ACC: float, or int for int8 operands.  ROUND: the bf16 mode.
template <typename AT, typename XT, typename ACC, bool ROUND>
__global__ void __launch_bounds__(kThreads)
bell_kernel(const int* __restrict__ blkcol, const AT* __restrict__ blkvals,
            const int* __restrict__ nb_p, const XT* __restrict__ x, ACC* __restrict__ y,
            int BMAX, int BS, int K) {
  __shared__ ACC as[kBM][kBK + 1];  // A sub-tile, padded: conflict-free stores
  __shared__ __align__(16) ACC xs[kBK][kBN];
  const int subs = (BS + kBM - 1) / kBM;
  const int i = blockIdx.x / subs;             // row-block
  const int r0 = (blockIdx.x % subs) * kBM;    // first row of the tile within it
  const int k0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % (kBN / kT);
  const int ty = threadIdx.x / (kBN / kT);
  ACC acc[kT][kT] = {};
  const int nb = nb_p[i];
  for (int j = 0; j < nb; ++j) {
    const int64_t slot = static_cast<int64_t>(i) * BMAX + j;
    const AT* ablk = blkvals + slot * BS * BS;
    const XT* xblk = x + static_cast<int64_t>(blkcol[slot]) * BS * K;
    for (int kk = 0; kk < BS; kk += kBK) {
      __syncthreads();  // the previous step is read
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        as[r][c] = r0 + r < BS
                       ? static_cast<ACC>(stage(ablk[static_cast<int64_t>(r0 + r) * BS + kk + c],
                                                ROUND))
                       : ACC(0);
      }
      for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
        const int r = e / kBN, c = e % kBN;
        xs[r][c] = k0 + c < K
                       ? static_cast<ACC>(stage(xblk[static_cast<int64_t>(kk + r) * K + k0 + c],
                                                ROUND))
                       : ACC(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) {
        ACC a[kT], b[kT];
#pragma unroll
        for (int t = 0; t < kT; ++t) a[t] = as[ty * kT + t][c];
#pragma unroll
        for (int t = 0; t < kT; ++t) b[t] = xs[c][tx * kT + t];
#pragma unroll
        for (int r = 0; r < kT; ++r) {
#pragma unroll
          for (int t = 0; t < kT; ++t) acc[r][t] += a[r] * b[t];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    const int row = r0 + ty * kT + r;
    if (row >= BS) continue;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int k = k0 + tx * kT + t;
      if (k < K) y[(static_cast<int64_t>(i) * BS + row) * K + k] = acc[r][t];
    }
  }
}

template <typename AT, typename XT, typename ACC, bool ROUND>
int launch(const void* blkcol, const void* blkvals, const void* nb_p, const void* x, void* y,
           int MB, int BMAX, int BS, int K, cudaStream_t stream) {
  const dim3 grid(MB * ((BS + kBM - 1) / kBM), (K + kBN - 1) / kBN);
  bell_kernel<AT, XT, ACC, ROUND><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(blkcol), static_cast<const AT*>(blkvals),
      static_cast<const int*>(nb_p), static_cast<const XT*>(x), static_cast<ACC*>(y), BMAX, BS,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y [MB*BS, K] (fp32, or int32 in mode 2), written whole.  blkcol [MB, BMAX]
// and nb_p [MB] int32; blkvals [MB, BMAX, BS, BS] of val_code 0 fp32, 1
// bf16, 2 int8; x [NB*BS, K], fp32 in modes 0 (fp32) and 1 (bf16), int8 in
// mode 2 (int8, with int8 values).  BS a multiple of 32.  Returns the
// cudaError_t of the launch (0 on success).
int bell_spmm_launch(const void* blkcol, const void* blkvals, const void* nb_p, const void* x,
                     void* y, int MB, int BMAX, int BS, int K, int val_code, int mode,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BS <= 0 || BS % kBK || K <= 0 || MB <= 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == 2) {
    if (val_code != 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch<int8_t, int8_t, int, false>(blkcol, blkvals, nb_p, x, y, MB, BMAX, BS, K, s);
  }
  const bool round = mode == 1;
#define BELL_CASE(AT)                                                                         \
  return round ? launch<AT, float, float, true>(blkcol, blkvals, nb_p, x, y, MB, BMAX, BS, K, s) \
               : launch<AT, float, float, false>(blkcol, blkvals, nb_p, x, y, MB, BMAX, BS, K, s);
  if (val_code == 0) { BELL_CASE(float) }
  if (val_code == 1) { BELL_CASE(__nv_bfloat16) }
#undef BELL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
