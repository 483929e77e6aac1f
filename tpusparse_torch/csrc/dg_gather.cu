// dg_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/dg_gather.py:
//   dg_spmm_launch  replaces _dg_kernel  (dg_gather.py:318), kt 8/16/32,
//                   modes fp32x2 and bf16;
//   dg_spmv_launch  replaces _dg1_kernel (dg_gather.py:382), kt 1 (SpMV).
//
// Function.  The format is the JAX package's DgFormat: P programs of NC
// chunks of G slots; c0 [P,1,NC] holds each chunk's window start column,
// cols/lrow/vals [P,NC,G] each slot's column offset, program-local row and
// value; nc_p [P] the real chunk count of each program.  For each program
// p, chunk j < nc_p[p] and slot s whose value v is not zero:
//     y_rows[p*rb + lrow, t*KT + k] += v * X[c0[p,j] + cols, t*KT + k]
// for every K-tile t and k < KT.  That is what the TPU kernel's window
// arithmetic (x3 transpose, lane gather, select tree, hi/lo split and the
// (grp, hl, k) lane encoding) reconstructs; none of that mechanism is
// needed here, where a thread simply loads the row of X it needs.
// Slots past a chunk's fill (v = 0, cols = 0, lrow = 0) and chunks at or
// past nc_p[p] add nothing and are skipped.
//
// Precision.  fp32x2: product and sum in fp32 (the TPU's hi/lo bf16 split
// kept about 16 bits of each product, so this is at least its class).
// bf16: the fp32 product is rounded to bf16 (__float2bfloat16_rn) and summed
// in fp32, as `p.astype(bf16)` feeds the TPU kernel's fp32-accumulating dot.
//
// Design (simple and right first).  One block per (share s of program p's
// chunk range, program p, K-tile t): the TPU geometry gives few programs
// (P = 32 at the 32768-row headline with rb = 1024), so each program's chunks
// are split over `splits` blocks to fill 132 SMs.  A block's threads take
// the slots of a chunk in order; each slot is served by KT/4 threads that
// each load 4 contiguous floats of the slot's X row as one 16-byte load (a
// thread per slot with a scalar load at KT = 1).  Products go by shared
// atomics into an [rb, KT] fp32 tile in shared memory, which is then added
// into the zeroed y_rows with global atomics, skipping entries still zero.
// Where the tile exceeds the shared memory a block may opt into (rb = 2048
// at KT = 32 is 256 KB), the same kernel adds every product straight into
// y_rows with global atomics instead.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrow, vals) plus
// the X rows gathered and Y; the arithmetic is 2 flops per slot and column.
// See PERF.md for its time against the bound on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int KT, bool BF16, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
dg_kernel(const int* __restrict__ c0, const int* __restrict__ cols,
          const int* __restrict__ lrow, const float* __restrict__ vals,
          const int* __restrict__ nc_p, const float* __restrict__ x,
          float* __restrict__ y, int NC, int G, int rb, int Kp, int splits) {
  constexpr int VEC = KT >= 4 ? 4 : 1;   // floats per thread per slot
  constexpr int TPS = KT / VEC;          // threads per slot
  constexpr int SPI = kThreads / TPS;    // slots per block iteration
  extern __shared__ float tile[];        // [rb, KT] when SHARED_TILE

  const int p = blockIdx.y;
  const int t = blockIdx.z;
  const int ncp = nc_p[p];
  const int per = (ncp + splits - 1) / splits;
  const int j0 = min(static_cast<int>(blockIdx.x) * per, ncp);
  const int j1 = min(j0 + per, ncp);
  if (j0 >= j1) return;  // uniform over the block

  if constexpr (SHARED_TILE) {
    for (int e = threadIdx.x; e < rb * KT; e += kThreads) tile[e] = 0.f;
    __syncthreads();
  }

  const int sub = threadIdx.x % TPS;
  const int kcol = t * KT + sub * VEC;   // first column of X and Y this thread adds
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  for (int j = j0; j < j1; ++j) {
    const int64_t chunk = static_cast<int64_t>(p) * NC + j;
    const int64_t cstart = c0[chunk];
    const int64_t base = chunk * G;
    for (int s = threadIdx.x / TPS; s < G; s += SPI) {
      const float v = vals[base + s];
      if (v == 0.f) continue;
      const int64_t col = cstart + cols[base + s];
      const int r = lrow[base + s];
      const float* xp = x + col * Kp + kcol;
      float xv[VEC];
      if constexpr (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(xp);
        xv[0] = q.x; xv[1] = q.y; xv[2] = q.z; xv[3] = q.w;
      } else {
        xv[0] = xp[0];
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        float prod = v * xv[q];
        if constexpr (BF16) prod = __bfloat162float(__float2bfloat16_rn(prod));
        if constexpr (SHARED_TILE) {
          atomicAdd(&tile[r * KT + sub * VEC + q], prod);
        } else {
          atomicAdd(&yprog[static_cast<int64_t>(r) * Kp + kcol + q], prod);
        }
      }
    }
  }

  if constexpr (SHARED_TILE) {
    __syncthreads();
    for (int e = threadIdx.x; e < rb * KT; e += kThreads) {
      const float acc = tile[e];
      if (acc != 0.f) {
        atomicAdd(&yprog[static_cast<int64_t>(e / KT) * Kp + t * KT + e % KT], acc);
      }
    }
  }
}

int optin_shared_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <int KT, bool BF16>
int launch(const void* c0, const void* cols, const void* lrow, const void* vals,
           const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
           int Kp, int splits, cudaStream_t stream) {
  const dim3 grid(splits, P, Kp / KT);
  const size_t tile_bytes = static_cast<size_t>(rb) * KT * sizeof(float);
  const auto* c0_ = static_cast<const int*>(c0);
  const auto* cols_ = static_cast<const int*>(cols);
  const auto* lrow_ = static_cast<const int*>(lrow);
  const auto* vals_ = static_cast<const float*>(vals);
  const auto* ncp_ = static_cast<const int*>(nc_p);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  if (tile_bytes <= static_cast<size_t>(optin_shared_bytes())) {
    if (tile_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          dg_kernel<KT, BF16, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(tile_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dg_kernel<KT, BF16, true><<<grid, kThreads, tile_bytes, stream>>>(
        c0_, cols_, lrow_, vals_, ncp_, x_, y_, NC, G, rb, Kp, splits);
  } else {
    dg_kernel<KT, BF16, false><<<grid, kThreads, 0, stream>>>(
        c0_, cols_, lrow_, vals_, ncp_, x_, y_, NC, G, rb, Kp, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] tile in shared memory,
// 0 when it takes the global-atomic branch.
int dg_uses_shared_tile(int rb, int kt) {
  return static_cast<size_t>(rb) * kt * sizeof(float) <=
         static_cast<size_t>(optin_shared_bytes());
}

// y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a multiple of kt.
// Returns the cudaError_t of the launch (0 on success).
int dg_spmm_launch(const void* c0, const void* cols, const void* lrow,
                   const void* vals, const void* nc_p, const void* x, void* y,
                   int P, int NC, int G, int rb, int Kp, int kt, int bf16,
                   int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define DG_CASE(KT)                                                              \
  if (kt == KT) {                                                                \
    return bf16 ? launch<KT, true>(c0, cols, lrow, vals, nc_p, x, y, P, NC, G, rb, \
                                   Kp, splits, s)                                \
                : launch<KT, false>(c0, cols, lrow, vals, nc_p, x, y, P, NC, G,  \
                                    rb, Kp, splits, s);                          \
  }
  DG_CASE(8)
  DG_CASE(16)
  DG_CASE(32)
#undef DG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// y [P*rb] must be zeroed; x is [N] fp32.
int dg_spmv_launch(const void* c0, const void* cols, const void* lrow,
                   const void* vals, const void* nc_p, const void* x, void* y,
                   int P, int NC, int G, int rb, int splits, void* stream) {
  return launch<1, false>(c0, cols, lrow, vals, nc_p, x, y, P, NC, G, rb, 1, splits,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
