// stripe_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/stripe_gather.py:
//   stripe_spmm_launch    replaces _stripe_kernel        (stripe_gather.py:35),
//                         which also serves nnz_split.segment_spmm;
//   stripe_nested_launch  replaces _stripe_nested_kernel (stripe_gather.py:156).
//
// Function.  StripeFormat: P stripes of C slots; cols/lrow/vals [P,1,C] hold
// each slot's global column, stripe-local row and value (padding: value 0,
// column a real one).  For each stripe p and slot i whose value v is not 0:
//     y_slots[p*rb + lrow[p,i], t*KT + k] += v * X[cols[p,i], t*KT + k]
// for every K-tile t and k < KT, rb the most rows a stripe holds.  Every
// entry of y_slots is written (zero where no slot adds), so y_slots needs no
// zero fill.  The segment path passes its SegmentFormat (lrow = segment id
// within the block, rb = max_segments) to the same launch.
// NestedStripeFormat adds wnz/wrow [P,1,W+1]: the stripe's warp sub-block w
// holds slots [wnz[w], wnz[w+1]) whose rows are wrow[w] + lrow.
//
// Precision.  The value (fp32, or bf16 widened exactly) times X in fp32,
// summed in fp32, as the TPU kernel's `v.astype(f32) * x` (acc_dtype f32).
//
// Design (simple and right first).  Stripes are row-aligned: no row of y
// belongs to two stripes, so one block per (stripe, K-tile) owns its rows
// outright.  That is the reference's own total-reduce template
// (stripe_gather.py:3-7; SURVEY.md section 2.4): the block keeps the
// stripe's [rb, KT] row tile in shared memory, its threads stride the
// stripe's slots (KT/4 threads per slot, each one 16-byte load of X; below
// KT = 4 one thread loads the slot's whole row) and add with shared-memory
// atomics, and the tile is stored to y once, with plain stores.  lrow is
// loaded, not computed: the TPU's model-driven index compression
// (tpusparse/config.py:59) changes no Y and is not ported.  Where the tile
// passes the opt-in limit the same kernel zeroes its rows of y and adds with
// global atomics; still no other block touches them.  The nested kernel maps
// each WARP sub-block onto a CUDA warp, the reference's TBLOCK > WARP loop
// (stripe_gather.py:158-162): warp w of the block takes sub-blocks w, w + 8,
// ... and its lanes stride the sub-block's slots.
//
// Bound.  Memory: 12 bytes per slot (cols, lrow, vals; 10 with bf16 values),
// the X rows gathered and y_slots written once; 2 flops per live slot and
// column.  See PERF.md for its time against the bound on the card.

#include "gather_common.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Zeroes the block's rows of K-tile t: the shared tile, or y itself in the
// global-atomic branch.  Ends in a barrier.
template <int KT, bool SHARED_TILE>
__device__ __forceinline__ void zero_rows(float* tile, float* yprog, int rb, int Kp, int t) {
  if constexpr (SHARED_TILE) {
    gather::zero_tile<KT>(tile, rb);
  } else {
    for (int e = threadIdx.x; e < rb * KT; e += kThreads) {
      yprog[static_cast<int64_t>(e / KT) * Kp + t * KT + e % KT] = 0.f;
    }
    __syncthreads();
  }
}

// Stores the shared tile into the block's rows of y (nothing to do in the
// global-atomic branch).
template <int KT, bool SHARED_TILE>
__device__ __forceinline__ void store_rows(const float* tile, float* yprog, int rb, int Kp,
                                           int t) {
  if constexpr (SHARED_TILE) {
    __syncthreads();
    for (int e = threadIdx.x; e < rb * KT; e += kThreads) {
      yprog[static_cast<int64_t>(e / KT) * Kp + t * KT + e % KT] = tile[e];
    }
  }
}

template <int KT, typename VT, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
stripe_kernel(const int* __restrict__ cols, const int* __restrict__ lrow,
              const VT* __restrict__ vals, const float* __restrict__ x, float* __restrict__ y,
              int C, int rb, int N, int Kp) {
  constexpr int VEC = gather::kVec<KT>;
  constexpr int TPS = KT / VEC;        // threads per slot
  constexpr int SPI = kThreads / TPS;  // slots per block iteration
  float* tile = reinterpret_cast<float*>(gather::gather_smem);  // [rb, KT]
  const int p = blockIdx.x;
  const int t = blockIdx.y;
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  zero_rows<KT, SHARED_TILE>(tile, yprog, rb, Kp, t);

  const int tcol = (threadIdx.x % TPS) * VEC;
  const int kcol = t * KT + tcol;
  const int64_t base = static_cast<int64_t>(p) * C;
  for (int i = threadIdx.x / TPS; i < C; i += SPI) {
    const float v = widen(vals[base + i]);
    const int64_t col = cols[base + i];
    if (v == 0.f || col >= N) continue;
    float xv[VEC];
    gather::load_x<VEC>(x + col * Kp + kcol, xv);
    gather::scatter<KT, VEC, false, SHARED_TILE>(tile, yprog, lrow[base + i], tcol, kcol, Kp,
                                                 v, xv);
  }
  store_rows<KT, SHARED_TILE>(tile, yprog, rb, Kp, t);
}

template <int KT, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
stripe_nested_kernel(const int* __restrict__ cols, const int* __restrict__ lrow,
                     const float* __restrict__ vals, const int* __restrict__ wnz,
                     const int* __restrict__ wrow, const float* __restrict__ x,
                     float* __restrict__ y, int C, int W, int rb, int N, int Kp) {
  constexpr int VEC = gather::kVec<KT>;
  constexpr int TPS = KT / VEC;  // lanes per slot
  constexpr int SPW = 32 / TPS;  // slots per warp iteration
  float* tile = reinterpret_cast<float*>(gather::gather_smem);  // [rb, KT]
  const int p = blockIdx.x;
  const int t = blockIdx.y;
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  zero_rows<KT, SHARED_TILE>(tile, yprog, rb, Kp, t);

  const int lane = threadIdx.x % 32;
  const int tcol = (lane % TPS) * VEC;
  const int kcol = t * KT + tcol;
  const int64_t base = static_cast<int64_t>(p) * C;
  const int* wz = wnz + static_cast<int64_t>(p) * (W + 1);
  const int* wr = wrow + static_cast<int64_t>(p) * (W + 1);
  for (int w = threadIdx.x / 32; w < W; w += kWarps) {
    const int hi = wz[w + 1];
    const int row0 = wr[w];
    for (int i = wz[w] + lane / TPS; i < hi; i += SPW) {
      const float v = vals[base + i];
      const int64_t col = cols[base + i];
      if (v == 0.f || col >= N) continue;
      float xv[VEC];
      gather::load_x<VEC>(x + col * Kp + kcol, xv);
      gather::scatter<KT, VEC, false, SHARED_TILE>(tile, yprog, row0 + lrow[base + i], tcol,
                                                   kcol, Kp, v, xv);
    }
  }
  store_rows<KT, SHARED_TILE>(tile, yprog, rb, Kp, t);
}

template <int KT, typename VT>
int launch_stripe(const int* cols, const int* lrow, const VT* vals, const float* x, float* y,
                  int P, int C, int rb, int N, int Kp, cudaStream_t stream) {
  static OptIn optin;  // of this instantiation's shared-tile kernel
  return gather::launch_tiled(stripe_kernel<KT, VT, true>, stripe_kernel<KT, VT, false>, optin,
                              dim3(P, Kp / KT), gather::tile_bytes(rb, KT), 0, stream, cols,
                              lrow, vals, x, y, C, rb, N, Kp);
}

template <int KT>
int launch_nested(const int* cols, const int* lrow, const float* vals, const int* wnz,
                  const int* wrow, const float* x, float* y, int P, int C, int W, int rb, int N,
                  int Kp, cudaStream_t stream) {
  static OptIn optin;
  return gather::launch_tiled(stripe_nested_kernel<KT, true>, stripe_nested_kernel<KT, false>,
                              optin, dim3(P, Kp / KT), gather::tile_bytes(rb, KT), 0, stream,
                              cols, lrow, vals, wnz, wrow, x, y, C, W, rb, N, Kp);
}

}  // namespace

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] tile in shared memory,
// 0 when it takes the global-atomic branch.
int stripe_uses_shared_tile(int rb, int kt) {
  return gather::tile_bytes(rb, kt) <= static_cast<size_t>(gather::optin_shared_bytes());
}

// y [P*rb, Kp] (written whole, no zero fill needed); x is [N, Kp] fp32, Kp a
// multiple of kt in {1, 2, 4, 8, 16, 32}; vals fp32, or bf16 when
// bf16_vals.  Returns the cudaError_t of the launch (0 on success).
int stripe_spmm_launch(const void* cols, const void* lrow, const void* vals, const void* x,
                       void* y, int P, int C, int rb, int N, int Kp, int kt, int bf16_vals,
                       void* stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* l = static_cast<const int*>(lrow);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(vals);
  const auto* vb = static_cast<const __nv_bfloat16*>(vals);
#define STRIPE_CASE(KT)                                                              \
  if (kt == KT) {                                                                    \
    return bf16_vals ? launch_stripe<KT>(c, l, vb, x_, y_, P, C, rb, N, Kp, s)       \
                     : launch_stripe<KT>(c, l, vf, x_, y_, P, C, rb, N, Kp, s);      \
  }
  STRIPE_CASE(1)
  STRIPE_CASE(2)
  STRIPE_CASE(4)
  STRIPE_CASE(8)
  STRIPE_CASE(16)
  STRIPE_CASE(32)
#undef STRIPE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The nested kernel: wnz/wrow [P, W+1]; the rest as stripe_spmm_launch
// (fp32 values).
int stripe_nested_launch(const void* cols, const void* lrow, const void* vals, const void* wnz,
                         const void* wrow, const void* x, void* y, int P, int C, int W, int rb,
                         int N, int Kp, int kt, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* l = static_cast<const int*>(lrow);
  const auto* v = static_cast<const float*>(vals);
  const auto* wz = static_cast<const int*>(wnz);
  const auto* wr = static_cast<const int*>(wrow);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
#define NESTED_CASE(KT) \
  if (kt == KT) return launch_nested<KT>(c, l, v, wz, wr, x_, y_, P, C, W, rb, N, Kp, s);
  NESTED_CASE(1)
  NESTED_CASE(2)
  NESTED_CASE(4)
  NESTED_CASE(8)
  NESTED_CASE(16)
  NESTED_CASE(32)
#undef NESTED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
