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
// for every K-tile t and k < KT, rb the most rows a stripe holds.  The
// stripe kernel writes every entry of y_slots (zero where no slot adds), so
// its y_slots needs no zero fill.  The segment path passes its SegmentFormat
// (lrow = segment id within the block, rb = max_segments) to the same launch.
// NestedStripeFormat adds wnz/wrow [P,1,W+1]: the stripe's warp sub-block w
// holds slots [wnz[w], wnz[w+1]) whose rows are wrow[w] + lrow; slots past
// wnz[W] are not walked.
//
// Precision.  The value (fp32, or bf16 widened exactly) times X in fp32,
// summed in fp32, as the TPU kernel's `v.astype(f32) * x` (acc_dtype f32).
//
// Design of the stripe kernel (simple and right first).  Stripes are
// row-aligned: no row of y belongs to two stripes, so one block per
// (stripe, K-tile) owns its rows outright.  That is the reference's own
// total-reduce template (stripe_gather.py:3-7; SURVEY.md section 2.4): the
// block keeps the stripe's [rb, KT] row tile in shared memory, its threads
// stride the stripe's slots (KT/4 threads per slot, each one 16-byte load
// of X; below KT = 4 one thread loads the slot's whole row) and add with
// shared-memory atomics, and the tile is stored to y once, with plain
// stores.  lrow is loaded, not computed: the TPU's model-driven index
// compression (tpusparse/config.py:59) changes no Y and is not ported.
// Where the tile passes the opt-in limit the same kernel zeroes its rows of
// y and adds with global atomics; still no other block touches them.
//
// Design of the nested kernel.  One block a stripe, a WARP sub-block to a
// CUDA warp, as the reference's TBLOCK > WARP loop reads, leaves the card
// empty: config #1 has 133 stripes for 132 SMs, one of 20000 slots, and a
// warp would walk a sub-block of thousands of slots alone; a shared row
// tile would add per-slot shared atomics, CAS loops for fp32 on this card.
// So this kernel cuts every stripe into blocks of `bs` slots (about 1024)
// and walks them with row_runs.cuh's streams, as the tile kernel does:
//   - grid (slot range, stripe, panel of PW columns); a range past the
//     stripe's last sub-block exits at once, so the largest stripe fills
//     about 20 blocks and the small ones one or two;
//   - a lane finds its first slot's sub-block by binary search on wnz and
//     then keeps a cursor (its range rises), through empty sub-blocks too;
//     wnz/wrow stay in device memory, read through L1 (W + 1 entries a
//     stripe), so W is not bounded by shared memory;
//   - the packer keeps COO order within a sub-block, so a row's slots are
//     consecutive; a run, which may cross a sub-block boundary, is summed in
//     registers and added once by float4 atomicAdd into the zeroed y_slots;
//   - Kp is a multiple of 4 (the wrapper pads X of 1 or 2 columns to 4: a
//     gathered row costs one 32-byte sector either way); PW is the
//     narrowest of 4..512 that holds Kp.
//
// Bound.  Memory: 12 bytes per slot (cols, lrow, vals; 10 with bf16 values),
// the X rows gathered and y_slots written once; 2 flops per live slot and
// column.  See PERF.md for its time against the bound on the card.

#include "gather_common.cuh"
#include "row_runs.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

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

// The nested kernel: block (b, p, panel) takes the slots [b*bs, (b+1)*bs)
// of stripe p that lie in its sub-blocks, [wnz[0], wnz[W]); a block past
// them exits at once.  Each lane keeps a cursor w over the stripe's
// sub-blocks (wnz[w] <= i < wnz[w+1] for its slot i, found once by binary
// search and moved forward as i rises), so slot i's row is wrow[w] + lrow.
template <int PW>
__global__ void __launch_bounds__(runs::kThreads, runs::kMinBlocks<PW>)
stripe_nested_kernel(const int* __restrict__ cols, const int* __restrict__ lrow,
                     const float* __restrict__ vals, const int* __restrict__ wnz,
                     const int* __restrict__ wrow, const float* __restrict__ x,
                     float* __restrict__ y, int C, int W, int rb, int N, int Kp, int bs) {
  const int p = blockIdx.y;
  const int* wz = wnz + static_cast<int64_t>(p) * (W + 1);
  const int* wr = wrow + static_cast<int64_t>(p) * (W + 1);
  const int lo = max(static_cast<int>(blockIdx.x) * bs, wz[0]);
  const int hi = min(static_cast<int>(blockIdx.x) * bs + bs, wz[W]);
  if (lo >= hi) return;
  int s0, s1;
  runs::stream_range<PW>(lo, hi, s0, s1);
  const int64_t base = static_cast<int64_t>(p) * C;
  int w = -1, nxt = 0, row0 = 0;  // this lane's sub-block, its end and base row
  auto slot = [&](int i, float& v, int& col, int& row) {
    if (w < 0) {  // the first slot: wz[w] <= i < wz[w + 1]
      int a = 0, b = W;
      while (b - a > 1) {
        const int m = (a + b) / 2;
        if (wz[m] <= i) a = m; else b = m;
      }
      w = a;
      nxt = wz[w + 1];
      row0 = wr[w];
    }
    while (i >= nxt) {  // empty sub-blocks are passed over
      ++w;
      nxt = wz[w + 1];
      row0 = wr[w];
    }
    v = vals[base + i];
    col = cols[base + i];
    row = row0 + lrow[base + i];
    if (col >= N) v = 0.f;
  };
  runs::walk<PW, false>(slot, s0, s1, x, y + static_cast<int64_t>(p) * rb * Kp, Kp,
                        Kp, static_cast<int>(blockIdx.z) * PW);
}

// The nested kernel for a panel of pw columns, or nullptr.
const void* nested_kernel(int pw) {
  switch (pw) {
    case 4: return reinterpret_cast<const void*>(stripe_nested_kernel<4>);
    case 8: return reinterpret_cast<const void*>(stripe_nested_kernel<8>);
    case 16: return reinterpret_cast<const void*>(stripe_nested_kernel<16>);
    case 32: return reinterpret_cast<const void*>(stripe_nested_kernel<32>);
    case 64: return reinterpret_cast<const void*>(stripe_nested_kernel<64>);
    case 128: return reinterpret_cast<const void*>(stripe_nested_kernel<128>);
    case 256: return reinterpret_cast<const void*>(stripe_nested_kernel<256>);
    case 512: return reinterpret_cast<const void*>(stripe_nested_kernel<512>);
    default: return nullptr;
  }
}

template <int KT, typename VT>
int launch_stripe(const int* cols, const int* lrow, const VT* vals, const float* x, float* y,
                  int P, int C, int rb, int N, int Kp, cudaStream_t stream) {
  static OptIn optin;  // of this instantiation's shared-tile kernel
  return gather::launch_tiled(stripe_kernel<KT, VT, true>, stripe_kernel<KT, VT, false>, optin,
                              dim3(P, Kp / KT), gather::tile_bytes(rb, KT), 0, stream, cols,
                              lrow, vals, x, y, C, rb, N, Kp);
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

// The nested kernel: wnz/wrow [P, W+1], vals fp32, x [N, Kp] fp32 with Kp a
// multiple of 4; walked once per panel of pw columns (4, 8, ..., 512), `bs`
// slots of a stripe a block.  y [P*rb, Kp] must be zeroed.  Returns the
// cudaError_t of the launch (0 on success).
int stripe_nested_launch(const void* cols, const void* lrow, const void* vals, const void* wnz,
                         const void* wrow, const void* x, void* y, int P, int C, int W, int rb,
                         int N, int Kp, int pw, int bs, void* stream) {
  const void* kernel = nested_kernel(pw);
  if (kernel == nullptr || Kp % 4 || bs < 1 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((C + bs - 1) / bs, P, (Kp + pw - 1) / pw);
  const auto* c = static_cast<const int*>(cols);
  const auto* l = static_cast<const int*>(lrow);
  const auto* v = static_cast<const float*>(vals);
  const auto* wz = static_cast<const int*>(wnz);
  const auto* wr = static_cast<const int*>(wrow);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  void* args[] = {&c, &l, &v, &wz, &wr, &x_, &y_, &C, &W, &rb, &N, &Kp, &bs};
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(runs::kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The nested kernel of panel pw into out[0..3]: registers a thread, local
// (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int stripe_nested_info(int pw, int* out) { return runs::kernel_info(nested_kernel(pw), out); }

}  // extern "C"
