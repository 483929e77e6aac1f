// stripe_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/stripe_gather.py:
//   stripe_spmm_launch    replaces _stripe_kernel        (stripe_gather.py:35),
//                         which also serves nnz_split.segment_spmm;
//   stripe_nested_launch  replaces _stripe_nested_kernel (stripe_gather.py:156).
//
// Function.  StripeFormat: P stripes of C slots; cols/lrow/vals [P,1,C] hold
// each slot's global column, stripe-local row and value (padding: value 0,
// column a real one), live_p [P] the stripe's slots that hold an entry of
// the COO, always its first ones (format.py: live_counts).  For each stripe
// p and slot i < live_p[p] whose value v is not 0:
//     y_slots[p*rb + lrow[p,i], k] += v * X[cols[p,i], k]
// for every column k, rb the most rows a stripe holds.  y_slots must be
// zeroed first.  The segment path passes its SegmentFormat (lrow = segment
// id within the block, rb = max_segments) to the same launch.
// NestedStripeFormat adds wnz/wrow [P,1,W+1]: the stripe's warp sub-block w
// holds slots [wnz[w], wnz[w+1]) whose rows are wrow[w] + lrow; slots past
// wnz[W] are not walked.
//
// Precision.  The value (fp32, or bf16 widened exactly) times X in fp32,
// summed in fp32, as the TPU kernel's `v.astype(f32) * x` (acc_dtype f32).
//
// Design of both kernels: row_runs.cuh's slot streams.  The stripe
// formats keep a row's slots together (a stripe's lrow never falls in slot
// order: 32,768 runs for config #1's 1.0M slots), so a stream sums each
// row run in registers and adds it into y_slots once, by float4 atomicAdd
// (REDG.E.ADD.F32x4): no shared memory, no shared atomics.  One block per
// stripe and K-tile, threads adding each product into a shared row tile,
// left the card empty (410 blocks of 6264 slots at config #1) and made
// every add a CAS loop.  So each stripe is cut into blocks of `bs` slots
// (the wrappers' choice: the row walk's 2048 slots up to 8 columns, 1024,
// 512 at 256-512 columns for the stripe kernel; 1024 for the nested one)
// and walked once per panel of PW columns:
//   - grid (slot range, stripe, panel of PW columns); the ranges a block
//     takes end at the stripe's live part (the stripe kernel: live_p[p];
//     the nested kernel: its last sub-block, wnz[W]), and a block past it
//     exits at once, so the uniform padding (2.6-4.5x the live slots on
//     the repo's stripe formats) is never read;
//   - a run that crosses a block's or stream's boundary is added once by
//     each part, into the zeroed y_slots;
//   - Kp is a multiple of 4 (the wrapper pads X of 1 or 2 columns to 4: a
//     gathered row costs one 32-byte sector either way); PW is the
//     narrowest of 4..512 that holds Kp.
// The nested kernel's stripes are cut as the reference's TBLOCK > WARP
// loop reads them: a lane finds its first slot's sub-block by binary
// search on wnz and then keeps a cursor (its range rises), through empty
// sub-blocks too; wnz/wrow stay in device memory, read through L1 (W + 1
// entries a stripe), so W is not bounded by shared memory.
//
// Bound.  Memory: 12 bytes per live slot (cols, lrow, vals; 10 with bf16
// values), the X rows gathered and y_slots written once; 2 flops per live
// slot and column.  See PERF.md for the times against the bound.

#include "row_runs.cuh"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The stripe kernel: block (b, p, panel) takes the slots [b*bs, (b+1)*bs)
// of stripe p that lie below live[p]; a block past them exits at once.
template <int PW, typename VT>
__global__ void __launch_bounds__(runs::kThreads, runs::kMinBlocks<PW>)
stripe_kernel(const int* __restrict__ cols, const int* __restrict__ lrow,
              const VT* __restrict__ vals, const int* __restrict__ live,
              const float* __restrict__ x, float* __restrict__ y, int C, int rb, int N, int Kp,
              int bs) {
  const int p = blockIdx.y;
  const int lo = static_cast<int>(blockIdx.x) * bs;
  const int hi = min(lo + bs, live[p]);
  if (lo >= hi) return;
  int s0, s1;
  runs::stream_range<PW>(lo, hi, s0, s1);
  const int64_t base = static_cast<int64_t>(p) * C;
  auto slot = [&](int i, float& v, int& col, int& row) {
    v = widen(vals[base + i]);
    col = cols[base + i];
    row = lrow[base + i];
    if (col >= N) v = 0.f;
  };
  runs::walk<PW, false>(slot, s0, s1, x, y + static_cast<int64_t>(p) * rb * Kp, Kp, Kp,
                        static_cast<int>(blockIdx.z) * PW);
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

// The stripe kernel for a panel of pw columns (4, 8, ..., 512), or nullptr.
template <typename VT>
const void* stripe_kernel_of(int pw) {
  switch (pw) {
    case 4: return reinterpret_cast<const void*>(stripe_kernel<4, VT>);
    case 8: return reinterpret_cast<const void*>(stripe_kernel<8, VT>);
    case 16: return reinterpret_cast<const void*>(stripe_kernel<16, VT>);
    case 32: return reinterpret_cast<const void*>(stripe_kernel<32, VT>);
    case 64: return reinterpret_cast<const void*>(stripe_kernel<64, VT>);
    case 128: return reinterpret_cast<const void*>(stripe_kernel<128, VT>);
    case 256: return reinterpret_cast<const void*>(stripe_kernel<256, VT>);
    case 512: return reinterpret_cast<const void*>(stripe_kernel<512, VT>);
    default: return nullptr;
  }
}

const void* stripe_kernel_of(int pw, int bf16_vals) {
  return bf16_vals ? stripe_kernel_of<__nv_bfloat16>(pw) : stripe_kernel_of<float>(pw);
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

}  // namespace

extern "C" {

// The stripe kernel: live [P] int32, vals fp32, or bf16 when bf16_vals; x
// [N, Kp] fp32 with Kp a multiple of 4; walked once per panel of pw
// columns (4, 8, ..., 512), `bs` slots of a stripe a block.  y [P*rb, Kp]
// must be zeroed.  Returns the cudaError_t of the launch (0 on success).
int stripe_spmm_launch(const void* cols, const void* lrow, const void* vals, const void* live,
                       const void* x, void* y, int P, int C, int rb, int N, int Kp, int pw,
                       int bs, int bf16_vals, void* stream) {
  const void* kernel = stripe_kernel_of(pw, bf16_vals);
  if (kernel == nullptr || Kp % 4 || bs < 1 || P < 1 || C < 1 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((C + bs - 1) / bs, P, (Kp + pw - 1) / pw);
  const auto* c = static_cast<const int*>(cols);
  const auto* l = static_cast<const int*>(lrow);
  const auto* lv = static_cast<const int*>(live);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  void* args[] = {&c, &l, &vals, &lv, &x_, &y_, &C, &rb, &N, &Kp, &bs};
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(runs::kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The stripe kernel of panel pw (bf16 values when bf16_vals) into
// out[0..3]: registers a thread, local (spill) bytes a thread, static
// shared bytes, blocks an SM holds.  Returns a cudaError_t.
int stripe_info(int pw, int bf16_vals, int* out) {
  return runs::kernel_info(stripe_kernel_of(pw, bf16_vals), out);
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
