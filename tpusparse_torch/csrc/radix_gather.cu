// radix_gather.cu - the Hopper counterpart of the TPU kernel in
// tpusparse/kernels/radix_gather.py:
//   radix_spmm_launch  replaces _radix_kernel (radix_gather.py:441), kt 1, 2,
//                      4, 8, 16 or 32, modes fp32x2 and bf16.  It serves the
//                      radix_span and brick_ell families and SpMV "radix".
//
// Function.  The format is the JAX package's RadixFormat: P programs of NC
// chunks of G slots; c0 [P,1,NC] holds each chunk's window start column (a
// multiple of 8*spr), cols/lrow/vals [P,NC,G] each slot's column offset in
// the window, program-local row and value; nc_p [P] the real chunk count
// of each program.  For each program p, chunk j < nc_p[p] and slot s whose
// value v is not zero:
//     y_rows[p*rb + lrow, t*KT + k] += v * X[c0[p,j] + cols, t*KT + k]
// for every K-tile t and k < KT.  The TPU kernel reached the same sum
// through X packed spr rows to a 128-lane word and three one-hot MXU dots
// (gather, collapse, scatter) with the product split into hi/lo bf16; that
// is mechanism of the TPU, not of the function, and none of it is needed
// where a thread loads the row of X it needs.
//
// Precision.  fp32x2: product and sum in fp32.  bf16: each fp32 product is
// rounded to bf16 once and summed in fp32 (radix_gather.py:33-37).
//
// Design (simple and right first).  The slot decode is dg's and span's
// (column c0 + cols, row lrow), so this is gather_common.cuh's
// gather_kernel with the WindowSlots decode.  What radix adds is
// its own K-tiles: spmm's default takes radix only at K = 2 to 4, where the
// window kernels' KT of 8 would pad X two to four times and multiply the
// per-slot atomics alike.  So KT runs 1, 2, 4, 8, 16, 32; below 4 one thread
// carries a slot's whole row of X (one 8-byte load at KT = 2), at 4 one
// 16-byte load.  The [rb, KT] row tile lives in shared memory where it fits
// the opt-in limit (rb = 2048 at KT = 32 takes the global-atomic branch).
//
// Bound.  Memory: 12 bytes per slot of the format walked (cols, lrow,
// vals), 4 per chunk (c0), the X rows gathered and Y; 2 flops per live slot
// and column.  See PERF.md for its time against the bound on the card.

#include "gather_common.cuh"

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] tile in shared memory,
// 0 when it takes the global-atomic branch.
int radix_uses_shared_tile(int rb, int kt) {
  return gather::tile_bytes(rb, kt) <= static_cast<size_t>(gather::optin_shared_bytes());
}

// y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a multiple of kt.
// Returns the cudaError_t of the launch (0 on success).
int radix_spmm_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
                      const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                      int N, int Kp, int kt, int bf16, int splits, void* stream) {
  const gather::WindowSlots slots{static_cast<const int*>(c0), static_cast<const int*>(cols),
                                  static_cast<const int*>(lrow), N};
  const auto* v = static_cast<const float*>(vals);
  const auto* n = static_cast<const int*>(nc_p);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
#define RADIX_CASE(KT)                                                                      \
  if (kt == KT) {                                                                           \
    return bf16 ? gather::launch_window_kt<KT, true>(slots, v, n, x_, y_, P, NC, G, rb, Kp, \
                                                     splits, s)                             \
                : gather::launch_window_kt<KT, false>(slots, v, n, x_, y_, P, NC, G, rb, Kp, \
                                                      splits, s);                           \
  }
  RADIX_CASE(1)
  RADIX_CASE(2)
  RADIX_CASE(4)
  RADIX_CASE(8)
  RADIX_CASE(16)
  RADIX_CASE(32)
#undef RADIX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
