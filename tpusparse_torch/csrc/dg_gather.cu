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
// bf16: each product rounded to bf16, summed in fp32.
//
// Design (simple and right first): gather_common.cuh's gather_kernel with
// its WindowSlots decode (column c0 + cols, shared with radix_gather.cu).
// The [rb, KT] row tile lives in shared memory where it fits the opt-in
// limit; rb = 2048 at KT = 32 (256 KB) takes the global-atomic branch.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrow, vals) plus
// the X rows gathered and Y; the arithmetic is 2 flops per slot and column.
// See PERF.md for its time against the bound on the card.

#include "gather_common.cuh"

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] tile in shared memory,
// 0 when it takes the global-atomic branch.
int dg_uses_shared_tile(int rb, int kt) {
  return gather::tile_bytes(rb, kt) <= static_cast<size_t>(gather::optin_shared_bytes());
}

// y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a multiple of kt.
// Returns the cudaError_t of the launch (0 on success).
int dg_spmm_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
                   const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                   int N, int Kp, int kt, int bf16, int splits, void* stream) {
  if (kt == 1) return static_cast<int>(cudaErrorInvalidValue);
  const gather::WindowSlots slots{static_cast<const int*>(c0), static_cast<const int*>(cols),
                                  static_cast<const int*>(lrow), N};
  return gather::launch_window(slots, vals, nc_p, x, y, P, NC, G, rb, Kp, kt, bf16, splits,
                               stream);
}

// y [P*rb] must be zeroed; x is [N] fp32.
int dg_spmv_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
                   const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                   int N, int splits, void* stream) {
  const gather::WindowSlots slots{static_cast<const int*>(c0), static_cast<const int*>(cols),
                                  static_cast<const int*>(lrow), N};
  return gather::launch_window(slots, vals, nc_p, x, y, P, NC, G, rb, 1, 1, 0, splits, stream);
}

}  // extern "C"
