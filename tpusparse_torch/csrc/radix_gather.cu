// radix_gather.cu - the Hopper counterpart of the TPU kernel in
// tpusparse/kernels/radix_gather.py:
//   radix_walk_launch  replaces _radix_kernel (radix_gather.py:441) for X of
//                      2 columns and more (kt 2-32, or kt 1 past one column);
//   radix_spmv_launch  replaces it for x of one column (kt 1: SpMV "radix").
// Both serve the radix_span and brick_ell families, in modes fp32x2 and
// bf16, and launch a kernel of row_walk.cuh over the format's row walk.
//
// Function.  The format is the JAX package's RadixFormat: P programs of NC
// chunks of G slots; c0 [P,1,NC] holds each chunk's window start column (a
// multiple of 8*spr), cols/lrow/vals [P,NC,G] each slot's column offset in
// the window, program-local row and value; nc_p [P] the real chunk count
// of each program.  For each program p, chunk j < nc_p[p] and slot s whose
// value v is not zero:
//     y_rows[p*rb + lrow, k] += v * X[c0[p,j] + cols, k]
// for every column k of X.  The TPU kernel reached the same sum through X
// packed spr rows to a 128-lane word and three one-hot MXU dots (gather,
// collapse, scatter) over K-tiles of kt, with the product split into hi/lo
// bf16; that is mechanism of the TPU, not of the function, and none of it
// is needed where a lane loads the row of X it needs.
//
// Precision.  fp32x2: product and sum in fp32.  bf16: each fp32 product is
// rounded to bf16 once and summed in fp32 (radix_gather.py:33-37).
//
// Design.  A slot decodes as dg's and span's do (column c0 + cols, row
// p*rb + lrow), so the format gets the same row walk (kernels/row_walk.py:
// its live slots listed once per pattern in (row, slot) order, kept on the
// format) and the same two kernels:
//   radix_walk_launch: walk_kernel, all of X's columns in one walk (panels
//   of up to 512), each row run summed in registers and added by float4
//   atomics.  X of 2 columns arrives padded to 4 (one 32-byte sector a
//   gathered row either way).
//   radix_spmv_launch: walk1_kernel, a warp's 32 lanes on 32 neighbouring
//   slots, row runs summed by a segmented warp scan and added by one
//   scalar atomic each; its bf16 flavour rounds each product.
// Neither has a shared atomic.  The kernel this replaces walked every slot
// of a chunk, padding included (3.49 slots for every nonzero of the SpMV
// workload's radix format), and added each product by a shared-memory
// atomic (a CAS loop on this card) into an [rb, kt] row tile per K-tile.
//
// Bound.  Memory: the walk's 12 bytes a live slot (row, column, value; with
// a caller's plane the slot index and a gathered value), the X rows
// gathered and Y; 2 flops per slot and column.  See PERF.md for the times
// against the bound on the card.

#include "row_walk.cuh"

extern "C" {

// The row walk kernel over the S slots of a walk (row, col, slot int32
// [S]): values vals[slot[i]] from a value plane with gather, else the
// walk's own vals[i]; y [rows, ld] must be zeroed; x is [N, ld] fp32; the
// first kc columns in panels of pw, bs slots a block.  Returns the
// cudaError_t of the launch (0 on success).
int radix_walk_launch(const void* row, const void* col, const void* slot, const void* vals,
                      const void* x, void* y, int S, int ld, int kc, int pw, int bf16, int bs,
                      int gather, void* stream) {
  return runs::walk_launch(row, col, slot, vals, x, y, S, ld, kc, pw, bf16, bs, gather, stream);
}

// The one-column walk kernel over the S slots of a walk: as dg_spmv_launch
// (dg_gather.cu), bf16 rounding each product.  Returns the cudaError_t of
// the launch.
int radix_spmv_launch(const void* row, const void* col, const void* slot, const void* vals,
                      const void* x, void* y, int S, int spw, int wpb, int steps, int gather,
                      int bf16, void* stream) {
  return runs::by_steps(steps, [&](auto u) {
    return runs::walk1_launch<decltype(u)::value>(row, col, slot, vals, x, y, S, spw, wpb,
                                                  gather, bf16, stream);
  });
}

// The row walk kernel of (pw, bf16) into out[0..3]: registers a thread,
// local (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int radix_walk_info(int pw, int bf16, int* out) {
  return runs::kernel_info(runs::walk_kernel_of(pw, bf16), out);
}

// The one-column walk kernel of `steps` at wpb warps a block, products
// rounded to bf16 or not, into out[0..3] as radix_walk_info.
int radix_walk1_info(int steps, int wpb, int bf16, int* out) {
  if (wpb < 1 || wpb > runs::kThreads / 32) return static_cast<int>(cudaErrorInvalidValue);
  return runs::by_steps(steps, [&](auto u) {
    return runs::kernel_info(runs::walk1_kernel_of<decltype(u)::value>(bf16), out, 32 * wpb);
  });
}

}  // extern "C"
