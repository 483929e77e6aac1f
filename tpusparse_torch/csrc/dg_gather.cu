// dg_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/dg_gather.py:
//   dg_walk_launch  replaces _dg_kernel  (dg_gather.py:318), kt 8/16/32,
//                   modes fp32x2 and bf16;
//   dg_spmv_launch  replaces _dg1_kernel (dg_gather.py:382), kt 1 (SpMV).
// Both launch a kernel of row_walk.cuh over the format's row walk.
//
// Function.  The format is the JAX package's DgFormat: P programs of NC
// chunks of G slots; c0 [P,1,NC] holds each chunk's window start column,
// cols/lrow/vals [P,NC,G] each slot's column offset, program-local row and
// value; nc_p [P] the real chunk count of each program.  For each program
// p, chunk j < nc_p[p] and slot s whose value v is not zero:
//     y_rows[p*rb + lrow, k] += v * X[c0[p,j] + cols, k]
// for every column k (a column at or past N is skipped).  That is what the
// TPU kernel's window arithmetic (x3 transpose, lane gather, select tree,
// hi/lo split and the (grp, hl, k) lane encoding) reconstructs over its
// kt-wide K-tiles; none of that mechanism is needed here, where a lane
// simply loads the row of X it needs.
//
// Precision.  fp32x2: product and sum in fp32 (the TPU's hi/lo bf16 split
// kept about 16 bits of each product, so this is at least its class).
// bf16: each product rounded to bf16, summed in fp32.
//
// Design.  Both kernels walk the format's row walk (row_walk.cuh): a dg
// chunk is sorted by column, so in slot order almost every slot is a row run
// of its own; the wrapper lists the live slots once per pattern in (row,
// slot) order (kernels/row_walk.py, kept on the format), and each row run
// is summed in registers and added into y_rows once.
//   dg_walk_launch: walk_kernel, as dgt_gather.cu and span_gather.cu launch
//   it, once per panel of up to 512 columns, each run added by float4
//   atomics: one walk for K = 64, where the shared row tile of
//   gather_common.cuh took two (one per K-tile of 32), each with a shared
//   CAS add per slot and column, and rb = 2048 at KT = 32 fell to global
//   atomics.
//   dg_spmv_launch: walk1_kernel, the one-column walk: a warp's 32 lanes on
//   32 neighbouring slots, runs summed by a segmented warp scan and added
//   by one scalar atomic each, none in shared memory (a shared fp32 add is
//   a CAS loop on this card).  x stays one column: walk_kernel would pad
//   it to 4 and read a float4 a slot.
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
int dg_walk_launch(const void* row, const void* col, const void* slot, const void* vals,
                   const void* x, void* y, int S, int ld, int kc, int pw, int bf16, int bs,
                   int gather, void* stream) {
  return runs::walk_launch(row, col, slot, vals, x, y, S, ld, kc, pw, bf16, bs, gather, stream);
}

// The row walk kernel of (pw, bf16) into out[0..3]: registers a thread,
// local (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int dg_walk_info(int pw, int bf16, int* out) {
  return runs::kernel_info(runs::walk_kernel_of(pw, bf16), out);
}

// The one-column walk kernel over the S slots of a walk (row, col, slot
// int32 [S]): values vals[slot[i]] from a value plane with gather, else the
// walk's own vals[i]; y [rows] must be zeroed; x is [N] fp32; spw slots a
// warp, wpb warps a block, `steps` steps of 32 slots loaded at once; bf16
// rounds each product.  Returns the cudaError_t of the launch (0 on
// success).
int dg_spmv_launch(const void* row, const void* col, const void* slot, const void* vals,
                   const void* x, void* y, int S, int spw, int wpb, int steps, int gather,
                   int bf16, void* stream) {
  return runs::by_steps(steps, [&](auto u) {
    return runs::walk1_launch<decltype(u)::value>(row, col, slot, vals, x, y, S, spw, wpb,
                                                  gather, bf16, stream);
  });
}

// The one-column walk kernel of `steps` at wpb warps a block into
// out[0..3]: registers a thread, local (spill) bytes a thread, static shared
// bytes, blocks an SM holds.  Returns a cudaError_t.
int dg_walk1_info(int steps, int wpb, int* out) {
  if (wpb < 1 || wpb > runs::kThreads / 32) return static_cast<int>(cudaErrorInvalidValue);
  return runs::by_steps(steps, [&](auto u) {
    return runs::kernel_info(runs::walk1_kernel_of<decltype(u)::value>(0), out, 32 * wpb);
  });
}

}  // extern "C"
