// dg_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/dg_gather.py:
//   dg_walk_launch  replaces _dg_kernel  (dg_gather.py:318), kt 8/16/32,
//                   modes fp32x2 and bf16;
//   dg_spmv_launch  replaces _dg1_kernel (dg_gather.py:382), kt 1 (SpMV).
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
// Design.
//   dg_walk_launch: row_walk.cuh's row walk kernel, as dgt_gather.cu and
//   span_gather.cu launch it.  A dg chunk is sorted by column, so in slot
//   order almost every slot is a row run of its own; the wrapper lists the
//   live slots once per pattern in (row, slot) order (the format's row
//   walk, kernels/row_walk.py) and the kernel walks them once per panel of
//   up to 512 columns, each row run summed in registers and added into
//   y_rows by float4 atomics: one walk for K = 64, where the shared row
//   tile of gather_common.cuh took two (one per K-tile of 32), each with a
//   shared CAS add per slot and column, and rb = 2048 at KT = 32 fell to
//   global atomics.
//   dg_spmv_launch: gather_common.cuh's gather_kernel at KT = 1 with its
//   WindowSlots decode (column c0 + cols, shared with radix_gather.cu): an
//   [rb] row tile in shared memory, per-slot shared atomics.
//
// Bound.  Memory: the walk's 12 bytes a live slot (row, column, value; with
// a caller's plane the slot index and a gathered value), or 12 bytes per
// slot of the format (SpMV), plus the X rows gathered and Y; 2 flops per
// slot and column.  See PERF.md for the times against the bound on the card.

#include "gather_common.cuh"
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

// y [P*rb] must be zeroed; x is [N] fp32.
int dg_spmv_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
                   const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                   int N, int splits, void* stream) {
  const gather::WindowSlots slots{static_cast<const int*>(c0), static_cast<const int*>(cols),
                                  static_cast<const int*>(lrow), N};
  return gather::launch_window_kt<1, false>(
      slots, static_cast<const float*>(vals), static_cast<const int*>(nc_p),
      static_cast<const float*>(x), static_cast<float*>(y), P, NC, G, rb, 1, splits,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
