// dgt_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/dgt_gather.py, one kernel behind one entry point:
//   dgt_spmm_launch  replaces _dgt_kernel        (dgt_gather.py:667), kt
//                    8/16/32, modes fp32x2 and bf16, resid on or off, and
//                    _dgt_kernel_stream (dgt_gather.py:882), the same Y for
//                    resid formats with X windows streamed.
//
// Function.  The format is the JAX package's DgtFormat: P programs of NC
// chunks of G slots, T = G/128 tiles of 128 slots per chunk.  wins
// [P,NC,T] holds each tile's window base in units of 128 columns; cols
// [P,NC,G] a slot's lane within its window | sel << 7, sel < nw the
// window's offset from the base; lrw [P,NC,G] the row (lrow // ngrp when
// resid, where the row's class lrow % ngrp is the slot's position s % ngrp
// in its chunk); vals [P,NC,G] the value, 0 in padding slots; nc_p [P] the
// real chunk count.  For each program p, chunk j < nc_p[p] and slot s
// whose value v is not zero:
//     col = (wins[p,j,s/128] + (cols >> 7)) * 128 + (cols & 127)
//     row = resid ? lrw * ngrp + s % ngrp : lrw
//     y_rows[p*rb + row, k] += v * X[col, k]
// for every column k.  That is what the TPU kernels' window slices, lane
// gathers, select tree, static residue masks and one-hot MXU scatter
// reconstruct; none of that mechanism is needed on the card, where a lane
// loads the row of X it needs.
//
// Precision.  fp32x2: product and sum in fp32 (the TPU's hi/lo bf16 split
// kept about 16 bits of each product).  bf16: each product rounded to bf16,
// summed in fp32.
//
// Design: row_walk.cuh's row walk kernel.  The wrapper decodes (col, row)
// above once per pattern into the format's row walk (the live slots in
// (row, slot) order); the kernel walks it once per panel of up to 512
// columns, sums each row run in registers and adds it into y_rows by
// float4 atomics.  The split-row pieces are rows of y_rows like any other,
// so the pyramid unpack is unchanged.  At K = 1 (SpMV) the wrapper asks
// for 4 columns of the kt-padded X: one float4 a slot.  The TPU's stream
// variant fetched each tile's nw windows as their own X blocks because X
// could not stay in VMEM; on the card X is read where a slot needs it,
// through the 50 MB L2, so the stream wrapper launches the same walk (one
// walk per format for both wrappers) and nw changes nothing.
//
// Bound.  Memory: the walk's 12 bytes a live slot (row, column, value; with
// a caller's plane the slot index and a gathered value), plus the X rows
// gathered and Y; 2 flops per slot and column.  See PERF.md for the times
// against the bound on the card.

#include "row_walk.cuh"

extern "C" {

// The row walk kernel over the S slots of a walk (row, col, slot int32
// [S]): values vals[slot[i]] from a value plane with gather, else the
// walk's own vals[i]; y [rows, ld] must be zeroed; x is [N, ld] fp32; the
// first kc columns in panels of pw, bs slots a block.  Returns the
// cudaError_t of the launch (0 on success).
int dgt_spmm_launch(const void* row, const void* col, const void* slot, const void* vals,
                    const void* x, void* y, int S, int ld, int kc, int pw, int bf16, int bs,
                    int gather, void* stream) {
  return runs::walk_launch(row, col, slot, vals, x, y, S, ld, kc, pw, bf16, bs, gather, stream);
}

// The row walk kernel of (pw, bf16) into out[0..3]: registers a thread,
// local (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int dgt_walk_info(int pw, int bf16, int* out) {
  return runs::kernel_info(runs::walk_kernel_of(pw, bf16), out);
}

}  // extern "C"
