// span_gather.cu - the Hopper counterpart of the two TPU kernels in
// tpusparse/kernels/span_gather.py:
//   span_spmm_launch  replaces _span_kernel        (span_gather.py:270) and
//                     _span_kernel_stream (span_gather.py:329): both
//                     wrappers launch it, over the same row walk.
//   span_walk1_launch replaces _span_kernel for x of one column (span_spmm
//                     at K = 1, the SpMV "span"; kt 1), over the same row walk.
//
// Function.  The format is the JAX package's SpanFormat: P programs of NC
// chunks of G slots whose columns, sorted, fit one window; c0 [P,1,NC]
// holds each chunk's window start (a multiple of 8), cols [P,NC,G] a slot's
// column within the window (< ct), lrow [P,NC,G] its program-local row,
// vals [P,NC,G] its value (0 in padding) or the caller's value plane of the
// same shape; nc_p [P] the real chunk count of each program (the packer's
// chunk walk count).  For each program p, chunk j < nc_p[p] and slot s
// whose value v is not zero:
//     y_rows[p*rb + lrow, k] += v * X[c0[p,j] + cols, k]
// for every column k.  That is what the TPU kernel's one-hot MXU
// contractions over each chunk's [c0, c0+ct) window of X compute.  The
// window may run past N (the TPU padded X by ct rows); here no column at or
// past N is read.
//
// Precision.  fp32 and fp32x2: product and sum in fp32.  bf16: each product
// rounded to bf16, summed in fp32.
//
// Design.  row_walk.cuh's walk_kernel, as dgt_gather.cu launches it.  A
// chunk is sorted by column, so in slot order each slot is a row run of its
// own; the wrapper lists the live slots once per pattern in (row, slot)
// order (the format's row walk), and the kernel walks them once per panel
// of up to 512 columns: the trainable layer's K = 512 is one walk, where
// the shared row tile of gather_common.cuh took 16 (one per K-tile of 32),
// each with 32 shared CAS adds a slot.  With pack_span(keep_perm=True) the
// live slots are the pattern's, so a stored zero that training makes
// nonzero is summed; the value plane is its own pointer, so a caller's
// plane costs no copy.  The TPU's stream variant existed because X could
// not stay in VMEM: it walked chunks on the grid and fetched each chunk's
// planes and its [c0, c0+ct) window of X by DMA.  On the card a slot reads
// the row of X it needs where it needs it, so the stream wrapper launches
// the same walk (ct and kt change nothing): staging each chunk's window in
// shared memory would move up to ct x KT x 4 bytes of X a chunk however
// few slots read it, and its slots, in column order, would add product by
// product into a shared row tile (a CAS loop a column on this card).
//
// x of one column takes row_walk.cuh's walk1_kernel, as the dg and radix
// SpMVs do: a warp's 32 lanes on 32 neighbouring slots, row runs summed by
// a segmented warp scan, one scalar atomic a run; the TPU kernel took x
// widened to 8 columns (its 8-sublane minimum), which walk_kernel would
// read as a panel of 4.
//
// Bound.  Memory: the walk's 12 bytes a live slot (with a caller's plane
// the slot index and a gathered value), the X rows gathered and Y; 2 flops
// per slot and column.  See PERF.md for the times against the bound on the
// card.

#include "row_walk.cuh"

extern "C" {

// The row walk kernel over the S slots of a walk (row, col, slot int32
// [S]): values vals[slot[i]] from a value plane with gather, else the
// walk's own vals[i]; y [rows, ld] must be zeroed; x is [N, ld] fp32; the
// first kc columns in panels of pw, bs slots a block.  Returns the
// cudaError_t of the launch (0 on success).
int span_spmm_launch(const void* row, const void* col, const void* slot, const void* vals,
                     const void* x, void* y, int S, int ld, int kc, int pw, int bf16, int bs,
                     int gather, void* stream) {
  return runs::walk_launch(row, col, slot, vals, x, y, S, ld, kc, pw, bf16, bs, gather, stream);
}

// The row walk kernel of (pw, bf16) into out[0..3]: registers a thread,
// local (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int span_walk_info(int pw, int bf16, int* out) {
  return runs::kernel_info(runs::walk_kernel_of(pw, bf16), out);
}

// The one-column walk kernel over the S slots of a walk: as dg_spmv_launch
// (dg_gather.cu), bf16 rounding each product.  Returns the cudaError_t of
// the launch.
int span_walk1_launch(const void* row, const void* col, const void* slot, const void* vals,
                      const void* x, void* y, int S, int spw, int wpb, int steps, int gather,
                      int bf16, void* stream) {
  return runs::by_steps(steps, [&](auto u) {
    return runs::walk1_launch<decltype(u)::value>(row, col, slot, vals, x, y, S, spw, wpb,
                                                  gather, bf16, stream);
  });
}

// The one-column walk kernel of `steps` at wpb warps a block, products
// rounded to bf16 or not, into out[0..3] as span_walk_info.
int span_walk1_info(int steps, int wpb, int bf16, int* out) {
  if (wpb < 1 || wpb > runs::kThreads / 32) return static_cast<int>(cudaErrorInvalidValue);
  return runs::by_steps(steps, [&](auto u) {
    return runs::kernel_info(runs::walk1_kernel_of<decltype(u)::value>(bf16), out, 32 * wpb);
  });
}

}  // extern "C"
