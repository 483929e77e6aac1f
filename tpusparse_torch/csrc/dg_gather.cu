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
// the DgSlots decode below.  The [rb, KT] row tile lives in shared memory
// where it fits the opt-in limit; rb = 2048 at KT = 32 (256 KB) takes the
// global-atomic branch.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrow, vals) plus
// the X rows gathered and Y; the arithmetic is 2 flops per slot and column.
// See PERF.md for its time against the bound on the card.

#include "gather_common.cuh"

namespace {

using gather::OptIn;

// A dg slot: column c0[chunk] + cols, row lrow.
struct DgSlots {
  const int* c0;
  const int* cols;
  const int* lrow;

  struct Chunk {
    int64_t cstart;
    const int* cols;
    const int* lrow;
    __device__ __forceinline__ bool operator()(int64_t i, int, int64_t& col, int& row) const {
      col = cstart + cols[i];
      row = lrow[i];
      return true;
    }
  };
  __device__ __forceinline__ Chunk chunk(int64_t c) const { return {c0[c], cols, lrow}; }
};

template <int KT, bool BF16>
int launch(const void* c0, const void* cols, const void* lrow, const void* vals,
           const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
           int Kp, int splits, cudaStream_t stream) {
  static OptIn optin;  // of this instantiation's shared-tile kernel
  const DgSlots slots{static_cast<const int*>(c0), static_cast<const int*>(cols),
                      static_cast<const int*>(lrow)};
  return gather::launch_tiled(
      gather::gather_kernel<DgSlots, KT, BF16, true>,
      gather::gather_kernel<DgSlots, KT, BF16, false>, optin, dim3(splits, P, Kp / KT),
      gather::tile_bytes(rb, KT), 0, stream, slots, static_cast<const float*>(vals),
      static_cast<const int*>(nc_p), static_cast<const float*>(x), static_cast<float*>(y), NC,
      G, rb, Kp, splits);
}

}  // namespace

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] tile in shared memory,
// 0 when it takes the global-atomic branch.
int dg_uses_shared_tile(int rb, int kt) {
  return gather::tile_bytes(rb, kt) <= static_cast<size_t>(gather::optin_shared_bytes());
}

// y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a multiple of kt.
// Returns the cudaError_t of the launch (0 on success).
int dg_spmm_launch(const void* c0, const void* cols, const void* lrow,
                   const void* vals, const void* nc_p, const void* x, void* y,
                   int P, int NC, int G, int rb, int Kp, int kt, int bf16,
                   int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define DG_CASE(KT)                                                              \
  if (kt == KT) {                                                                \
    return bf16 ? launch<KT, true>(c0, cols, lrow, vals, nc_p, x, y, P, NC, G, rb, \
                                   Kp, splits, s)                                \
                : launch<KT, false>(c0, cols, lrow, vals, nc_p, x, y, P, NC, G,  \
                                    rb, Kp, splits, s);                          \
  }
  DG_CASE(8)
  DG_CASE(16)
  DG_CASE(32)
#undef DG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// y [P*rb] must be zeroed; x is [N] fp32.
int dg_spmv_launch(const void* c0, const void* cols, const void* lrow,
                   const void* vals, const void* nc_p, const void* x, void* y,
                   int P, int NC, int G, int rb, int splits, void* stream) {
  return launch<1, false>(c0, cols, lrow, vals, nc_p, x, y, P, NC, G, rb, 1, splits,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
