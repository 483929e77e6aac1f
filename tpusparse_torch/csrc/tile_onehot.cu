// tile_onehot.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/tile_onehot.py:
//   tile_spmm_launch    replaces _tile_kernel        (tile_onehot.py:44), X
//                       read where it lies;
//   tile_stream_launch  replaces _tile_kernel_stream (tile_onehot.py:119),
//                       the same Y with X staged through shared memory.
//
// Function.  The format is the JAX package's TileFormat: P programs of NC
// chunks of G slots; chunk_tile [P,1,NC] holds each chunk's column tile,
// cols [P,NC,G] a slot's column within the tile (< ct), lrow [P,NC,G] its
// program-local row, vals [P,NC,G] its value (0 in padding); nc_p [P] the
// real chunk count of each program (the packer's chunks_per_p).  For each
// program p, chunk j < nc_p[p] and slot s whose value v is not zero:
//     y_rows[p*rb + lrow, t*KT + k] += v * X[chunk_tile[p,j]*ct + cols, t*KT + k]
// for every K-tile t and k < KT.  That is what the TPU kernel's two one-hot
// MXU contractions per chunk (gather X rows through a [G, CT] column
// one-hot, scatter to rows through an [RB, G] row one-hot) compute; the
// card has a hardware gather, so a thread loads the row of X it needs and
// adds its products by atomics.  Padding slots and padding chunks (tile 0,
// value 0) add nothing and are skipped.
//
// Precision.  fp32 and fp32x2: product and sum in fp32 (fp32x2 was the
// TPU's hi/lo bf16 split of X, at least matched here).  bf16: each product
// rounded to bf16, summed in fp32, as in gather_common.cuh.
//
// Design (simple and right first).
//   tile_spmm_launch: gather_common.cuh's gather_kernel with the
//   WindowSlots decode at scale ct (column chunk_tile * ct + cols).  The
//   TPU took ktile = K up to 128; here KT is 8, 16 or 32 and the wrapper
//   pads X's columns to a multiple of it (KT = 128 would need a 512 KB row
//   tile at rb = 1024).  The headline's P = 32 programs are split over
//   blocks to fill the 132 SMs.
//   tile_stream_kernel: the TPU variant fetched each chunk's (CT, ktile)
//   X window by DMA because X could not stay in VMEM.  A full window does
//   not fit beside the row tile here (CT = 1024 x KT = 32 x 4 B = 128 KB,
//   plus 128 KB of row tile at rb = 1024), so the block stages only the X
//   rows its slots name: each thread issues a 16-byte cp.async of its
//   slot's X row slice into shared memory STAGES iterations ahead of the
//   one it accumulates, a ring of 4 stages of 4 KB (24 KB with each slot's
//   value and row).  A thread reads back only what it staged itself, so
//   the ring needs no block barrier.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrow, vals), 4 per
// chunk (chunk_tile), plus the X rows gathered and Y; 2 flops per slot and
// column.  See PERF.md for the times against the bound on the card.

#include "gather_common.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

constexpr int STAGES = 4;

// Per thread and stage: a float4 of X (16 B), the slot's value and row.
size_t ring_bytes() { return static_cast<size_t>(STAGES) * kThreads * (16 + 4 + 4); }

template <int KT, bool BF16, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
tile_stream_kernel(const int* __restrict__ chunk_tile, const int* __restrict__ cols,
                   const int* __restrict__ lrow, const float* __restrict__ vals,
                   const int* __restrict__ nc_p, const float* __restrict__ x,
                   float* __restrict__ y, int NC, int G, int rb, int ct, int N, int Kp,
                   int splits) {
  constexpr int VEC = 4;
  constexpr int TPS = KT / VEC;        // threads per slot
  constexpr int SPI = kThreads / TPS;  // slots per iteration
  float* tile = reinterpret_cast<float*>(gather::gather_smem);  // [rb, KT]
  float4* xs = gather::gather_smem + (SHARED_TILE ? rb * KT / VEC : 0);  // [STAGES][kThreads]
  float* vs = reinterpret_cast<float*>(xs + STAGES * kThreads);          // [STAGES][kThreads]
  int* rs = reinterpret_cast<int*>(vs + STAGES * kThreads);              // [STAGES][kThreads]

  const int p = blockIdx.y;
  const int t = blockIdx.z;
  int j0, j1;
  if (!gather::chunk_range(nc_p, p, splits, j0, j1)) return;
  if constexpr (SHARED_TILE) gather::zero_tile<KT>(tile, rb);

  const int tcol = (threadIdx.x % TPS) * VEC;
  const int kcol = t * KT + tcol;
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  const int64_t first = (static_cast<int64_t>(p) * NC + j0) * G;  // flat index of the range
  const int64_t n_slots = static_cast<int64_t>(j1 - j0) * G;
  const int64_t n_iter = (n_slots + SPI - 1) / SPI;

  // Stage iteration `it` into ring entry `buf`: this thread's slot's value,
  // row and X row slice (zeroed, and nothing read, for a skipped slot).
  auto issue = [&](int64_t it, int buf) {
    const int64_t idx = it * SPI + threadIdx.x / TPS;
    float v = 0.f;
    int row = 0;
    int64_t col = 0;
    if (idx < n_slots) {
      const int64_t i = first + idx;
      v = vals[i];
      if (v != 0.f) {
        col = static_cast<int64_t>(chunk_tile[i / G]) * ct + cols[i];
        row = lrow[i];
        if (col >= N) v = 0.f;
      }
    }
    const int e = buf * kThreads + threadIdx.x;
    vs[e] = v;
    rs[e] = row;
    gather::cp_async<16>(&xs[e], v != 0.f ? x + col * Kp + kcol : x, v != 0.f);
  };

  for (int64_t it = 0; it < n_iter + STAGES - 1; ++it) {
    if (it < n_iter) issue(it, static_cast<int>(it % STAGES));
    gather::cp_async_commit();  // one group per iteration, empty past the end
    const int64_t use = it - (STAGES - 1);
    if (use < 0) continue;
    gather::cp_async_wait<STAGES - 1>();  // the group of iteration `use` has landed
    const int e = static_cast<int>(use % STAGES) * kThreads + threadIdx.x;
    const float v = vs[e];
    if (v == 0.f) continue;
    const float4 q = xs[e];
    const float xv[VEC] = {q.x, q.y, q.z, q.w};
    gather::scatter<KT, VEC, BF16, SHARED_TILE>(tile, yprog, rs[e], tcol, kcol, Kp, v, xv);
  }
  if constexpr (SHARED_TILE) gather::flush_tile<KT>(tile, yprog, rb, Kp, t);
}

template <int KT, bool BF16>
int launch_stream(const int* chunk_tile, const int* cols, const int* lrow, const float* vals,
                  const int* nc_p, const float* x, float* y, int P, int NC, int G, int rb,
                  int ct, int N, int Kp, int splits, cudaStream_t stream) {
  static OptIn optin;  // of this instantiation's shared-tile kernel
  return gather::launch_tiled(tile_stream_kernel<KT, BF16, true>,
                              tile_stream_kernel<KT, BF16, false>, optin,
                              dim3(splits, P, Kp / KT), gather::tile_bytes(rb, KT), ring_bytes(),
                              stream, chunk_tile, cols, lrow, vals, nc_p, x, y, NC, G, rb, ct, N,
                              Kp, splits);
}

}  // namespace

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] row tile in shared memory
// (with the stream kernel's ring beside it when stream), 0 when it takes
// the global-atomic branch.
int tile_uses_shared_tile(int rb, int kt, int stream) {
  return gather::tile_bytes(rb, kt) + (stream ? ring_bytes() : 0) <=
         static_cast<size_t>(gather::optin_shared_bytes());
}

// y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a multiple of kt in
// {8, 16, 32}.  Returns the cudaError_t of the launch (0 on success).
int tile_spmm_launch(const void* chunk_tile, const void* cols, const void* lrow,
                     const void* vals, const void* nc_p, const void* x, void* y, int P, int NC,
                     int G, int rb, int ct, int N, int Kp, int kt, int bf16, int splits,
                     void* stream) {
  if (kt == 1) return static_cast<int>(cudaErrorInvalidValue);
  const gather::WindowSlots slots{static_cast<const int*>(chunk_tile),
                                  static_cast<const int*>(cols), static_cast<const int*>(lrow),
                                  ct, N};
  return gather::launch_window(slots, vals, nc_p, x, y, P, NC, G, rb, Kp, kt, bf16, splits,
                               stream);
}

// The same function, X staged through shared memory by cp.async.
int tile_stream_launch(const void* chunk_tile, const void* cols, const void* lrow,
                       const void* vals, const void* nc_p, const void* x, void* y, int P,
                       int NC, int G, int rb, int ct, int N, int Kp, int kt, int bf16,
                       int splits, void* stream) {
  const auto* ct_ = static_cast<const int*>(chunk_tile);
  const auto* cols_ = static_cast<const int*>(cols);
  const auto* lrow_ = static_cast<const int*>(lrow);
  const auto* vals_ = static_cast<const float*>(vals);
  const auto* ncp_ = static_cast<const int*>(nc_p);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
#define TILE_CASE(KT)                                                                       \
  if (kt == KT) {                                                                           \
    return bf16 ? launch_stream<KT, true>(ct_, cols_, lrow_, vals_, ncp_, x_, y_, P, NC, G,  \
                                          rb, ct, N, Kp, splits, s)                         \
                : launch_stream<KT, false>(ct_, cols_, lrow_, vals_, ncp_, x_, y_, P, NC, G, \
                                           rb, ct, N, Kp, splits, s);                       \
  }
  TILE_CASE(8)
  TILE_CASE(16)
  TILE_CASE(32)
#undef TILE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
