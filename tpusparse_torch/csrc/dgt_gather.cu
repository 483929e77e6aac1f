// dgt_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/dgt_gather.py:
//   dgt_spmm_launch    replaces _dgt_kernel        (dgt_gather.py:667), kt
//                      8/16/32, modes fp32x2 and bf16, resid on or off;
//   dgt_stream_launch  replaces _dgt_kernel_stream (dgt_gather.py:882), the
//                      same Y for resid formats with X windows staged.
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
// for every column k.  That is what the TPU kernel's window slices, lane
// gathers, select tree, static residue masks and one-hot MXU scatter
// reconstruct; none of that mechanism is needed on the card, where a lane
// loads the row of X it needs.
//
// Precision.  fp32x2: product and sum in fp32 (the TPU's hi/lo bf16 split
// kept about 16 bits of each product).  bf16: each product rounded to bf16,
// summed in fp32.
//
// Design.
//   dgt_spmm_launch: row_walk.cuh's row walk kernel.  The wrapper decodes
//   (col, row) above once per pattern into the format's row walk (the live
//   slots in (row, slot) order); the kernel walks it once per panel of up
//   to 512 columns, sums each row run in registers and adds it into y_rows
//   by float4 atomics.  The split-row pieces are rows of y_rows like any
//   other, so the pyramid unpack is unchanged.  At K = 1 (SpMV) the wrapper
//   asks for 4 columns of the kt-padded X: one float4 a slot.
//   dgt_stream_kernel: the TPU variant fetched each tile's nw windows as
//   their own X blocks because X could not stay in VMEM.  Here the block
//   walks a chunk tile by tile; each thread keeps its slots of the tile in
//   registers, and for each window w < nw that some slot selects, the block
//   copies X rows [(base+w)*128, +128) x its K-tile (4 KB at KT = 8, 16 KB
//   at KT = 32; zero past N) into shared memory, then the slots with
//   sel == w gather from there.  Its accumulation and launch are
//   gather_common.cuh's (a shared row tile with per-slot shared atomics).
//
// Bound.  Memory: the walk's 12 bytes a live slot and the value plane
// (dgt_spmm_launch) or 12 bytes per slot of the format and 4 per tile
// (stream), plus the X rows gathered and Y; 2 flops per slot and column.
// The stream kernel moves nw*128*KT*4 bytes of X per tile at most.  See
// PERF.md for the times against the bound on the card.

#include "gather_common.cuh"
#include "row_walk.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

template <int KT, bool BF16, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
dgt_stream_kernel(const int* __restrict__ wins, const int* __restrict__ cols,
                  const int* __restrict__ lrw, const float* __restrict__ vals,
                  const int* __restrict__ nc_p, const float* __restrict__ x,
                  float* __restrict__ y, int NC, int G, int rb, int N, int Kp, int ngrp,
                  int nw, int splits) {
  constexpr int VEC = 4;
  constexpr int TPS = KT / VEC;
  constexpr int SPI = kThreads / TPS;
  constexpr int SPT = 128 / SPI;       // slots of a tile per thread: 1, 2 or 4
  constexpr int V4_PER_ROW = KT / VEC;  // float4s per window row of the K-tile
  float* tile = reinterpret_cast<float*>(gather::gather_smem);             // [rb, KT]
  float4* xs = gather::gather_smem + (SHARED_TILE ? rb * KT / VEC : 0);    // [128, KT]

  const int p = blockIdx.y;
  const int t = blockIdx.z;
  int j0, j1;
  if (!gather::chunk_range(nc_p, p, splits, j0, j1)) return;
  if constexpr (SHARED_TILE) gather::zero_tile<KT>(tile, rb);

  const int sub = threadIdx.x % TPS;
  const int kcol = t * KT + sub * VEC;
  const int T = G / 128;
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  for (int j = j0; j < j1; ++j) {
    const int64_t chunk = static_cast<int64_t>(p) * NC + j;
    for (int tt = 0; tt < T; ++tt) {
      const int64_t tbase = chunk * G + tt * 128;
      const int64_t wbase = wins[chunk * T + tt];
      float v[SPT];
      int lane[SPT], sel[SPT], row[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int s = threadIdx.x / TPS + i * SPI;  // slot within the tile
        v[i] = vals[tbase + s];
        const int c = cols[tbase + s];
        lane[i] = c & 127;
        sel[i] = v[i] != 0.f ? (c >> 7) : -1;      // padding selects no window
        row[i] = lrw[tbase + s] * ngrp + s % ngrp;  // 128 % ngrp == 0: s % ngrp is the class
      }
      for (int w = 0; w < nw; ++w) {
        bool need = false;
#pragma unroll
        for (int i = 0; i < SPT; ++i) need |= sel[i] == w;
        // also the barrier after the previous window's readers of xs
        if (!__syncthreads_or(need)) continue;
        const int64_t row0 = (wbase + w) * 128;
        for (int e = threadIdx.x; e < 128 * V4_PER_ROW; e += kThreads) {
          const int64_t xr = row0 + e / V4_PER_ROW;
          xs[e] = xr < N ? *reinterpret_cast<const float4*>(
                               x + xr * Kp + t * KT + (e % V4_PER_ROW) * VEC)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          if (sel[i] != w) continue;
          const float4 q = xs[lane[i] * V4_PER_ROW + sub];
          const float xv[VEC] = {q.x, q.y, q.z, q.w};
          gather::scatter<KT, VEC, BF16, SHARED_TILE>(tile, yprog, row[i], sub * VEC, kcol,
                                                      Kp, v[i], xv);
        }
      }
    }
  }
  if constexpr (SHARED_TILE) gather::flush_tile<KT>(tile, yprog, rb, Kp, t);
}

size_t window_bytes(int kt) { return static_cast<size_t>(128) * kt * sizeof(float); }

template <int KT, bool BF16>
int launch_stream(const int* wins, const int* cols, const int* lrw, const float* vals,
                  const int* nc_p, const float* x, float* y, int P, int NC, int G, int rb,
                  int N, int Kp, int ngrp, int nw, int splits, cudaStream_t stream) {
  static OptIn optin;  // of this instantiation's shared-tile stream kernel
  return gather::launch_tiled(dgt_stream_kernel<KT, BF16, true>,
                              dgt_stream_kernel<KT, BF16, false>, optin,
                              dim3(splits, P, Kp / KT), gather::tile_bytes(rb, KT),
                              window_bytes(KT), stream, wins, cols, lrw, vals, nc_p, x, y, NC,
                              G, rb, N, Kp, ngrp, nw, splits);
}

}  // namespace

extern "C" {

// 1 when a block of the stream kernel at (rb, kt) keeps its [rb, kt] row
// tile in shared memory beside its [128, kt] window, 0 when it takes the
// global-atomic branch.
int dgt_uses_shared_tile(int rb, int kt) {
  return gather::tile_bytes(rb, kt) + window_bytes(kt) <=
         static_cast<size_t>(gather::optin_shared_bytes());
}

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

// The stream kernel for a resid format, nw windows per tile staged in
// shared memory: y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a
// multiple of kt.  Returns the cudaError_t of the launch (0 on success).
int dgt_stream_launch(const void* wins, const void* cols, const void* lrw, const void* vals,
                      const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                      int N, int Kp, int kt, int bf16, int ngrp, int nw, int splits,
                      void* stream) {
  if (G % 128 || ngrp <= 0 || 128 % ngrp) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wins_ = static_cast<const int*>(wins);
  const auto* cols_ = static_cast<const int*>(cols);
  const auto* lrw_ = static_cast<const int*>(lrw);
  const auto* vals_ = static_cast<const float*>(vals);
  const auto* ncp_ = static_cast<const int*>(nc_p);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
#define DGT_CASE(KT)                                                                       \
  if (kt == KT) {                                                                          \
    return bf16 ? launch_stream<KT, true>(wins_, cols_, lrw_, vals_, ncp_, x_, y_, P, NC,  \
                                          G, rb, N, Kp, ngrp, nw, splits, s)              \
                : launch_stream<KT, false>(wins_, cols_, lrw_, vals_, ncp_, x_, y_, P, NC, \
                                           G, rb, N, Kp, ngrp, nw, splits, s);            \
  }
  DGT_CASE(8)
  DGT_CASE(16)
  DGT_CASE(32)
#undef DGT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
