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
//     y_rows[p*rb + row, t*KT + k] += v * X[col, t*KT + k]
// for every K-tile t and k < KT.  That is what the TPU kernel's window
// slices, lane gathers, select tree, static residue masks and one-hot MXU
// scatter reconstruct; none of that mechanism is needed on the card, where
// a thread loads the row of X it needs.  Chunks at or past nc_p[p] hold
// only zeros and are skipped; so are zero-valued slots.
//
// Precision.  fp32x2: product and sum in fp32 (the TPU's hi/lo bf16 split
// kept about 16 bits of each product).  bf16: each product rounded to bf16,
// summed in fp32.
//
// Design (simple and right first).
//   dgt_spmm_launch: gather_common.cuh's gather_kernel with the DgtSlots
//   decode below.  At the 32768-row headline pack_dgt(rb=512) gives P = 69
//   programs; the SpMV workload's rb = 2560 row tile is 80 KB at KT = 8 and
//   opts in; rb = 8192 at KT = 32 (1 MB) takes the global-atomic branch.
//   dgt_stream_kernel: the TPU variant fetched each tile's nw windows as
//   their own X blocks because X could not stay in VMEM.  Here the block
//   walks a chunk tile by tile; each thread keeps its slots of the tile in
//   registers, and for each window w < nw that some slot selects, the block
//   copies X rows [(base+w)*128, +128) x its K-tile (4 KB at KT = 8, 16 KB
//   at KT = 32; zero past N) into shared memory, then the slots with
//   sel == w gather from there.  Its accumulation and launch are
//   gather_common.cuh's.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrw, vals), 4 per
// tile (wins), plus the X rows gathered and Y; 2 flops per slot and
// column.  The stream kernel moves nw*128*KT*4 bytes of X per tile at most.
// See PERF.md for the times against the bound on the card.

#include "gather_common.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

// A dgt slot: column (wins[tile] + sel) * 128 + lane, row lrw * ngrp +
// s % ngrp (resid) or lrw.  A column at or past N is skipped; a checked
// format has none, so X is never read past N.
struct DgtSlots {
  const int* wins;
  const int* cols;
  const int* lrw;
  int T, N, ngrp, resid;

  struct Chunk {
    const int* win;  // the chunk's T window bases
    const int* cols;
    const int* lrw;
    int N, ngrp, resid;
    __device__ __forceinline__ bool operator()(int64_t i, int s, int64_t& col, int& row) const {
      const int c = cols[i];
      col = static_cast<int64_t>(win[s >> 7] + (c >> 7)) * 128 + (c & 127);
      const int r = lrw[i];
      row = resid ? r * ngrp + s % ngrp : r;
      return col < N;
    }
  };
  __device__ __forceinline__ Chunk chunk(int64_t c) const {
    return {wins + c * T, cols, lrw, N, ngrp, resid};
  }
};

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
int launch(bool stream_x, const int* wins, const int* cols, const int* lrw,
           const float* vals, const int* nc_p, const float* x, float* y, int P, int NC,
           int G, int rb, int N, int Kp, int ngrp, int flag, int splits,
           cudaStream_t stream) {
  const dim3 grid(splits, P, Kp / KT);
  const size_t tile = gather::tile_bytes(rb, KT);
  if (stream_x) {
    static OptIn optin;  // of this instantiation's shared-tile stream kernel
    return gather::launch_tiled(dgt_stream_kernel<KT, BF16, true>,
                                dgt_stream_kernel<KT, BF16, false>, optin, grid, tile,
                                window_bytes(KT), stream, wins, cols, lrw, vals, nc_p, x, y,
                                NC, G, rb, N, Kp, ngrp, flag, splits);
  }
  static OptIn optin;  // of this instantiation's shared-tile gather kernel
  const DgtSlots slots{wins, cols, lrw, G / 128, N, ngrp, flag};
  return gather::launch_tiled(gather::gather_kernel<DgtSlots, KT, BF16, true>,
                              gather::gather_kernel<DgtSlots, KT, BF16, false>, optin, grid,
                              tile, 0, stream, slots, vals, nc_p, x, y, NC, G, rb, Kp, splits);
}

int dispatch(bool stream_x, const void* wins, const void* cols, const void* lrw,
             const void* vals, const void* nc_p, const void* x, void* y, int P, int NC, int G,
             int rb, int N, int Kp, int kt, int bf16, int ngrp, int flag, int splits,
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
    return bf16 ? launch<KT, true>(stream_x, wins_, cols_, lrw_, vals_, ncp_, x_, y_, P,   \
                                   NC, G, rb, N, Kp, ngrp, flag, splits, s)                \
                : launch<KT, false>(stream_x, wins_, cols_, lrw_, vals_, ncp_, x_, y_, P,  \
                                    NC, G, rb, N, Kp, ngrp, flag, splits, s);              \
  }
  DGT_CASE(8)
  DGT_CASE(16)
  DGT_CASE(32)
#undef DGT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// 1 when a block of (rb, kt) keeps its [rb, kt] row tile in shared memory
// (with the stream kernel's [128, kt] window beside it when stream_x), 0
// when it takes the global-atomic branch.
int dgt_uses_shared_tile(int rb, int kt, int stream_x) {
  return gather::tile_bytes(rb, kt) + (stream_x ? window_bytes(kt) : 0) <=
         static_cast<size_t>(gather::optin_shared_bytes());
}

// y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a multiple of kt.
// Returns the cudaError_t of the launch (0 on success).
int dgt_spmm_launch(const void* wins, const void* cols, const void* lrw, const void* vals,
                    const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                    int N, int Kp, int kt, int bf16, int ngrp, int resid, int splits,
                    void* stream) {
  return dispatch(false, wins, cols, lrw, vals, nc_p, x, y, P, NC, G, rb, N, Kp, kt, bf16,
                  ngrp, resid, splits, stream);
}

// The same for a resid format, nw windows per tile staged in shared memory.
int dgt_stream_launch(const void* wins, const void* cols, const void* lrw, const void* vals,
                      const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                      int N, int Kp, int kt, int bf16, int ngrp, int nw, int splits,
                      void* stream) {
  return dispatch(true, wins, cols, lrw, vals, nc_p, x, y, P, NC, G, rb, N, Kp, kt, bf16,
                  ngrp, nw, splits, stream);
}

}  // extern "C"
