// row_runs.cuh - the slot stream that tile_onehot.cu (kernels #5 and #6),
// stripe_gather.cu (the stripe kernel #10, the nested kernel #11) and,
// through row_walk.cuh's walk_kernel, dg_gather.cu (#1), dgt_gather.cu (#3,
// #4) and span_gather.cu (#7, #8) share: a run of slots walked once per
// panel of X's columns, each row run summed in registers and added into y
// once.
//
// A stream is LPS lanes of one warp (LPS = PW/4, at most 32; PW the panel
// width, 4..512 columns).  It takes a contiguous range of slots, in rounds:
// each lane decodes R slots of a round (the round's slot j is lane j % LPS's
// j / LPS-th), coalesced, and the stream then broadcasts slot after slot
// with __shfl_sync.  For each live slot the lanes read the slot's X row
// across the panel (NV float4 a lane, neighbouring lanes on neighbouring 16
// bytes), U rows in flight, and add v * X into NV float4 accumulators.  When
// the row changes the run is added into y once, by atomicAdd(float4*), which
// sm_90 compiles to one red.global.add.v4.f32 (REDG.E.ADD.F32x4), the lanes
// on distinct addresses: no shared memory and no shared atomics.  Another
// stream or block may hold part of the same row, so y must be zeroed first.
//
// A format supplies the decode: slot(i, v, col, row) for slot index i (each
// lane calls it with rising i), v = 0 for a slot to skip (padding, a column
// at or past N).  The runs are as long as the format keeps a row's slots
// together: pack_tile sorts a chunk by (row, column), the stripe formats
// keep COO order (the nested one within its sub-blocks).  The dg, dgt and
// span formats keep neither (a dg or span chunk is sorted by column: every
// slot its own run), so their kernel (row_walk.cuh) walks a row walk
// instead: the format's live slots listed once in (row, slot) order, built
// once per pattern.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace runs {
namespace {

constexpr int kThreads = 256;

// A stream's lanes, float4s a lane, X rows in flight and slots a lane
// decodes in a round, for a panel of PW columns.
template <int PW>
constexpr int kLanes = PW / 4 < 32 ? PW / 4 : 32;
template <int PW>
constexpr int kNv = PW / 4 / kLanes<PW>;
template <int PW>
constexpr int kInFlight = kNv<PW> >= 4 ? 2 : 4;
template <int PW>
constexpr int kPerLane = kInFlight<PW> > kLanes<PW> ? kInFlight<PW> / kLanes<PW> : 1;
// Blocks of kThreads an SM must hold: 4 (64 registers a thread) up to a
// 128-column panel, 3 (85) past it, where NV float4 accumulators and X rows
// in flight need them.  Chosen on the card, where the narrow panels ran
// faster so than at 3 blocks with 8 rows in flight (PERF.md).
template <int PW>
constexpr int kMinBlocks = PW <= 128 ? 4 : 3;

// The range [s0, s1) of [lo, hi) that this thread's stream takes: the
// block's streams split it evenly.
template <int PW>
__device__ __forceinline__ void stream_range(int lo, int hi, int& s0, int& s1) {
  constexpr int STREAMS = kThreads / kLanes<PW>;
  const int n = hi - lo;
  const int per = (n + STREAMS - 1) / STREAMS;
  s0 = lo + min(static_cast<int>(threadIdx.x / kLanes<PW>) * per, n);
  s1 = min(s0 + per, hi);
}

// Walks slots [s0, s1) for the panel of columns [col0, col0 + PW) of X
// [N, ld] and adds each row run into y [rows, ld]; only the first kc
// columns (kc <= ld, both multiples of 4) are read and written.
template <int PW, bool BF16, typename Slot>
__device__ __forceinline__ void walk(Slot& slot, int s0, int s1, const float* __restrict__ x,
                                     float* __restrict__ y, int ld, int kc, int col0) {
  constexpr int LPS = kLanes<PW>;
  constexpr int NV = kNv<PW>;
  constexpr int U = kInFlight<PW>;
  constexpr int R = kPerLane<PW>;
  constexpr int SPR = LPS * R;  // slots a round
  const int lane = threadIdx.x % LPS;
  const unsigned smask = LPS == 32 ? 0xffffffffu  // the stream's lanes in its warp
                                   : ((1u << (LPS % 32)) - 1u) << (threadIdx.x % 32 / LPS * LPS);

  float acc[NV][4] = {};
  int cur = -1;  // the row of the run in acc
  auto flush = [&]() {
    float* yr = y + static_cast<int64_t>(cur) * ld;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int c = col0 + (q * LPS + lane) * 4;
      if (c < kc) {
        atomicAdd(reinterpret_cast<float4*>(yr + c),
                  make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
    }
  };

  for (int base = s0; base < s1; base += SPR) {
    float v[R];
    int col[R], row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + r * LPS + lane;
      v[r] = 0.f;
      col[r] = row[r] = 0;
      if (i < s1) slot(i, v[r], col[r], row[r]);
    }
    const int cnt = min(SPR, s1 - base);
    for (int jb = 0; jb < cnt; jb += U) {
      float vj[U];
      int rj[U];
      float4 xv[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // R > 1 only when a round is U slots (one pass of this loop)
        const int r = R == 1 ? 0 : u / LPS;
        const int src = R == 1 ? min(jb + u, LPS - 1) : u % LPS;
        vj[u] = __shfl_sync(smask, v[r], src, LPS);
        rj[u] = __shfl_sync(smask, row[r], src, LPS);
        const int cj = __shfl_sync(smask, col[r], src, LPS);
        if (jb + u >= cnt) vj[u] = 0.f;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int c = col0 + (q * LPS + lane) * 4;
          xv[u][q] = vj[u] != 0.f && c < kc
                         ? *reinterpret_cast<const float4*>(x + static_cast<int64_t>(cj) * ld + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (vj[u] == 0.f) continue;  // uniform over the stream
        if (rj[u] != cur) {
          if (cur >= 0) flush();
          cur = rj[u];
        }
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const float xq[4] = {xv[u][q].x, xv[u][q].y, xv[u][q].z, xv[u][q].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float prod = vj[u] * xq[i];
            if constexpr (BF16) prod = __bfloat162float(__float2bfloat16_rn(prod));
            acc[q][i] += prod;
          }
        }
      }
    }
  }
  if (cur >= 0) flush();
}

// The kernel's registers a thread, local (spill) bytes a thread, static
// shared bytes and blocks of `threads` an SM holds, into out[0..3].
// Returns a cudaError_t.
int kernel_info(const void* kernel, int* out, int threads = kThreads) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace runs
