// row_walk.cuh - the row walk kernel that dg_gather.cu (#1, behind
// dg_walk_launch), dgt_gather.cu (#3 and #4, behind dgt_spmm_launch) and
// span_gather.cu (#7, behind span_spmm_launch) each instantiate: one walk
// over a format's live slots in y_rows-row order, each row run summed in
// registers (row_runs.cuh's walk) and added into the zeroed y_rows once by
// atomicAdd(float4*), which sm_90 compiles to REDG.E.ADD.F32x4.  No shared
// memory, no shared atomics.
//
// Why a walk.  The dg, dgt and span formats store slots in the TPU's order:
// a dg or span chunk is sorted by column, a dgt tile by (window, residue
// class), so in slot order almost every slot is a run of its own
// (1,677,723 runs for as many slots at the trainable layer's span format;
// 10,228,376 for 10,228,408 at the 262144^2 dgt8 format).  Summing runs in
// registers needs a row order, which none of them stores.  The wrapper derives it
// once per pattern (kernels/row_walk.py, kept on the format): for each live
// slot its y_rows row, its X column, its flat slot index and its value,
// sorted by (row, slot).  The row and column stream in order (8 bytes a
// slot).  So does the value where the caller multiplies by the format's own
// plane (12 bytes a slot, as the format's planes); a caller's plane (the
// trainable path's v * mask) is gathered through the slot index instead,
// so it needs no copy.  Gathering the value cost a third of the SpMV time
// on the card (PERF.md).  A value that reads 0 is skipped.
//
// Grid.  Flat over the walk's S slots, bs a block (the wrapper's choice by
// panel: 2048 up to 8 columns, 1024, 512 at 256 and 512 columns),
// times panels of up to 512 columns: neither the format's programs nor its
// K-tile shape it.  A row longer than a block's share is cut into a few
// runs, each added on its own, which is why y must be zeroed first.
//
// Bound.  Memory: 12 bytes a live slot of the walk (row, column, value;
// with a caller's plane the slot index and a gathered value, one 32-byte
// sector, in place of the value), X's rows gathered (one 32-byte sector a
// slot at K <= 8) and Y once; 2 flops per slot and column.

#pragma once

#include "row_runs.cuh"

namespace runs {
namespace {

// Block b takes slots [b*bs, b*bs + bs) of the walk, the panel of columns
// blockIdx.z * PW.  Slot i of the walk is y row wrow[i], X column wcol[i]
// and value vals[i] (the walk's own values) or, with wslot, vals[wslot[i]]
// (a value plane of the format's shape).
template <int PW, bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks<PW>)
walk_kernel(const int* __restrict__ wrow, const int* __restrict__ wcol,
            const int* __restrict__ wslot, const float* __restrict__ vals,
            const float* __restrict__ x, float* __restrict__ y, int S, int ld, int kc, int bs) {
  const int lo = static_cast<int>(blockIdx.x) * bs;  // walk_launch keeps S + bs < 2^31
  if (lo >= S) return;
  int s0, s1;
  stream_range<PW>(lo, min(lo + bs, S), s0, s1);
  auto slot = [&](int i, float& v, int& col, int& row) {
    row = wrow[i];
    col = wcol[i];
    v = wslot != nullptr ? vals[wslot[i]] : vals[i];  // uniform over the grid
  };
  walk<PW, BF16>(slot, s0, s1, x, y, ld, kc, static_cast<int>(blockIdx.z) * PW);
}

template <int PW>
const void* walk_kernel_pw(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(walk_kernel<PW, true>)
              : reinterpret_cast<const void*>(walk_kernel<PW, false>);
}

// The row walk kernel for a panel of pw columns (4, 8, ..., 512), or nullptr.
const void* walk_kernel_of(int pw, int bf16) {
  switch (pw) {
    case 4: return walk_kernel_pw<4>(bf16);
    case 8: return walk_kernel_pw<8>(bf16);
    case 16: return walk_kernel_pw<16>(bf16);
    case 32: return walk_kernel_pw<32>(bf16);
    case 64: return walk_kernel_pw<64>(bf16);
    case 128: return walk_kernel_pw<128>(bf16);
    case 256: return walk_kernel_pw<256>(bf16);
    case 512: return walk_kernel_pw<512>(bf16);
    default: return nullptr;
  }
}

// Launches the row walk kernel over the S slots of a walk (wrow, wcol,
// wslot int32 [S]) for y [rows, ld] (zeroed) and x [N, ld] fp32: the first
// kc columns, panels of pw, bs slots a block; the values vals[wslot[i]]
// with gather, else vals[i].  At least one block, so an empty walk is a
// launch too.  Returns a cudaError_t.
int walk_launch(const void* wrow, const void* wcol, const void* wslot, const void* vals,
                const void* x, void* y, int S, int ld, int kc, int pw, int bf16, int bs,
                int gather, void* stream) {
  const void* kernel = walk_kernel_of(pw, bf16);
  if (kernel == nullptr || S < 0 || ld % 4 || kc % 4 || kc < 4 || kc > ld || bs < 1 ||
      static_cast<int64_t>(S) + bs >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = S > 0 ? (S + bs - 1) / bs : 1;
  const dim3 grid(blocks, 1, (kc + pw - 1) / pw);
  const auto* r = static_cast<const int*>(wrow);
  const auto* c = static_cast<const int*>(wcol);
  const auto* sl = gather ? static_cast<const int*>(wslot) : nullptr;
  const auto* v = static_cast<const float*>(vals);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  void* args[] = {&r, &c, &sl, &v, &x_, &y_, &S, &ld, &kc, &bs};
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
}  // namespace runs
