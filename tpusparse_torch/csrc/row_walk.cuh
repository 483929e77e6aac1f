// row_walk.cuh - the two row walk kernels over a format's live slots in
// y_rows-row order, each row run summed in registers and added into the
// zeroed y_rows once; no shared memory, no shared atomics.
//
//   walk_kernel<PW, BF16>  X of 4 to 512 columns a panel: row_runs.cuh's
//       slot streams, each run added by atomicAdd(float4*), which sm_90
//       compiles to REDG.E.ADD.F32x4.  dg_gather.cu (#1, behind
//       dg_walk_launch), dgt_gather.cu (#3 and #4, behind dgt_spmm_launch),
//       span_gather.cu (#7 and #8, behind span_spmm_launch) and
//       radix_gather.cu (#9, behind radix_walk_launch) each instantiate it.
//   walk1_kernel<U, BF16>  x one column (SpMV): a warp's lanes on 32 slots a
//       step, each run summed by a warp-segmented scan and added by one
//       scalar atomicAdd (RED.E.ADD.F32).  dg_gather.cu (#2, behind
//       dg_spmv_launch) and radix_gather.cu (#9 at K = 1, behind
//       radix_spmv_launch) instantiate it.
//
// Why a walk.  The dg, dgt, span and radix formats store slots in the TPU's
// order: a dg, span or radix chunk is sorted by column (a brick-ELL chunk
// by stored order), a dgt tile by (window, residue class), so in slot order
// almost every slot is a run of its own
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
// Grid of walk_kernel.  Flat over the walk's S slots, bs a block (the
// wrapper's choice by panel: 2048 up to 8 columns, 1024, 512 at 256 and 512
// columns), times panels of up to 512 columns: neither the format's
// programs nor its K-tile shape it.  A row longer than a block's share is
// cut into a few runs, each added on its own, which is why y must be
// zeroed first.
//
// Grid of walk1_kernel.  Flat over the walk: warp w takes slots [w*spw,
// (w+1)*spw), wpb warps a block (the wrapper's choice, swept on the card).
// walk_kernel's narrowest stream (PW = 4, one lane a slot stream of 8
// slots and a float4 of X padded to 4 columns a slot) is what one column
// would cost there; here 32 lanes read 32 neighbouring slots.
//
// Bound.  Memory: 12 bytes a live slot of the walk (row, column, value;
// with a caller's plane the slot index and a gathered value, one 32-byte
// sector, in place of the value), X's rows gathered (one 32-byte sector a
// slot at K <= 8) and Y once; 2 flops per slot and column.

#pragma once

#include <type_traits>

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


// The one-column walk.  Warp w takes slots [w*spw, w*spw + spw) of the
// walk, U steps of 32 at a time: lane l reads slot base + 32u + l's row,
// column and value (coalesced 4-byte loads, or the value through wslot)
// and x[col] (4 bytes, from L2 where x fits it), all U steps' loads issued
// before the first product is summed.  A step is summed by row with an
// inclusive scan over the warp (__shfl_up_sync, 5 steps), in which a lane
// adds a neighbour's partial sum only when that neighbour lies in its own
// run: the walk's rows are sorted, so a run is the lanes from its head (the
// highest lane at or below this one whose row differs from its left
// neighbour's, from one ballot) on.  A run ends where the next lane opens
// one, and its last lane adds the run's sum into y once.  Lane 31's run
// may go on in the next step: its sum and row are carried in registers,
// and lane 0 of the next step either takes it into its own run or adds it.
// BF16 rounds each product to bf16 before it is summed (in fp32).
template <int U, bool BF16>
__global__ void __launch_bounds__(kThreads)
walk1_kernel(const int* __restrict__ wrow, const int* __restrict__ wcol,
             const int* __restrict__ wslot, const float* __restrict__ vals,
             const float* __restrict__ x, float* __restrict__ y, int S, int spw) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int64_t lo =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32) * spw;
  if (lo >= S) return;  // uniform over the warp
  const int s0 = static_cast<int>(lo);  // walk1_launch keeps S + spw * wpb + 32U < 2^31
  const int s1 = min(s0 + spw, S);
  const unsigned upto = lane == 31 ? kAll : (2u << lane) - 1u;  // lanes 0..lane
  float carry = 0.f;  // the sum of the run open at the last step's lane 31
  int carry_row = -1;
  for (int base = s0; base < s1; base += 32 * U) {
    int row[U], col[U];
    float v[U], p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 32 * u + lane;
      const bool in = i < s1;  // a lane past the range: row -1, value 0
      row[u] = in ? wrow[i] : -1;
      col[u] = in ? wcol[i] : 0;
      v[u] = in ? (wslot != nullptr ? vals[wslot[i]] : vals[i]) : 0.f;  // uniform branch
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = v[u] != 0.f ? v[u] * x[col[u]] : 0.f;
      if constexpr (BF16) p[u] = __bfloat162float(__float2bfloat16_rn(p[u]));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = row[u];
      float q = p[u];
      if (lane == 0) {
        if (r == carry_row) {
          q += carry;
        } else if (carry_row >= 0) {
          atomicAdd(y + carry_row, carry);
        }
      }
      const int left = __shfl_up_sync(kAll, r, 1);
      const unsigned heads = __ballot_sync(kAll, lane == 0 || r != left);
      const int head = 31 - __clz(heads & upto);
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float o = __shfl_up_sync(kAll, q, d);
        if (lane - d >= head) q += o;
      }
      if (lane < 31 && (heads >> (lane + 1) & 1u) && r >= 0) atomicAdd(y + r, q);
      carry = __shfl_sync(kAll, q, 31);
      carry_row = __shfl_sync(kAll, r, 31);
    }
  }
  if (lane == 0 && carry_row >= 0) atomicAdd(y + carry_row, carry);
}

// walk1_kernel takes 1, 2 or 4 steps of 32 slots a warp at once: fn called
// with the step count as a std::integral_constant.
template <typename Fn>
int by_steps(int steps, Fn fn) {
  switch (steps) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The one-column walk kernel of U steps, products rounded to bf16 or not.
template <int U>
const void* walk1_kernel_of(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(walk1_kernel<U, true>)
              : reinterpret_cast<const void*>(walk1_kernel<U, false>);
}

// Launches walk1_kernel<U> over the S slots of a walk (wrow, wcol, wslot
// int32 [S]) for y [rows] (zeroed) and x [N] fp32: spw slots a warp (a
// multiple of 32), wpb warps a block (1 to 8); the values vals[wslot[i]]
// with gather, else vals[i]; bf16 rounds each product.  At least one block,
// so an empty walk is a launch too.  Returns a cudaError_t.
template <int U>
int walk1_launch(const void* wrow, const void* wcol, const void* wslot, const void* vals,
                 const void* x, void* y, int S, int spw, int wpb, int gather, int bf16,
                 void* stream) {
  const int64_t per_block = static_cast<int64_t>(spw) * wpb;
  if (S < 0 || spw < 32 || spw % 32 || wpb < 1 || wpb > kThreads / 32 ||
      static_cast<int64_t>(S) + per_block + 32 * U >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = S > 0 ? static_cast<int>((S + per_block - 1) / per_block) : 1;
  const auto* r = static_cast<const int*>(wrow);
  const auto* c = static_cast<const int*>(wcol);
  const auto* sl = gather ? static_cast<const int*>(wslot) : nullptr;
  const auto* v = static_cast<const float*>(vals);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  void* args[] = {&r, &c, &sl, &v, &x_, &y_, &S, &spw};
  const cudaError_t err = cudaLaunchKernel(walk1_kernel_of<U>(bf16), dim3(blocks),
                                           dim3(32 * wpb), args, 0,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
}  // namespace runs
