// tile_onehot.cu - the Hopper counterpart of the two TPU kernels in
// tpusparse/kernels/tile_onehot.py, one kernel for both:
//   tile_stream_launch  replaces _tile_kernel        (tile_onehot.py:44) and
//                       _tile_kernel_stream (tile_onehot.py:119).
// The TPU's two kernels compute the same function on the same TileFormat and
// differed only in how X reached VMEM (resident, or a DMA'd window a chunk);
// here X is read from device memory through L2 in both, so the wrappers
// tile_rows_cuda (#5) and tile_stream_rows_cuda (#6) launch this one kernel.
//
// Function.  The format is the JAX package's TileFormat: P programs of NC
// chunks of G slots; chunk_tile [P,1,NC] holds each chunk's column tile,
// cols [P,NC,G] a slot's column within the tile (< ct), lrow [P,NC,G] its
// program-local row, vals [P,NC,G] its value (0 in padding); nc_p [P] the
// real chunk count of each program (the packer's chunks_per_p).  For each
// program p, chunk j < nc_p[p] and slot s whose value v is not zero:
//     y_rows[p*rb + lrow, k] += v * X[chunk_tile[p,j]*ct + cols, k]
// for every column k < Kp.  That is what the TPU kernels' two one-hot MXU
// contractions per chunk (gather X rows through a [G, CT] column one-hot,
// scatter to rows through an [RB, G] row one-hot) compute; the card has a
// hardware gather, so a stream of lanes loads the row of X it needs.
// Padding slots and padding chunks (tile 0, value 0) add nothing and are
// skipped.
//
// Precision.  fp32 and fp32x2: product and sum in fp32 (fp32x2 was the
// TPU's hi/lo bf16 split of X, at least matched here).  bf16: each product
// rounded to bf16, summed in fp32, as in gather_common.cuh.
//
// Design.  The TPU ran its grid in order over one resident row block, so it
// needed no atomics.  Blocks run at once here.  A shared [rb, KT] row tile
// per block would take per-slot shared atomics, which compile to CAS loops
// on this card (ATOMS.CAST.SPIN) that serialise when a warp's lanes hit one
// row's addresses, and a tile small enough for shared memory (KT <= 32 at
// rb = 1024) walks the format once per K-tile: 8 times at K = 256.  This
// kernel walks the format once per panel of up to 512 columns and adds
// once per row run (row_runs.cuh):
//   - a stream of LPS lanes (LPS = PW/4, at most 32; PW the panel width,
//     the narrowest of 8..512 that holds Kp, several panels past 512) takes
//     a contiguous run of a block's slots, decodes them coalesced, every
//     load of a slot issued at once, and broadcasts each with __shfl_sync;
//   - the stream reads each live slot's X row across its lanes, several
//     rows in flight, and sums the run of one row in registers (pack_tile
//     sorts a chunk by (row, column)); a run is added into y_rows once by
//     float4 atomicAdd (red.global.add.v4.f32), lanes on distinct addresses.
//     At config #1 the 1.0M slots make 0.20M runs (PERF.md).  No shared
//     memory: 3 blocks of 8 warps fit an SM;
//   - a block takes `cpb` chunks of one program (about 1024 slots, the
//     wrapper's choice), so the uneven programs of an unsorted power law
//     are cut into many small blocks.
//   The rb of the format does not enter: y_rows is written in device memory
//   (L2) whatever its size.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrow, vals), 4 per
// chunk (chunk_tile), plus X and Y once; 2 flops per slot and column.  The
// kernel reads each live slot's X row from L2 (1 KB a slot at K = 256):
// about 1 GB a call at config #1.  See PERF.md for the times.

#include "row_runs.cuh"

namespace {

using runs::kThreads;

// Program p = blockIdx.y, chunks [j0, j1) = the block's `cpb` chunks of it,
// the panel of columns blockIdx.z * PW.
template <int PW, bool BF16>
__global__ void __launch_bounds__(kThreads, runs::kMinBlocks<PW>)
tile_stream_kernel(const int* __restrict__ chunk_tile, const int* __restrict__ cols,
                   const int* __restrict__ lrow, const float* __restrict__ vals,
                   const int* __restrict__ nc_p, const float* __restrict__ x,
                   float* __restrict__ y, int NC, int G, int rb, int ct, int N, int Kp, int cpb) {
  const int p = blockIdx.y;
  const int ncp = nc_p[p];
  const int j0 = static_cast<int>(blockIdx.x) * cpb;
  if (j0 >= ncp) return;
  const int j1 = min(j0 + cpb, ncp);
  int s0, s1;  // this stream's slots, flat from chunk j0 of program p
  runs::stream_range<PW>(0, (j1 - j0) * G, s0, s1);
  const int64_t first = (static_cast<int64_t>(p) * NC + j0) * G;
  const int* tiles = chunk_tile + static_cast<int64_t>(p) * NC + j0;
  // every load of a slot is issued at once (none waits on its value)
  auto slot = [&](int i, float& v, int& col, int& row) {
    const int64_t fi = first + i;
    v = vals[fi];
    const int64_t c = static_cast<int64_t>(tiles[i / G]) * ct + cols[fi];
    row = lrow[fi];
    col = static_cast<int>(c);
    if (c >= N) v = 0.f;
  };
  runs::walk<PW, BF16>(slot, s0, s1, x, y + static_cast<int64_t>(p) * rb * Kp, Kp,
                       Kp, static_cast<int>(blockIdx.z) * PW);
}

template <int PW>
const void* kernel_of(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(tile_stream_kernel<PW, true>)
              : reinterpret_cast<const void*>(tile_stream_kernel<PW, false>);
}

// The kernel for a panel of pw columns, or nullptr.
const void* stream_kernel(int pw, int bf16) {
  switch (pw) {
    case 8: return kernel_of<8>(bf16);
    case 16: return kernel_of<16>(bf16);
    case 32: return kernel_of<32>(bf16);
    case 64: return kernel_of<64>(bf16);
    case 128: return kernel_of<128>(bf16);
    case 256: return kernel_of<256>(bf16);
    case 512: return kernel_of<512>(bf16);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// y_rows for the format, walked once per panel of pw columns (8, 16, ...,
// 512; Kp a multiple of 4), `cpb` chunks of a program a block.  y [P*rb, Kp]
// must be zeroed.  Returns the cudaError_t of the launch (0 on success).
int tile_stream_launch(const void* chunk_tile, const void* cols, const void* lrow,
                       const void* vals, const void* nc_p, const void* x, void* y, int P,
                       int NC, int G, int rb, int ct, int N, int Kp, int pw, int bf16, int cpb,
                       void* stream) {
  const void* kernel = stream_kernel(pw, bf16);
  if (kernel == nullptr || Kp % 4 || cpb < 1 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((NC + cpb - 1) / cpb, P, (Kp + pw - 1) / pw);
  const auto* ct_ = static_cast<const int*>(chunk_tile);
  const auto* cols_ = static_cast<const int*>(cols);
  const auto* lrow_ = static_cast<const int*>(lrow);
  const auto* vals_ = static_cast<const float*>(vals);
  const auto* ncp_ = static_cast<const int*>(nc_p);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  void* args[] = {&ct_, &cols_, &lrow_, &vals_, &ncp_, &x_, &y_, &NC, &G, &rb, &ct, &N, &Kp,
                  &cpb};
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The kernel of (pw, bf16) into out[0..3]: registers a thread, local
// (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int tile_stream_info(int pw, int bf16, int* out) {
  return runs::kernel_info(stream_kernel(pw, bf16), out);
}

}  // extern "C"
