// tile_onehot.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/tile_onehot.py:
//   tile_spmm_launch    replaces _tile_kernel        (tile_onehot.py:44), X
//                       read where it lies;
//   tile_stream_launch  replaces _tile_kernel_stream (tile_onehot.py:119),
//                       the same Y, the format walked once per wide panel
//                       of columns and each row run added once.
//
// Function.  The format is the JAX package's TileFormat: P programs of NC
// chunks of G slots; chunk_tile [P,1,NC] holds each chunk's column tile,
// cols [P,NC,G] a slot's column within the tile (< ct), lrow [P,NC,G] its
// program-local row, vals [P,NC,G] its value (0 in padding); nc_p [P] the
// real chunk count of each program (the packer's chunks_per_p).  For each
// program p, chunk j < nc_p[p] and slot s whose value v is not zero:
//     y_rows[p*rb + lrow, k] += v * X[chunk_tile[p,j]*ct + cols, k]
// for every column k < Kp.  That is what the TPU kernel's two one-hot
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
//   X window by DMA because X could not stay in VMEM, and ran its grid in
//   order over one resident row block, so it needed no atomics.  Blocks run
//   at once here; a shared [rb, 32] tile with per-slot shared atomics (the
//   resident kernel's way) walks the format once per K-tile of 32, 8 times
//   at config #1, K = 256, with 256M shared atomics, lanes of one warp on
//   one row's addresses (4.38 ms against a 0.0225 ms bound).  This design
//   walks the format once per panel of up to 512 columns and adds once per
//   row run:
//     - a stream of LPS lanes (LPS = PW/4, at most 32; PW the panel width,
//       the narrowest of 8..512 that holds Kp) takes a contiguous run of a
//       block's slots; it loads LPS slots' value, column and row at once,
//       coalesced, and broadcasts each slot with __shfl_sync;
//     - for each live slot the stream reads the slot's X row across its
//       lanes (NV float4 a lane, neighbouring lanes on neighbouring 16
//       bytes: one 1 KB row at PW = 256), four rows in flight;
//     - pack_tile sorts a chunk's slots by (row, column), so consecutive
//       slots of one row sum in registers; the stream adds a row run into
//       y_rows once, by float4 atomicAdd (red.global.add.v4.f32 on sm_90),
//       its lanes on distinct addresses.  At config #1 the 1.0M slots make
//       0.20M runs (PERF.md).  No shared memory and at most 80 registers
//       (no spills at a 512-column panel): 3 blocks of 8 warps fit an SM,
//       where a 128 KB tile and its staging ring allowed one;
//     - a block takes `cpb` chunks of one program (about 1024 slots, the
//       wrapper's choice), so the uneven programs of an unsorted power law
//       are cut into many small blocks.
//   The rb of the format does not enter: y_rows is written in device memory
//   (L2) whatever its size.
//
// Bound.  Memory: 12 bytes per slot of the format (cols, lrow, vals), 4 per
// chunk (chunk_tile), plus X and Y once; 2 flops per slot and column.  The
// stream kernel reads each live slot's X row from L2 (1 KB a slot at K =
// 256): about 1 GB a call at config #1.  See PERF.md for the times.

#include "gather_common.cuh"

namespace {

using gather::kThreads;

// A stream's lanes and float4s a lane for a panel of PW columns.
template <int PW>
constexpr int kLanes = PW / 4 < 32 ? PW / 4 : 32;
template <int PW>
constexpr int kNv = PW / 4 / kLanes<PW>;

template <int PW, bool BF16>
__global__ void __launch_bounds__(kThreads, 3)
tile_stream_kernel(const int* __restrict__ chunk_tile, const int* __restrict__ cols,
                   const int* __restrict__ lrow, const float* __restrict__ vals,
                   const int* __restrict__ nc_p, const float* __restrict__ x,
                   float* __restrict__ y, int NC, int G, int rb, int ct, int N, int Kp, int cpb) {
  constexpr int LPS = kLanes<PW>;
  constexpr int NV = kNv<PW>;
  constexpr int STREAMS = kThreads / LPS;
  constexpr int U = NV >= 4 ? 2 : 4;  // X rows in flight in a stream
  const int p = blockIdx.y;
  const int ncp = nc_p[p];
  const int j0 = static_cast<int>(blockIdx.x) * cpb;
  if (j0 >= ncp) return;
  const int j1 = min(j0 + cpb, ncp);
  const int lane = threadIdx.x % LPS;
  const unsigned smask = LPS == 32 ? 0xffffffffu  // the stream's lanes in its warp
                                   : ((1u << (LPS % 32)) - 1u) << (threadIdx.x % 32 / LPS * LPS);
  const int n = (j1 - j0) * G;  // the block's slots, flat from chunk j0 of program p
  const int per = (n + STREAMS - 1) / STREAMS;
  const int s0 = min(static_cast<int>(threadIdx.x / LPS) * per, n);
  const int s1 = min(s0 + per, n);
  const int64_t first = (static_cast<int64_t>(p) * NC + j0) * G;
  const int col0 = blockIdx.z * PW;
  float* yp = y + static_cast<int64_t>(p) * rb * Kp;

  float acc[NV][4] = {};
  int cur = -1;  // the row of the run in acc
  auto flush = [&]() {
    float* yr = yp + static_cast<int64_t>(cur) * Kp;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int c = col0 + (q * LPS + lane) * 4;
      if (c < Kp) {
        atomicAdd(reinterpret_cast<float4*>(yr + c),
                  make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
    }
  };

  for (int base = s0; base < s1; base += LPS) {
    // lane i loads slot base + i: its value (0 for a skipped slot), column and row
    float v = 0.f;
    int col = 0, row = 0;
    if (base + lane < s1) {
      const int64_t fi = first + base + lane;
      v = vals[fi];
      if (v != 0.f) {
        const int64_t chunk = static_cast<int64_t>(p) * NC + j0 + (base + lane) / G;
        const int64_t c = static_cast<int64_t>(chunk_tile[chunk]) * ct + cols[fi];
        row = lrow[fi];
        if (c < N) {
          col = static_cast<int>(c);
        } else {
          v = 0.f;
        }
      }
    }
    const int cnt = min(LPS, s1 - base);
    for (int jb = 0; jb < cnt; jb += U) {
      float vj[U];
      int rj[U];
      float4 xv[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = min(jb + u, LPS - 1);
        vj[u] = __shfl_sync(smask, v, src, LPS);
        rj[u] = __shfl_sync(smask, row, src, LPS);
        const int cj = __shfl_sync(smask, col, src, LPS);
        if (jb + u >= cnt) vj[u] = 0.f;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int c = col0 + (q * LPS + lane) * 4;
          xv[u][q] = vj[u] != 0.f && c < Kp
                         ? *reinterpret_cast<const float4*>(x + static_cast<int64_t>(cj) * Kp + c)
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

template <int PW>
const void* stream_kernel_of(int bf16) {
  return bf16 ? reinterpret_cast<const void*>(tile_stream_kernel<PW, true>)
              : reinterpret_cast<const void*>(tile_stream_kernel<PW, false>);
}

// The stream kernel for a panel of pw columns, or nullptr.
const void* stream_kernel(int pw, int bf16) {
  switch (pw) {
    case 8: return stream_kernel_of<8>(bf16);
    case 16: return stream_kernel_of<16>(bf16);
    case 32: return stream_kernel_of<32>(bf16);
    case 64: return stream_kernel_of<64>(bf16);
    case 128: return stream_kernel_of<128>(bf16);
    case 256: return stream_kernel_of<256>(bf16);
    case 512: return stream_kernel_of<512>(bf16);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// 1 when a block of the resident kernel at (rb, kt) keeps its [rb, kt]
// row tile in shared memory, 0 when it takes the global-atomic branch.
int tile_uses_shared_tile(int rb, int kt) {
  return gather::tile_bytes(rb, kt) <= static_cast<size_t>(gather::optin_shared_bytes());
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

// The same function, walked once per panel of pw columns (8, 16, ..., 512;
// Kp a multiple of 4), `cpb` chunks of a program a block.  y [P*rb, Kp]
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

// The stream kernel of (pw, bf16) into out[0..3]: registers a thread, local
// (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int tile_stream_info(int pw, int bf16, int* out) {
  const void* kernel = stream_kernel(pw, bf16);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // extern "C"
