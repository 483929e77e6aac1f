// gather_common.cuh - the gather machinery that radix_gather.cu (#9)
// launches, and the opt-in and cp.async copies that the N:M and Block-ELL
// kernels (#12, #13) stage tiles with.  Per-slot shared atomics remain only
// in gather_kernel (#9): the dg, dgt and span kernels #1-#4, #7 and #8
// walk row runs instead (row_walk.cuh), the tile and stripe kernels #5,
// #6, #10 and #11 slot streams (row_runs.cuh).
//
// A format supplies how a slot names its column of X and its row of
// y_rows; everything else is here:
//
//   gather_kernel<Slots, KT, BF16, SHARED_TILE>  one block per (share of
//       program p's chunk range, p, K-tile t).  Its threads take a chunk's
//       slots in order; each live slot (value not zero) is served by KT/4
//       threads that each load 4 contiguous floats of the slot's X row as
//       one 16-byte load (below KT = 4, one thread loads the whole row),
//       straight from device memory through L2.  Products go by shared
//       atomics into an [rb, KT] fp32 row tile, which is then added into
//       the zeroed y_rows with global atomics, skipping entries still
//       zero.  Where the tile exceeds the shared memory a block may opt
//       into, the same kernel adds every product straight into y_rows with
//       global atomics (SHARED_TILE false).
//   Slots  the format's decode: Slots::chunk(c) reads what a chunk shares
//       (radix: its window start), and the chunk's decode maps slot s at
//       flat index i to (col, row); it returns false for a slot that must
//       be skipped.  WindowSlots below is the decode of the formats whose
//       slot names start[chunk] + cols.
//   launch_tiled  picks the shared-tile or the global-atomic instantiation
//       and launches it, opting into more than 48 KB of dynamic shared
//       memory once per kernel and device; launch_window_kt does so for
//       gather_kernel<Slots, KT>.
//   cp_async*  the cp.async copies (global to shared, bypassing registers)
//       with which the N:M and Block-ELL kernels stage their tiles.
//
// The programs' chunk ranges are split over `splits` blocks because the
// TPU geometry gives few programs against 132 SMs.  Chunks at or past
// nc_p[p] hold only zeros and are not walked.
//
// Linkage.  Every definition below is internal to the library that includes
// this header (an unnamed namespace): the sources are separate shared
// libraries in one process, and the static OptIn objects of inline and
// template functions would otherwise be unique process-wide objects
// (STB_GNU_UNIQUE) shared between libraries, so one library's opt-in would
// be taken for another's kernel.
//
// Precision.  fp32: product and sum in fp32.  BF16: the fp32 product is
// rounded to bf16 (__float2bfloat16_rn) and summed in fp32, as the TPU
// kernels feed `p.astype(bf16)` to their fp32-accumulating dot.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace gather {

// Every kernel of the sources takes its dynamic shared memory here.
extern __shared__ float4 gather_smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

// Threads per slot carry VEC contiguous columns each: 4 (one 16-byte load)
// at KT >= 4, else the whole KT-wide row (8 bytes at KT = 2, 4 at KT = 1).
template <int KT>
constexpr int kVec = KT >= 4 ? 4 : KT;

template <int VEC>
__device__ __forceinline__ void load_x(const float* xp, float (&xv)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(xp);
    xv[0] = q.x; xv[1] = q.y; xv[2] = q.z; xv[3] = q.w;
  } else if constexpr (VEC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(xp);
    xv[0] = q.x; xv[1] = q.y;
  } else {
    xv[0] = xp[0];
  }
}

// Adds the VEC products v * xv[i] of one slot into the row tile (shared) or
// into y_rows: columns tcol.. of the tile are columns kcol.. of y_rows.
template <int KT, int VEC, bool BF16, bool SHARED_TILE>
__device__ __forceinline__ void scatter(float* tile, float* yprog, int row, int tcol, int kcol,
                                        int Kp, float v, const float (&xv)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float prod = v * xv[i];
    if constexpr (BF16) prod = __bfloat162float(__float2bfloat16_rn(prod));
    if constexpr (SHARED_TILE) {
      atomicAdd(&tile[row * KT + tcol + i], prod);
    } else {
      atomicAdd(&yprog[static_cast<int64_t>(row) * Kp + kcol + i], prod);
    }
  }
}

// The chunk range [j0, j1) of this block's share of program p; false when
// empty (uniform over the block).
__device__ __forceinline__ bool chunk_range(const int* nc_p, int p, int splits, int& j0,
                                            int& j1) {
  const int ncp = nc_p[p];
  const int per = (ncp + splits - 1) / splits;
  j0 = min(static_cast<int>(blockIdx.x) * per, ncp);
  j1 = min(j0 + per, ncp);
  return j0 < j1;
}

// A slot of a window format: column start[chunk] + cols, row lrow (dg, span
// and radix store each chunk's window start column).  A column at or past N
// is skipped; a checked format has none, so X is never read past N.
struct WindowSlots {
  const int* start;  // [P * NC]
  const int* cols;   // [P * NC * G]
  const int* lrow;   // [P * NC * G]
  int N;

  struct Chunk {
    int64_t cstart;
    const int* cols;
    const int* lrow;
    int N;
    __device__ __forceinline__ bool operator()(int64_t i, int, int64_t& col, int& row) const {
      col = cstart + cols[i];
      row = lrow[i];
      return col < N;
    }
  };
  __device__ __forceinline__ Chunk chunk(int64_t c) const {
    return {static_cast<int64_t>(start[c]), cols, lrow, N};
  }
};

// cp.async: `bytes` (4 or 16) from global to shared without passing through
// registers; with valid false nothing is read and the destination is zeroed.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  static_assert(BYTES == 4 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight;
// their writes are then visible to this thread (to the block after a
// __syncthreads).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int KT>
__device__ __forceinline__ void zero_tile(float* tile, int rb) {
  for (int e = threadIdx.x; e < rb * KT; e += kThreads) tile[e] = 0.f;
  __syncthreads();
}

template <int KT>
__device__ __forceinline__ void flush_tile(const float* tile, float* yprog, int rb, int Kp,
                                           int t) {
  __syncthreads();
  for (int e = threadIdx.x; e < rb * KT; e += kThreads) {
    const float acc = tile[e];
    if (acc != 0.f) atomicAdd(&yprog[static_cast<int64_t>(e / KT) * Kp + t * KT + e % KT], acc);
  }
}

template <class Slots, int KT, bool BF16, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
gather_kernel(Slots slots, const float* __restrict__ vals, const int* __restrict__ nc_p,
              const float* __restrict__ x, float* __restrict__ y, int NC, int G, int rb,
              int Kp, int splits) {
  constexpr int VEC = kVec<KT>;
  constexpr int TPS = KT / VEC;        // threads per slot
  constexpr int SPI = kThreads / TPS;  // slots per block iteration
  float* tile = reinterpret_cast<float*>(gather_smem);  // [rb, KT] when SHARED_TILE

  const int p = blockIdx.y;
  const int t = blockIdx.z;
  int j0, j1;
  if (!chunk_range(nc_p, p, splits, j0, j1)) return;
  if constexpr (SHARED_TILE) zero_tile<KT>(tile, rb);

  const int tcol = (threadIdx.x % TPS) * VEC;
  const int kcol = t * KT + tcol;  // first column of X and Y this thread adds
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  for (int j = j0; j < j1; ++j) {
    const int64_t chunk = static_cast<int64_t>(p) * NC + j;
    const auto slot = slots.chunk(chunk);
    const int64_t base = chunk * G;
    for (int s = threadIdx.x / TPS; s < G; s += SPI) {
      const float v = vals[base + s];
      if (v == 0.f) continue;
      int64_t col;
      int row;
      if (!slot(base + s, s, col, row)) continue;
      float xv[VEC];
      load_x<VEC>(x + col * Kp + kcol, xv);
      scatter<KT, VEC, BF16, SHARED_TILE>(tile, yprog, row, tcol, kcol, Kp, v, xv);
    }
  }
  if constexpr (SHARED_TILE) flush_tile<KT>(tile, yprog, rb, Kp, t);
}

// The most dynamic shared memory a block of the current device may opt
// into, read once per device; 0 when it cannot be read.
inline int optin_shared_bytes() {
  static std::atomic<int> bytes_of[kMaxDevices];  // 0 until read
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  int bytes = bytes_of[dev].load(std::memory_order_relaxed);
  if (bytes == 0) {
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
      return 0;
    bytes_of[dev].store(bytes, std::memory_order_relaxed);
  }
  return bytes;
}

inline size_t tile_bytes(int rb, int kt) { return static_cast<size_t>(rb) * kt * sizeof(float); }

// A kernel's dynamic shared-memory limit, raised to the device's opt-in
// size once per device.  One object per kernel instantiation.
class OptIn {
 public:
  cudaError_t ensure(const void* kernel) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (set_[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin_shared_bytes());
    if (err == cudaSuccess) set_[dev].store(true, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<bool> set_[kMaxDevices] = {};
};

// Launches `shared_kernel` with the [rb, KT] row tile (`tile` bytes of
// dynamic shared memory) where it fits the opt-in limit, else
// `global_kernel` with none; `optin` belongs to `shared_kernel`.  Returns
// the cudaError_t of the launch.
template <typename Kernel, typename... Args>
int launch_tiled(Kernel shared_kernel, Kernel global_kernel, OptIn& optin, dim3 grid,
                 size_t tile, cudaStream_t stream, Args... args) {
  const bool shared = tile <= static_cast<size_t>(optin_shared_bytes());
  const size_t smem = shared ? tile : 0;
  if (smem > kDefaultSmem) {
    const cudaError_t err = optin.ensure(reinterpret_cast<const void*>(shared_kernel));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  (shared ? shared_kernel : global_kernel)<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// gather_kernel<Slots> at KT (radix: any of 1, 2, 4, 8, 16, 32 with or
// without bf16): y [P*rb, Kp] must be zeroed; x is [N, Kp] fp32, Kp a
// multiple of KT.  Only the libraries that call it (a template for that
// reason) compile its kernels.
template <int KT, bool BF16, class Slots>
int launch_window_kt(const Slots& slots, const float* vals, const int* nc_p, const float* x,
                     float* y, int P, int NC, int G, int rb, int Kp, int splits,
                     cudaStream_t stream) {
  static OptIn optin;  // of this instantiation's shared-tile kernel, in this library
  return launch_tiled(gather_kernel<Slots, KT, BF16, true>,
                      gather_kernel<Slots, KT, BF16, false>, optin,
                      dim3(splits, P, Kp / KT), tile_bytes(rb, KT), stream, slots, vals, nc_p,
                      x, y, NC, G, rb, Kp, splits);
}

}  // namespace
}  // namespace gather
