// gather_common.cuh - the staging pieces that the N:M, Block-ELL and SDDMM
// kernels (#12, #13, #14, #15) share: the dynamic shared memory they stage
// tiles in, the opt-in past 48 KB of it, and the cp.async copies.  No
// kernel of the port adds products by shared atomics one slot at a time any
// more: the dg, dgt, span and radix kernels #1-#4, #7-#9 walk row runs
// (row_walk.cuh), the tile and stripe kernels #5, #6, #10 and #11 slot
// streams (row_runs.cuh).
//
//   gather_smem  the dynamic shared memory of every kernel that includes
//       this header;
//   OptIn  a kernel's dynamic shared-memory limit raised to the device's
//       opt-in size, once per kernel and device (optin_shared_bytes);
//   cp_async*  the cp.async copies (global to shared, bypassing registers)
//       with which the N:M, Block-ELL and SDDMM kernels stage tiles;
//   mbar_*, bulk_copy  shared-memory barriers (mbarrier) and the bulk copies
//       (TMA) that land on them, between a warp that stages and the warps
//       that read the stages (#15's column walk).
//
// Linkage.  Every definition below is internal to the library that includes
// this header (an unnamed namespace): the sources are separate shared
// libraries in one process, and the static OptIn objects of inline and
// template functions would otherwise be unique process-wide objects
// (STB_GNU_UNIQUE) shared between libraries, so one library's opt-in would
// be taken for another's kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace gather {

// Every kernel of the sources takes its dynamic shared memory here.
extern __shared__ float4 gather_smem[];

namespace {

constexpr int kMaxDevices = 64;

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

// mbarriers in shared memory: `count` arrivals complete a phase; a waiter
// names the parity of the phase it waits for.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}
// Arrives on `bar` and adds `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// A bulk copy (the TMA) of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared, its landing counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
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

}  // namespace
}  // namespace gather
