// span_gather.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/span_gather.py:
//   span_spmm_launch    replaces _span_kernel        (span_gather.py:270);
//   span_stream_launch  replaces _span_kernel_stream (span_gather.py:329),
//                       the same Y with each chunk staged in shared memory.
//
// Function.  The format is the JAX package's SpanFormat: P programs of NC
// chunks of G slots whose columns, sorted, fit one window; c0 [P,1,NC]
// holds each chunk's window start (a multiple of 8), cols [P,NC,G] a slot's
// column within the window (< ct), lrow [P,NC,G] its program-local row,
// vals [P,NC,G] its value (0 in padding) or the caller's value plane of the
// same shape; nc_p [P] the real chunk count of each program (the packer's
// chunk walk count).  For each program p, chunk j < nc_p[p] and slot s
// whose value v is not zero:
//     y_rows[p*rb + lrow, k] += v * X[c0[p,j] + cols, k]
// for every column k.  That is what the TPU kernel's one-hot MXU
// contractions over each chunk's [c0, c0+ct) window of X compute.  The
// window may run past N (the TPU padded X by ct rows); here no column at or
// past N is read.
//
// Precision.  fp32 and fp32x2: product and sum in fp32.  bf16: each product
// rounded to bf16, summed in fp32, as in gather_common.cuh.
//
// Design.
//   span_spmm_launch: row_walk.cuh's row walk kernel, as dgt_gather.cu
//   launches it.  A chunk is sorted by column, so in slot order each slot
//   is a row run of its own; the wrapper lists the live slots once per
//   pattern in (row, slot) order (the format's row walk), and the kernel
//   walks them once per panel of up to 512 columns: the trainable layer's
//   K = 512 is one walk, where the shared row tile of gather_common.cuh
//   took 16 (one per K-tile of 32), each with 32 shared CAS adds a slot.
//   With pack_span(keep_perm=True) the live slots are the pattern's, so a
//   stored zero that training makes nonzero is summed; the value plane is
//   its own pointer, so a caller's plane costs no copy.
//   span_stream_kernel: the TPU variant walked chunks on the grid and
//   fetched each chunk's index and value planes by DMA.  Here a block walks
//   its chunks in order; per chunk it copies the three planes (G x 12 B)
//   into shared memory with cp.async, then the X window [c0, c0+ct) x KT in
//   slices of ws rows (all of it where it fits beside the row tile: 32 KB
//   at ct = 1024, KT = 8), each slice staged only when a live slot falls in
//   it; the slots then gather from shared memory.  Rows past N are zeroed.
//
// Bound.  Memory: the walk's 12 bytes a live slot and the value plane
// (span_spmm_launch) or 12 bytes per slot of the format and 4 per chunk
// (stream), plus the X rows gathered and Y; 2 flops per slot and column.
// The stream kernel moves up to ct x KT x 4 bytes of X per chunk.  See
// PERF.md for the times against the bound on the card.

#include "gather_common.cuh"
#include "row_walk.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

// The three planes of one chunk, padded to a multiple of 16 bytes.
__host__ __device__ size_t planes_bytes(int G) {
  return (static_cast<size_t>(3) * G * 4 + 15) / 16 * 16;
}

template <int KT, bool BF16, bool SHARED_TILE>
__global__ void __launch_bounds__(kThreads)
span_stream_kernel(const int* __restrict__ c0, const int* __restrict__ cols,
                   const int* __restrict__ lrow, const float* __restrict__ vals,
                   const int* __restrict__ nc_p, const float* __restrict__ x,
                   float* __restrict__ y, int NC, int G, int rb, int ct, int ws, int N, int Kp,
                   int splits) {
  constexpr int VEC = 4;
  constexpr int TPS = KT / VEC;
  constexpr int SPI = kThreads / TPS;
  constexpr int V4_PER_ROW = KT / VEC;  // float4s per window row of the K-tile
  float* tile = reinterpret_cast<float*>(gather::gather_smem);  // [rb, KT]
  int* cs = reinterpret_cast<int*>(tile + (SHARED_TILE ? rb * KT : 0));  // [G]
  int* ls = cs + G;                                                      // [G]
  float* vs = reinterpret_cast<float*>(ls + G);                          // [G]
  float4* xw = reinterpret_cast<float4*>(reinterpret_cast<char*>(cs) + planes_bytes(G));
  // xw: [ws, KT] of the window slice

  const int p = blockIdx.y;
  const int t = blockIdx.z;
  int j0, j1;
  if (!gather::chunk_range(nc_p, p, splits, j0, j1)) return;
  if constexpr (SHARED_TILE) gather::zero_tile<KT>(tile, rb);

  const int sub = threadIdx.x % TPS;
  const int kcol = t * KT + sub * VEC;
  float* yprog = y + static_cast<int64_t>(p) * rb * Kp;
  for (int j = j0; j < j1; ++j) {
    const int64_t chunk = static_cast<int64_t>(p) * NC + j;
    const int64_t base = chunk * G;
    const int64_t start = c0[chunk];
    __syncthreads();  // the previous chunk's readers are done with the planes
    for (int e = threadIdx.x; e < G; e += kThreads) {
      gather::cp_async<4>(&cs[e], &cols[base + e], true);
      gather::cp_async<4>(&ls[e], &lrow[base + e], true);
      gather::cp_async<4>(&vs[e], &vals[base + e], true);
    }
    gather::cp_async_commit();
    gather::cp_async_wait<0>();
    __syncthreads();
    for (int w0 = 0; w0 < ct; w0 += ws) {
      const int rows = min(ws, ct - w0);
      bool need = false;
      for (int s = threadIdx.x; s < G; s += kThreads) {
        need |= vs[s] != 0.f && cs[s] >= w0 && cs[s] < w0 + rows;
      }
      // also the barrier after the previous slice's readers of xw
      if (!__syncthreads_or(need)) continue;
      for (int e = threadIdx.x; e < rows * V4_PER_ROW; e += kThreads) {
        const int64_t xr = start + w0 + e / V4_PER_ROW;
        const bool in = xr < N;
        const float* src = in ? x + xr * Kp + t * KT + (e % V4_PER_ROW) * VEC : x;
        gather::cp_async<16>(&xw[e], src, in);
      }
      gather::cp_async_commit();
      gather::cp_async_wait<0>();
      __syncthreads();
      for (int s = threadIdx.x / TPS; s < G; s += SPI) {
        const float v = vs[s];
        const int c = cs[s] - w0;
        if (v == 0.f || c < 0 || c >= rows || start + w0 + c >= N) continue;
        const float4 q = xw[c * V4_PER_ROW + sub];
        const float xv[VEC] = {q.x, q.y, q.z, q.w};
        gather::scatter<KT, VEC, BF16, SHARED_TILE>(tile, yprog, ls[s], sub * VEC, kcol, Kp, v,
                                                    xv);
      }
    }
  }
  if constexpr (SHARED_TILE) gather::flush_tile<KT>(tile, yprog, rb, Kp, t);
}

// The window slice (rows) a launch stages: all of [0, ct) where it fits in
// `budget` bytes, else the most rows that do; 0 when not even 8 fit.
int slice_rows(size_t budget, int ct, int kt) {
  const size_t row = static_cast<size_t>(kt) * sizeof(float);
  const size_t fit = budget / row;
  if (fit >= static_cast<size_t>(ct)) return ct;
  return fit >= 8 ? static_cast<int>(fit / 8 * 8) : 0;
}

// Whether a launch keeps the row tile in shared memory, and its slice.
bool stream_geometry(int rb, int kt, int G, int ct, int& ws) {
  const size_t optin = static_cast<size_t>(gather::optin_shared_bytes());
  const size_t tile = gather::tile_bytes(rb, kt);
  const size_t planes = planes_bytes(G);
  if (tile + planes < optin) {
    ws = slice_rows(optin - tile - planes, ct, kt);
    if (ws > 0) return true;
  }
  ws = optin > planes ? slice_rows(optin - planes, ct, kt) : 0;
  return false;
}

template <int KT, bool BF16>
int launch_stream(const int* c0, const int* cols, const int* lrow, const float* vals,
                  const int* nc_p, const float* x, float* y, int P, int NC, int G, int rb,
                  int ct, int N, int Kp, int splits, cudaStream_t stream) {
  static OptIn optin_shared, optin_global;  // one per kernel of this instantiation
  int ws = 0;
  const bool shared = stream_geometry(rb, KT, G, ct, ws);
  if (ws <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (shared ? gather::tile_bytes(rb, KT) : 0) + planes_bytes(G) +
                      static_cast<size_t>(ws) * KT * sizeof(float);
  auto kernel =
      shared ? span_stream_kernel<KT, BF16, true> : span_stream_kernel<KT, BF16, false>;
  if (smem > gather::kDefaultSmem) {
    const cudaError_t err = (shared ? optin_shared : optin_global)
                                .ensure(reinterpret_cast<const void*>(kernel));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(splits, P, Kp / KT), kThreads, smem, stream>>>(c0, cols, lrow, vals, nc_p, x, y,
                                                               NC, G, rb, ct, ws, N, Kp, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 when a block of the stream kernel at (rb, kt) keeps its [rb, kt] row
// tile in shared memory beside its planes and window slice, 0 when it
// takes the global-atomic branch.
int span_uses_shared_tile(int rb, int kt, int G, int ct) {
  int ws = 0;
  return stream_geometry(rb, kt, G, ct, ws) ? 1 : 0;
}

// The rows of the X window the stream kernel stages at once.
int span_stream_slice_rows(int rb, int kt, int G, int ct) {
  int ws = 0;
  stream_geometry(rb, kt, G, ct, ws);
  return ws;
}

// The row walk kernel over the S slots of a walk (row, col, slot int32
// [S]): values vals[slot[i]] from a value plane with gather, else the
// walk's own vals[i]; y [rows, ld] must be zeroed; x is [N, ld] fp32; the
// first kc columns in panels of pw, bs slots a block.  Returns the
// cudaError_t of the launch (0 on success).
int span_spmm_launch(const void* row, const void* col, const void* slot, const void* vals,
                     const void* x, void* y, int S, int ld, int kc, int pw, int bf16, int bs,
                     int gather, void* stream) {
  return runs::walk_launch(row, col, slot, vals, x, y, S, ld, kc, pw, bf16, bs, gather, stream);
}

// The row walk kernel of (pw, bf16) into out[0..3]: registers a thread,
// local (spill) bytes a thread, static shared bytes, blocks an SM holds.
// Returns a cudaError_t.
int span_walk_info(int pw, int bf16, int* out) {
  return runs::kernel_info(runs::walk_kernel_of(pw, bf16), out);
}

// The same function, each chunk's planes and X window staged in shared
// memory.
int span_stream_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
                       const void* nc_p, const void* x, void* y, int P, int NC, int G, int rb,
                       int ct, int N, int Kp, int kt, int bf16, int splits, void* stream) {
  const auto* c0_ = static_cast<const int*>(c0);
  const auto* cols_ = static_cast<const int*>(cols);
  const auto* lrow_ = static_cast<const int*>(lrow);
  const auto* vals_ = static_cast<const float*>(vals);
  const auto* ncp_ = static_cast<const int*>(nc_p);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
#define SPAN_CASE(KT)                                                                        \
  if (kt == KT) {                                                                            \
    return bf16 ? launch_stream<KT, true>(c0_, cols_, lrow_, vals_, ncp_, x_, y_, P, NC, G,   \
                                          rb, ct, N, Kp, splits, s)                          \
                : launch_stream<KT, false>(c0_, cols_, lrow_, vals_, ncp_, x_, y_, P, NC, G,  \
                                           rb, ct, N, Kp, splits, s);                        \
  }
  SPAN_CASE(8)
  SPAN_CASE(16)
  SPAN_CASE(32)
#undef SPAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
