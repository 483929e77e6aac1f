// sddmm.cu - the Hopper counterparts of the two TPU kernels in
// tpusparse/kernels/sddmm.py, the gradients of Y = A(v) . X over a fixed
// span pattern with trainable values v:
//   sddmm_launch  replaces _sddmm_kernel (sddmm.py:72), the value gradient;
//   dx_launch     replaces _dx_kernel    (sddmm.py:167), the input gradient.
//
// Function.  The format is the JAX package's SpanFormat (span_gather.cu):
// c0 [P,1,NC] each chunk's window start, cols [P,NC,G] a slot's column
// within the window, lrow [P,NC,G] its program-local row, nc_p [P] the real
// chunk count of each program.  dY_slots [P*rb, Kp] is dY in slot order
// (row p*rb + lrow of a slot is the slot's row of Y), X [N, Kp], both fp32,
// Kp a multiple of 4.  For program p, chunk j < nc_p[p], slot s, with
// col = c0[p,j] + cols[p,j,s] and row = p*rb + lrow[p,j,s]:
//   sddmm:  dv[p,j,s]   = sum_k dY_slots[row, k] * X[col, k]
//           (every slot of a walked chunk, padding too: the caller masks it
//           with occupancy_mask; slots of chunks past nc_p get 0);
//   dx:     dX[col, k] += vals[p,j,s] * dY_slots[row, k]
//           (slots whose value is not zero), dX [N, Kp] zeroed by the caller.
// The TPU gathered both rows with one-hot MXU dots (_gather_rows) and ran a
// grid of K-tiles that added into one resident block; here a thread loads
// the rows it needs and the K-tiles are a loop inside the kernel.
//
// Precision.  fp32 and fp32x2: products and sums in fp32.  bf16: as the TPU
// kernels' bf16 operands, sddmm rounds X and dY to bf16 before each
// product (summed in fp32); dx rounds dY to bf16 and then each product
// v * dY to bf16 before it is added (in fp32).
//
// Design (simple and right first).
//   sddmm_kernel: one block of 128 threads per (chunk, program), so the 8
//   programs of a 4096-row weight at rb = 512 still give NC * P blocks
//   (13,112 at the pruned 4096^2 weight).  Each slot is served by tps
//   lanes of one warp (a power of two up to 32, as many as the row has
//   float4s), which walk the row's float4s, take the dot product and reduce
//   it by warp shuffles; slots are independent, so there are no atomics.
//   dx_kernel: one block of 128 threads per (chunk, program), the chunk's
//   three planes staged in shared memory.  The threads split into streams
//   of tps threads (one float4 column of dY each, up to 128 threads); each
//   stream walks a contiguous run of the chunk's slots.  A chunk's slots
//   are sorted by column (pack_span), so a stream sums the products of
//   equal columns in registers and adds the sum into dX with one fp32
//   atomicAdd per column and k when the column changes.  A pruned weight's
//   chunk of 128 slots holds a few columns (about 51 nonzeros per column
//   per program at 90 % sparsity and rb = 512), so this takes about 40x
//   fewer atomics than one per product.  The atomics make the order of
//   the sums vary from run to run: dX agrees with its plain version to
//   rounding, not bit for bit.
//
// Bound.  Both do 2 flops per slot and column of K (1.72 GFLOP at the
// pruned 4096^2 weight, K = 512: 0.026 ms at the fp32 peak of 67 TFLOP/s;
// each input once is 37 MB, 0.011 ms at 3.35 TB/s).  The design reads each
// slot's dY row (and X row for sddmm) again for every slot that needs it,
// from L2 where dY and X fit (8.4 MB each at that shape): 2 KB per slot
// and operand at K = 512, so L2 bandwidth, not HBM, sets the time.  Reuse
// across a chunk's slots (a staged dY tile, wgmma on gathered tiles) is
// later work.  See PERF.md for the times against the bound on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPlaneSmem = 48 * 1024;  // dx's staged planes: G <= 4096 slots

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Threads per slot (sddmm) or per stream (dx): the largest power of two up
// to `cap` and up to the row's q4 float4s (1 for a row of one float4).
int threads_per_slot(int q4, int cap) {
  int t = 1;
  while (t * 2 <= cap && t * 2 <= q4) t *= 2;
  return t;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ c0, const int* __restrict__ cols,
             const int* __restrict__ lrow, const int* __restrict__ nc_p,
             const float4* __restrict__ dy, const float4* __restrict__ x,
             float* __restrict__ dv, int NC, int G, int rb, int N, int q4, int tps) {
  const int j = blockIdx.x;
  const int p = blockIdx.y;
  const int64_t chunk = static_cast<int64_t>(p) * NC + j;
  const int64_t base = chunk * G;
  float* out = dv + base;
  if (j >= nc_p[p]) {  // a chunk past the walk holds only padding
    for (int s = threadIdx.x; s < G; s += kThreads) out[s] = 0.f;
    return;
  }
  const int spi = kThreads / tps;  // slots per block iteration
  const int sub = threadIdx.x % tps;
  const int64_t start = c0[chunk];
  // every lane runs every iteration: the shuffles below need the whole warp
  for (int s0 = 0; s0 < G; s0 += spi) {
    const int s = s0 + static_cast<int>(threadIdx.x) / tps;
    float acc = 0.f;
    if (s < G) {
      const int64_t col = start + cols[base + s];
      const int64_t row = static_cast<int64_t>(p) * rb + lrow[base + s];
      if (col < N) {
        const float4* xr = x + col * q4;
        const float4* dr = dy + row * q4;
        for (int q = sub; q < q4; q += tps) {
          float4 a = xr[q];
          float4 b = dr[q];
          if constexpr (BF16) {
            a = make_float4(bf16_round(a.x), bf16_round(a.y), bf16_round(a.z), bf16_round(a.w));
            b = make_float4(bf16_round(b.x), bf16_round(b.y), bf16_round(b.z), bf16_round(b.w));
          }
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      }
    }
    for (int off = tps / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (s < G && sub == 0) out[s] = acc;
  }
}

// Adds one column's summed products into dX (a column at or past N, which
// a checked format has none of, is dropped).
__device__ __forceinline__ void flush(float* dx, int64_t col, int N, int q4, int q,
                                      const float4& acc) {
  if (col >= N) return;
  float* d = dx + (col * q4 + q) * 4;
  atomicAdd(d + 0, acc.x);
  atomicAdd(d + 1, acc.y);
  atomicAdd(d + 2, acc.z);
  atomicAdd(d + 3, acc.w);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const int* __restrict__ c0, const int* __restrict__ cols,
          const int* __restrict__ lrow, const float* __restrict__ vals,
          const int* __restrict__ nc_p, const float4* __restrict__ dy, float* __restrict__ dx,
          int NC, int G, int rb, int N, int q4, int tps) {
  extern __shared__ int planes[];  // cols [G], lrow [G], vals [G]
  const int j = blockIdx.x;
  const int p = blockIdx.y;
  if (j >= nc_p[p]) return;
  const int64_t chunk = static_cast<int64_t>(p) * NC + j;
  const int64_t base = chunk * G;
  int* cs = planes;
  int* ls = cs + G;
  float* vs = reinterpret_cast<float*>(ls + G);
  for (int e = threadIdx.x; e < G; e += kThreads) {
    cs[e] = cols[base + e];
    ls[e] = lrow[base + e];
    vs[e] = vals[base + e];
  }
  __syncthreads();
  const int streams = kThreads / tps;
  const int stream = static_cast<int>(threadIdx.x) / tps;
  const int sub = threadIdx.x % tps;
  const int per = (G + streams - 1) / streams;
  const int s_lo = min(stream * per, G);
  const int s_hi = min(s_lo + per, G);
  const int64_t start = c0[chunk];
  const float4* dprog = dy + static_cast<int64_t>(p) * rb * q4;
  for (int q = sub; q < q4; q += tps) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int cur = -1;
    for (int s = s_lo; s < s_hi; ++s) {
      const float v = vs[s];
      if (v == 0.f) continue;
      const int c = cs[s];
      if (c != cur) {
        if (cur >= 0) flush(dx, start + cur, N, q4, q, acc);
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        cur = c;
      }
      float4 d = dprog[static_cast<int64_t>(ls[s]) * q4 + q];
      if constexpr (BF16) {
        acc.x += bf16_round(v * bf16_round(d.x));
        acc.y += bf16_round(v * bf16_round(d.y));
        acc.z += bf16_round(v * bf16_round(d.z));
        acc.w += bf16_round(v * bf16_round(d.w));
      } else {
        acc.x = fmaf(v, d.x, acc.x);
        acc.y = fmaf(v, d.y, acc.y);
        acc.z = fmaf(v, d.z, acc.z);
        acc.w = fmaf(v, d.w, acc.w);
      }
    }
    if (cur >= 0) flush(dx, start + cur, N, q4, q, acc);
  }
}

bool bad_geometry(int P, int NC, int G, int rb, int N, int Kp) {
  return P < 1 || P > 65535 || NC < 1 || G < 1 || rb < 1 || N < 1 || Kp < 4 || Kp % 4;
}

}  // namespace

extern "C" {

// dv [P,NC,G] fp32 (every slot written); dy [P*rb, Kp] and x [N, Kp] fp32,
// 16-byte aligned, Kp a multiple of 4.  Returns the cudaError_t of the
// launch (0 on success).
int sddmm_launch(const void* c0, const void* cols, const void* lrow, const void* nc_p,
                 const void* dy, const void* x, void* dv, int P, int NC, int G, int rb, int N,
                 int Kp, int bf16, void* stream) {
  if (bad_geometry(P, NC, G, rb, N, Kp)) return static_cast<int>(cudaErrorInvalidValue);
  const int q4 = Kp / 4;
  const int tps = threads_per_slot(q4, 32);
  const dim3 grid(NC, P);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? sddmm_kernel<true> : sddmm_kernel<false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(c0), static_cast<const int*>(cols), static_cast<const int*>(lrow),
      static_cast<const int*>(nc_p), static_cast<const float4*>(dy),
      static_cast<const float4*>(x), static_cast<float*>(dv), NC, G, rb, N, q4, tps);
  return static_cast<int>(cudaGetLastError());
}

// dx [N, Kp] fp32 must be zeroed; vals [P,NC,G] fp32; dy [P*rb, Kp] fp32,
// 16-byte aligned, Kp a multiple of 4; G at most 4096.  Returns the
// cudaError_t of the launch.
int dx_launch(const void* c0, const void* cols, const void* lrow, const void* vals,
              const void* nc_p, const void* dy, void* dx, int P, int NC, int G, int rb, int N,
              int Kp, int bf16, void* stream) {
  const size_t smem = static_cast<size_t>(3) * G * sizeof(int);
  if (bad_geometry(P, NC, G, rb, N, Kp) || smem > kMaxPlaneSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q4 = Kp / 4;
  const int tps = threads_per_slot(q4, kThreads);
  const dim3 grid(NC, P);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? dx_kernel<true> : dx_kernel<false>;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int*>(c0), static_cast<const int*>(cols), static_cast<const int*>(lrow),
      static_cast<const float*>(vals), static_cast<const int*>(nc_p),
      static_cast<const float4*>(dy), static_cast<float*>(dx), NC, G, rb, N, q4, tps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
