// nm_structured.cu - the Hopper counterpart of the TPU kernel in
// tpusparse/kernels/nm_structured.py:
//   nm_spmm_launch  replaces _nm_kernel (nm_structured.py:160).
//
// Function.  NmFormat: vals [S, Mp, Gp] (fp32, bf16 or int8) holds the s-th
// kept value of group g of row r, offs its in-group offset: one int8 plane
// [1, Mp, Gp] with slot s in bits [s*bits, (s+1)*bits) when bits > 0, else
// [S, Mp, Gp].  For every row r < Mp and column k < K:
//     y[r, k] = sum_{g < G} sum_{s < S} vals[s, r, g] * X[g*group + off_s(r, g), k]
// with X [G*group, K] fp32 (G <= Gp real groups; the padded groups hold zero
// values and are not walked) and y [Mp, K] fp32, written whole.
//
// Precision, as the TPU kernel's dots: with ROUND (the bf16 mode) the value
// and X are rounded to bf16 (round to nearest even) and their exact product
// is summed in fp32; without it, plain fp32.  int8 values widen exactly
// (the W8A16 mode runs ROUND; the wrapper scales each row afterwards).  The
// offset byte is read as unsigned: the JAX int8 view is signed, the mask
// makes both readings equal.
//
// Design (simple and right first).  The TPU builds, for each of the group's
// offsets, a masked one-hot copy of the values and runs a dense MXU dot per
// offset (nm_structured.py:177-197): that is its mechanism for a gather it
// lacks.  Here a thread reads the slot's offset and loads that X row.  One
// block per (RT rows, 64 columns): the block stages 128 rows of X (128 /
// group groups) for its 64 columns in shared memory with coalesced 16-byte
// loads (rounded once in the bf16 mode), and the chunk's values and decoded
// offsets for its rows; each thread owns RPT rows x 4 columns of y in
// registers (RT = 16 * RPT), and for every (group, slot, row) adds the
// value times one 16-byte read of the staged X row.  y is stored once.  Any
// K is taken; the TPU's 128-lane K padding is not needed.
//
// Bound.  Memory: the packed values and offsets (2:4 bf16: 2.5 bytes per
// group of 4 columns), X and y once; 2 flops per slot and column on the
// CUDA cores.  No tensor cores: Hopper's 2:4 sparse mma (mma.sp) wants its
// own operand and metadata layout, and n_keep:group also covers 1:4 and
// 4:8, which it does not.  See PERF.md for its time against the bound.

#include "gather_common.cuh"

namespace {

using gather::kThreads;
using gather::OptIn;

constexpr int kKT = 64;                              // columns of y per block
constexpr int kCPT = 4;                              // columns per thread (one float4)
constexpr int kColThreads = kKT / kCPT;              // 16
constexpr int kRowThreads = kThreads / kColThreads;  // 16
constexpr int kXRows = 128;                          // rows of X staged per chunk

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Dynamic shared memory of a block: the X chunk, then values (fp32) and
// decoded offsets (one byte) of its rows' slots.
size_t smem_bytes(int S, int rt, int gc) {
  return sizeof(float) * kXRows * kKT + static_cast<size_t>(S) * rt * gc * (sizeof(float) + 1);
}

template <typename VT, bool ROUND, int RPT>
__global__ void __launch_bounds__(kThreads)
nm_kernel(const VT* __restrict__ vals, const int8_t* __restrict__ offs,
          const float* __restrict__ x, float* __restrict__ y, int S, int Mp, int Gp, int G,
          int group, int K, int bits) {
  constexpr int RT = RPT * kRowThreads;
  const int gc = kXRows / group;  // groups per chunk
  float* xs = reinterpret_cast<float*>(gather::gather_smem);  // [kXRows, kKT]
  float* vs = xs + kXRows * kKT;                               // [S, RT, gc]
  uint8_t* os = reinterpret_cast<uint8_t*>(vs + S * RT * gc);  // [S, RT, gc]
  const int row0 = blockIdx.x * RT;
  const int k0 = blockIdx.y * kKT;
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int64_t plane = static_cast<int64_t>(Mp) * Gp;
  const int mask = (1 << bits) - 1;
  const int x_rows = G * group;
  float acc[RPT][kCPT] = {};

  for (int g0 = 0; g0 < G; g0 += gc) {
    __syncthreads();  // the previous chunk is read
    const int xr0 = g0 * group;
    const int chunk_rows = min(gc * group, x_rows - xr0);
    if (K % 4 == 0) {  // 16-byte loads: a float4 lies wholly inside K or past it
      for (int e = threadIdx.x; e < kXRows * (kKT / 4); e += kThreads) {
        const int r = e / (kKT / 4), c = (e % (kKT / 4)) * 4;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < chunk_rows && k0 + c < K) {
          q = *reinterpret_cast<const float4*>(x + static_cast<int64_t>(xr0 + r) * K + k0 + c);
          if constexpr (ROUND) {
            q.x = round_bf16(q.x); q.y = round_bf16(q.y);
            q.z = round_bf16(q.z); q.w = round_bf16(q.w);
          }
        }
        *reinterpret_cast<float4*>(xs + r * kKT + c) = q;
      }
    } else {
      for (int e = threadIdx.x; e < kXRows * kKT; e += kThreads) {
        const int r = e / kKT, c = e % kKT;
        float v = 0.f;
        if (r < chunk_rows && k0 + c < K) {
          v = x[static_cast<int64_t>(xr0 + r) * K + k0 + c];
          if constexpr (ROUND) v = round_bf16(v);
        }
        xs[e] = v;
      }
    }
    for (int e = threadIdx.x; e < S * RT * gc; e += kThreads) {
      const int s = e / (RT * gc), r = (e / gc) % RT, gl = e % gc;
      const int row = row0 + r, g = g0 + gl;
      float v = 0.f;
      int o = 0;
      if (row < Mp && g < G) {
        const int64_t at = static_cast<int64_t>(row) * Gp + g;
        v = widen(vals[s * plane + at]);
        if constexpr (ROUND) v = round_bf16(v);
        o = bits ? (static_cast<uint8_t>(offs[at]) >> (s * bits)) & mask
                 : static_cast<uint8_t>(offs[s * plane + at]);
      }
      vs[e] = v;
      os[e] = static_cast<uint8_t>(o);
    }
    __syncthreads();
    const int gn = min(gc, G - g0);
    for (int gl = 0; gl < gn; ++gl) {
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int e = (s * RT + ty + i * kRowThreads) * gc + gl;
          const float v = vs[e];
          const float4 q =
              *reinterpret_cast<const float4*>(xs + (gl * group + os[e]) * kKT + tx * kCPT);
          acc[i][0] = fmaf(v, q.x, acc[i][0]);
          acc[i][1] = fmaf(v, q.y, acc[i][1]);
          acc[i][2] = fmaf(v, q.z, acc[i][2]);
          acc[i][3] = fmaf(v, q.w, acc[i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + ty + i * kRowThreads;
    if (row >= Mp) continue;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int k = k0 + tx * kCPT + c;
      if (k < K) y[static_cast<int64_t>(row) * K + k] = acc[i][c];
    }
  }
}

template <typename VT, bool ROUND, int RPT>
int launch(const void* vals, const void* offs, const void* x, void* y, int S, int Mp, int Gp,
           int G, int group, int K, int bits, cudaStream_t stream) {
  static OptIn optin;  // of this instantiation
  constexpr int RT = RPT * kRowThreads;
  const auto kernel = nm_kernel<VT, ROUND, RPT>;
  const size_t smem = smem_bytes(S, RT, kXRows / group);
  if (smem > static_cast<size_t>(gather::optin_shared_bytes())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > gather::kDefaultSmem) {
    const cudaError_t err = optin.ensure(reinterpret_cast<const void*>(kernel));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Mp + RT - 1) / RT, (K + kKT - 1) / kKT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const int8_t*>(offs),
      static_cast<const float*>(x), static_cast<float*>(y), S, Mp, Gp, G, group, K, bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int launch_vt(const void* vals, const void* offs, const void* x, void* y, int S, int Mp, int Gp,
              int G, int group, int K, int bits, int round, int rt, cudaStream_t s) {
  if (rt == 64) {
    return round ? launch<VT, true, 4>(vals, offs, x, y, S, Mp, Gp, G, group, K, bits, s)
                 : launch<VT, false, 4>(vals, offs, x, y, S, Mp, Gp, G, group, K, bits, s);
  }
  if (rt == 32) {
    return round ? launch<VT, true, 2>(vals, offs, x, y, S, Mp, Gp, G, group, K, bits, s)
                 : launch<VT, false, 2>(vals, offs, x, y, S, Mp, Gp, G, group, K, bits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y [Mp, K] fp32 (written whole); vals [S, Mp, Gp] of val_code 0 fp32, 1
// bf16, 2 int8; offs int8 [1, Mp, Gp] bit-packed at `bits` bits a slot, or
// [S, Mp, Gp] when bits is 0; x [G*group, K] fp32, 16-byte aligned.  round:
// the bf16 mode.  rt: rows per block, 32 or 64.  Returns the cudaError_t of
// the launch (0 on success).
int nm_spmm_launch(const void* vals, const void* offs, const void* x, void* y, int S, int Mp,
                   int Gp, int G, int group, int K, int bits, int val_code, int round, int rt,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group < 2 || group > kXRows || S < 1 || S > group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (val_code == 0) return launch_vt<float>(vals, offs, x, y, S, Mp, Gp, G, group, K, bits,
                                             round, rt, s);
  if (val_code == 1) return launch_vt<__nv_bfloat16>(vals, offs, x, y, S, Mp, Gp, G, group, K,
                                                     bits, round, rt, s);
  if (val_code == 2) return launch_vt<int8_t>(vals, offs, x, y, S, Mp, Gp, G, group, K, bits,
                                              round, rt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
