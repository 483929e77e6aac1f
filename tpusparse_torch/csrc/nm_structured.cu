// nm_structured.cu - the Hopper counterpart of the TPU kernel in
// tpusparse/kernels/nm_structured.py:
//   nm_spmm_launch  replaces _nm_kernel (nm_structured.py:160).
//
// Function.  NmFormat: vals [S, Mp, Gp] (fp32, bf16 or int8) holds the s-th
// kept value of group g of row r, offs its in-group offset: one int8 plane
// [1, Mp, Gp] with slot s in bits [s*bits, (s+1)*bits) when bits > 0, else
// [S, Mp, Gp].  For every row r < Mp and column k < K:
//     y[r, k] = sum_{g < G} sum_{s < S} vals[s, r, g] * X[g*group + off_s(r, g), k]
// with X [G*group, ldx] (G <= Gp real groups; the padded groups are not
// walked) and y [Mp, K] fp32, written whole.  The offset byte is read as
// unsigned: the JAX int8 view is signed, the mask makes both readings equal.
//
// Precision, as the TPU kernel's dots (nm_structured.py:184-197).  bf16
// mode: X arrives as bf16 (the wrapper rounds it to nearest even, as the
// TPU's wrapper casts it), each value is rounded to bf16, and their exact
// products are summed in fp32 by bf16 tensor-core wgmma.  int8 values widen
// exactly (W8A16; the wrapper scales each row afterwards).  fp32 mode: X
// and the values stay fp32; each operand is split into a tf32 pair (hi =
// tf32(a), lo = tf32(a - hi)) and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi run on
// tf32 mma (3xTF32, relative error near 2^-21 per product).  Each 64-deep
// step sums into fresh registers that are then added in fp32, so the
// tensor cores' truncating accumulation spans 24 products of one step,
// never the whole depth.  A group's kept values sit at distinct offsets
// (the packers make them so; nm_format_from_numpy refuses a format that
// does not): each is stored once into its place.
//
// Bound.  2:4 bf16 at 4096^2, K = 512: 37.7 MB (the format, X, y) is 0.011
// ms at 3.35 TB/s; the dense-equivalent tensor-core work, 17.2 GFLOP, is
// 0.017 ms at 989 TFLOP/s.  The TPU ran every contraction on its MXU; a
// kernel on the CUDA cores with no reuse of X ran 41x behind cuBLAS's dense
// product here.
//
// Design: an N:M weight is a dense A whose tiles are rebuilt in shared
// memory from the packed slots, then a tensor-core GEMM.  A block owns a
// [BM, BN] tile of y (bf16: 128 x 256 past K = 128, else 128 x 128, two
// warpgroups of 64 rows; fp32: 64 x 128, 8 warps of 32 x 32) and walks the
// depth in steps of 64 weight columns (rows of X):
//   - X [64, BN] is copied by cp.async two steps ahead (a ring of 4 stages
//     in bf16, 3 in fp32): bf16 in 64-column blocks in the 128-byte
//     swizzle that an MN-major wgmma descriptor reads; fp32 with rows
//     padded against bank conflicts; past the depth or ldx, zeros;
//   - the step's slots (values and offset bytes of BM rows) are staged the
//     same way one step further ahead, in 16-byte copies, when the group
//     is 2, 4, 8 or 16 and Gp a multiple of 16 (every packer's layout); one
//     thread per (row, 16 columns) then loads a slot's values and offsets
//     of the span with one vector load each, places each kept value at its
//     offset in registers and writes the span of the A tile [BM, 64] with
//     16-byte stores: bf16 K-major in the 128-byte swizzle, fp32 padded;
//   - any other group (3, 5-7, > 16; one may straddle two steps), or slices
//     too large for shared memory, take the direct path: one thread per
//     (row, group touching the step) reads the slots from device memory
//     and writes the group's columns, clipped to the step;
//   - bf16: each warpgroup issues four wgmma.m64nBNk16 on its 64 rows (A
//     and X by descriptor) and goes on: the tensor cores multiply step i
//     while the warps rebuild the A tile of step i + 1 (3 A stages); a
//     warpgroup keeps at most two steps in flight.  fp32: mma.sync m16n8k8
//     tf32 x3 from scalar fragment loads (2 A stages), after the rebuild.
// One __syncthreads per step.  Where the tiles of y are fewer than the
// SMs the wrapper splits the depth over `splits` blocks that add into a
// zeroed y with atomics.  Hopper's 2:4 sparse mma (mma.sp) would halve the
// tensor-core work for 2:4 only (its metadata wants distinct, ordered
// index pairs; a group with one kept value at offset 0 breaks that) and
// is left out: see PERF.md for whether this kernel is bound by its bytes
// or by the tensor cores.

#include "gather_common.cuh"
#include "tensor_core.cuh"

namespace {

using gather::OptIn;

constexpr int kBK = 64;                 // weight columns (rows of X) per depth step
constexpr int kWarps = 8;
constexpr int kThreadsNm = 32 * kWarps;
constexpr int kRawStages = 3;           // staged slots: three steps ahead

template <bool TF32, int BNB = 128>
struct Tile;

// A block's tile of y is [BM, BN]; its 8 warps stand WM x WN, each owning a
// warp tile of MT m16 by NT n8 mma tiles (BM = WM * MT * 16, BN = WN * NT * 8).
template <int BNB>
struct Tile<false, BNB> {  // bf16, wgmma.m64nBNk16: a warpgroup's 4 warps own 64 rows
  using E = __nv_bfloat16;
  static constexpr int BM = 128, BN = BNB, WN = 1, MT = 1, NT = BNB / 8;
  // Both operands sit in the 128-byte swizzle that wgmma descriptors read
  // (16-byte chunk c of a 128-byte row r at chunk c ^ (r % 8)): the A tile
  // [BM][kBK] K-major, the X tile [kBK][BN] as BN / 64 MN-major blocks
  // [kBK][64].
  static constexpr int LDA = kBK, XSTAGE = BN * kBK;
  // X two steps ahead of the step multiplied and of the one still in
  // flight; A one ahead of both
  static constexpr int XSTAGES = 4, ASTAGES = 3;
};

template <int BNB>
struct Tile<true, BNB> {  // fp32 operands split into tf32 pairs, mma.m16n8k8
  using E = float;
  static constexpr int BM = 64, BN = 128, WN = 4, MT = 2, NT = 4;
  // A fragments read (g, t): g*68 + t covers 32 banks; B fragments (t, g):
  // t*136 + g does too
  static constexpr int LDA = kBK + 4, LDB = BN + 8, XSTAGE = kBK * LDB;
  static constexpr int XSTAGES = 3, ASTAGES = 2;  // X two steps ahead, A one
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

template <typename E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N bytes (1, 2, 4, 8, 16 or 32) at p, aligned to min(N, 16), as words.
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[8]) {
  if constexpr (N == 32) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (N == 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else if constexpr (N == 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *p;
  }
}

// Element i of VT values packed in words.
__device__ __forceinline__ float word_elem(const uint32_t (&w)[8], int i, float) {
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float word_elem(const uint32_t (&w)[8], int i, __nv_bfloat16) {
  return __uint_as_float(((w[i / 2] >> (16 * (i % 2))) & 0xFFFFu) << 16);
}
__device__ __forceinline__ float word_elem(const uint32_t (&w)[8], int i, int8_t) {
  return static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xFFu));
}

// Element (r, c) of an A tile: bf16 in the 128-byte swizzle, fp32 with
// rows padded to LDA.
__device__ __forceinline__ __nv_bfloat16* a_elem(__nv_bfloat16* A, int r, int c) {
  return A + r * kBK + (((c / 8) ^ (r & 7)) * 8) + c % 8;
}
__device__ __forceinline__ float* a_elem(float* A, int r, int c) {
  return A + r * Tile<true>::LDA + c;
}

// Columns [16q, 16q + 16) of row r of an A tile, as E: two swizzled 16-byte
// stores of bf16 (rounded to nearest even), or four of fp32.
__device__ __forceinline__ void store_span(__nv_bfloat16* A, int r, int q, const float (&v)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(a_elem(A, r, 16 * q)) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(a_elem(A, r, 16 * q + 8)) = make_uint4(w[4], w[5], w[6], w[7]);
}
__device__ __forceinline__ void store_span(float* A, int r, int q, const float (&v)[16]) {
  float4* p = reinterpret_cast<float4*>(a_elem(A, r, 16 * q));
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// The staged path: one thread per (row, span of 16 columns) of the A tile
// [BM, kBK], for a group of GROUP (2, 4, 8 or 16) columns: the span's
// 16 / GROUP groups.  From the step's slice (values [S][BM][GK], then
// offset bytes [So][BM][GK], So = 1 when bit-packed) it loads each slot's
// values and the offset bytes of the span with one vector load each,
// places every kept value at its offset in registers and writes the span
// with 16-byte stores.  Groups >= G and rows >= Mp stay zero.
template <int GROUP, bool TF32, typename VT>
__device__ __forceinline__ void rebuild_staged(typename Tile<TF32>::E* A, const uint8_t* slice,
                                               int GK, int g0, int row0, int Mp, int G, int S,
                                               int bits) {
  using T = Tile<TF32>;
  constexpr int kSpans = kBK / 16;
  constexpr int GPS = 16 / GROUP;  // groups a span
  constexpr int VB = GPS * static_cast<int>(sizeof(VT));  // value bytes of a slot's span
  const uint8_t* ob = slice + static_cast<size_t>(S) * T::BM * GK * sizeof(VT);
  for (int e = threadIdx.x; e < T::BM * kSpans; e += kThreadsNm) {
    const int r = e / kSpans, q = e % kSpans;
    float val[16] = {};
    const int live = row0 + r < Mp ? min(GPS, G - g0 - q * GPS) : 0;  // groups before G
    if (live > 0) {
      uint32_t vw[8], ow[8];
      const int at = r * GK + q * GPS;  // the span's first group, slot 0
      if (bits) load_words<GPS>(ob + at, ow);
      for (int s = 0; s < S; ++s) {
        load_words<VB>(slice + (static_cast<size_t>(s) * T::BM * GK + at) * sizeof(VT), vw);
        if (!bits) load_words<GPS>(ob + static_cast<size_t>(s) * T::BM * GK + at, ow);
#pragma unroll
        for (int gg = 0; gg < GPS; ++gg) {
          const float v = gg < live ? word_elem(vw, gg, VT{}) : 0.f;
          const unsigned byte = (ow[gg / 4] >> (8 * (gg % 4))) & 0xFFu;
          // the group is a power of 2: masking keeps a stray byte inside it
          const unsigned off = (bits ? byte >> (s * bits) : byte) & (GROUP - 1);
#pragma unroll
          for (int o = 0; o < GROUP; ++o) {
            if (v != 0.f && off == static_cast<unsigned>(o)) val[gg * GROUP + o] = v;
          }
        }
      }
    }
    store_span(A, r, q, val);
  }
}

// The direct path (a group that does not divide the step evenly, or a
// layout that cannot be staged): one thread per (row, group touching the
// step at c0), reading the format in device memory; the group's columns
// are clipped to [c0, c0 + kBK), zeroed, and each kept value inside them
// stored at its offset.
template <bool TF32, typename VT>
__device__ __forceinline__ void rebuild_direct(typename Tile<TF32>::E* A, const VT* vals, const int8_t* offs,
                               int c0, int row0, int Mp, int Gp, int G, int group, int S,
                               int bits) {
  using T = Tile<TF32>;
  using E = typename T::E;
  const unsigned mask = (1u << bits) - 1u;
  const int g_first = c0 / group;
  const int ng = (c0 - g_first * group + kBK + group - 1) / group;
  const int64_t plane = static_cast<int64_t>(Mp) * Gp;
  for (int e = threadIdx.x; e < T::BM * ng; e += kThreadsNm) {
    const int r = e / ng, g = g_first + e % ng;
    const int gc = g * group - c0;  // the group's first column, relative to the step
    const int lo = max(gc, 0), hi = min(gc + group, kBK);
    for (int c = lo; c < hi; ++c) *a_elem(A, r, c) = from_float<E>(0.f);
    if (row0 + r >= Mp || g >= G) continue;
    const int64_t at = static_cast<int64_t>(row0 + r) * Gp + g;
    const unsigned packed = bits ? static_cast<uint8_t>(offs[at]) : 0u;
    for (int s = 0; s < S; ++s) {
      const float v = widen(vals[s * plane + at]);
      if (v == 0.f) continue;
      const int c = gc + static_cast<int>(bits ? (packed >> (s * bits)) & mask
                                               : static_cast<uint8_t>(offs[s * plane + at]));
      if (c >= lo && c < hi) *a_elem(A, r, c) = from_float<E>(v);
    }
  }
}

// cp.async of one part of the step's slots (values or offset bytes) into
// the slice: nslots x BM segments of `seg` bytes, segment (s, r) from
// src + s * plane + (row0 + r) * row + b0, in UNIT-byte copies (seg and the
// segment counts are powers of 2); a copy past the row's `row` bytes or in
// a row >= Mp is zero-filled.
template <int UNIT, bool TF32>
__device__ void stage_part(uint8_t* dst, const uint8_t* src, int64_t plane, int64_t row, int seg,
                           int nslots, int b0, int row0, int Mp) {
  constexpr int BM = Tile<TF32>::BM;
  constexpr int kLogBM = BM == 128 ? 7 : 6;
  const int nu = seg / UNIT, lnu = __ffs(nu) - 1;
  for (int e = threadIdx.x; e < nslots * BM * nu; e += kThreadsNm) {
    const int u = e & (nu - 1), r = (e >> lnu) & (BM - 1), s = e >> (lnu + kLogBM);
    const int b = b0 + u * UNIT;
    const bool valid = row0 + r < Mp && b < row;
    const uint8_t* p = src + s * plane + static_cast<int64_t>(row0 + r) * row + b;
    gather::cp_async<UNIT>(dst + static_cast<size_t>(e) * UNIT, valid ? p : src, valid);
  }
}

// The step's slots, groups [g0, g0 + GK), into a slice: values [S][BM][GK],
// offset bytes [So][BM][GK].  Gp % 16 == 0, so a 16-byte copy lies wholly
// inside a row or past it.
template <bool TF32, typename VT>
__device__ void stage_slots(uint8_t* slice, const VT* vals, const int8_t* offs, int g0, int GK,
                            int row0, int Mp, int Gp, int S, int So) {
  constexpr int BM = Tile<TF32>::BM;
  const int64_t plane = static_cast<int64_t>(Mp) * Gp;
  const int vseg = GK * static_cast<int>(sizeof(VT));
  const auto* vb = reinterpret_cast<const uint8_t*>(vals);
  const auto* ob = reinterpret_cast<const uint8_t*>(offs);
  uint8_t* od = slice + static_cast<size_t>(S) * BM * vseg;
  if (vseg >= 16) {
    stage_part<16, TF32>(slice, vb, plane * sizeof(VT), Gp * static_cast<int64_t>(sizeof(VT)),
                         vseg, S, g0 * static_cast<int>(sizeof(VT)), row0, Mp);
  } else {
    stage_part<4, TF32>(slice, vb, plane * sizeof(VT), Gp * static_cast<int64_t>(sizeof(VT)),
                        vseg, S, g0 * static_cast<int>(sizeof(VT)), row0, Mp);
  }
  if (GK >= 16) {
    stage_part<16, TF32>(od, ob, plane, Gp, GK, So, g0, row0, Mp);
  } else {
    stage_part<4, TF32>(od, ob, plane, Gp, GK, So, g0, row0, Mp);
  }
}

// cp.async of X rows [c0, c0 + kBK) (those < c_end), columns [n0, n0 + BN)
// (those < ldx) into an fp32 X stage [kBK][LDB]; the rest is zero-filled.
__device__ void stage_x(float* xs, const float* x, int c0, int c_end, int n0, int ldx) {
  using T = Tile<true>;
  constexpr int CPR = T::BN / 4;  // 16-byte copies a row
  for (int e = threadIdx.x; e < kBK * CPR; e += kThreadsNm) {
    const int r = e / CPR, c = (e % CPR) * 4;
    const bool valid = c0 + r < c_end && n0 + c < ldx;
    const float* src = valid ? x + static_cast<int64_t>(c0 + r) * ldx + n0 + c : x;
    gather::cp_async<16>(xs + r * T::LDB + c, src, valid);
  }
}

// cp.async of bf16 X rows [c0, c0 + kBK) (those < c_end), columns [n0, n0
// + BN) (those < ldx) into an X stage: BN / 64 blocks [kBK][64], row k of a
// block 128 bytes, its 16-byte chunk c at chunk c ^ (k % 8) (the 128-byte
// swizzle of an MN-major wgmma operand).
template <int BN>
__device__ void stage_xb(__nv_bfloat16* xs, const __nv_bfloat16* x, int c0, int c_end, int n0,
                         int ldx) {
  constexpr int CPR = BN / 8;  // 16-byte copies a row
  for (int e = threadIdx.x; e < kBK * CPR; e += kThreadsNm) {
    const int k = e / CPR, cc = e % CPR, c = cc % 8;
    const bool valid = c0 + k < c_end && n0 + cc * 8 < ldx;
    const __nv_bfloat16* src = valid ? x + static_cast<int64_t>(c0 + k) * ldx + n0 + cc * 8 : x;
    gather::cp_async<16>(xs + (cc / 8) * (kBK * 64) + k * 64 + (c ^ (k & 7)) * 8, src, valid);
  }
}

// Issues one step's products of warpgroup wg, acc += A[its 64 rows, 64] .
// X[64, BN]: four wgmma k16 steps from the A and X stages; returns without
// waiting for them.
template <int NJ>
__device__ __forceinline__ void issue_step(float (&acc)[NJ][4], const __nv_bfloat16* A,
                                           const __nv_bfloat16* xs, int wg) {
  tc::pin(acc);
  tc::wgmma_fence();
  const uint64_t da = tc::swizzle128_desc(A + wg * 64 * kBK, 16);
  const uint64_t db = tc::swizzle128_desc(xs, kBK * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    tc::wgmma_k16(acc, da + 2 * kk, db + 128 * kk);  // 16 columns of A: 32 bytes; 16 rows of X: 2 KB
  }
  tc::wgmma_commit();
  tc::pin(acc);
}

// One step's products of an fp32 warp tile by 3xTF32 (tensor_core.cuh).
__device__ __forceinline__ void step_tf32(float (&acc)[Tile<true>::MT][Tile<true>::NT][4],
                                          const float* A, const float* X, int wm, int wn,
                                          int lane) {
  using T = Tile<true>;
  tc::step_tf32<T::MT, T::NT, T::LDA, T::LDB, kBK>(acc, A, X, wm, wn, lane);
}

// The staged path's slice of one step: values then offset bytes, 16-byte multiple.
size_t slice_bytes(int bm, int S, int So, int GK, int vsize) {
  const size_t b = static_cast<size_t>(bm) * GK * (static_cast<size_t>(S) * vsize + So);
  return (b + 15) / 16 * 16;
}

// Groups a staged step takes, or 0 when the slots are read from device
// memory: the group is 2, 4, 8 or 16 (it divides a 16-column span, and a
// step into a multiple of 4 groups) and Gp is a multiple of 16 (and the
// planes are 16-byte aligned, checked at launch).
int staged_groups(int group, int Gp) {
  return (16 % group == 0 && Gp % 16 == 0) ? kBK / group : 0;
}

// Dynamic shared memory of a block: the X stages, the A stages and the
// staged slices (and 1 KB to align the swizzled bf16 X stages to 1024).
template <bool TF32, int BNB>
size_t smem_bytes(size_t slice) {
  using T = Tile<TF32, BNB>;
  return sizeof(typename T::E) *
             (static_cast<size_t>(T::XSTAGES) * T::XSTAGE + T::ASTAGES * T::BM * T::LDA) +
         kRawStages * slice + (TF32 ? 0 : 1024);
}

template <typename VT, bool TF32, int BNB>
__global__ void __launch_bounds__(kThreadsNm, 1)
nm_kernel(const VT* __restrict__ vals, const int8_t* __restrict__ offs,
          const typename Tile<TF32>::E* __restrict__ x, float* __restrict__ y, int S, int Mp,
          int Gp, int G, int group, int K, int ldx, int bits, int GK, int slice, int per_split,
          int atomic) {
  using T = Tile<TF32, BNB>;
  using E = typename T::E;
  uint8_t* base = reinterpret_cast<uint8_t*>(gather::gather_smem);
  if constexpr (!TF32) {
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(base));
    base += (1024u - at % 1024u) % 1024u;
  }
  E* xs = reinterpret_cast<E*>(base);                 // [T::XSTAGES][XSTAGE]
  E* as = xs + T::XSTAGES * T::XSTAGE;                  // [T::ASTAGES][BM][LDA]
  uint8_t* raw = reinterpret_cast<uint8_t*>(as + T::ASTAGES * T::BM * T::LDA);  // [3][slice]
  const int row0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int depth = G * group;
  const int n_steps = (depth + kBK - 1) / kBK;
  const int st0 = min(static_cast<int>(blockIdx.z) * per_split, n_steps);
  const int n = min(st0 + per_split, n_steps) - st0;  // steps of this block (0: y gets zeros)
  const int So = bits ? 1 : S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / T::WN, wn = warp % T::WN;

  // group Q_i: X of local step i, and the slots of step i + 1 when staged
  auto issue = [&](int i) {
    if (i < n) {
      const int c0 = (st0 + i) * kBK;
      if constexpr (TF32) {
        stage_x(xs + (i % T::XSTAGES) * T::XSTAGE, x, c0, min(c0 + kBK, depth), n0, ldx);
      } else {
        stage_xb<T::BN>(xs + (i % T::XSTAGES) * T::XSTAGE, x, c0, min(c0 + kBK, depth), n0, ldx);
      }
    }
    if (GK && i + 1 < n) {
      stage_slots<TF32>(raw + static_cast<size_t>((i + 1) % kRawStages) * slice, vals, offs,
                        (st0 + i + 1) * GK, GK, row0, Mp, Gp, S, So);
    }
  };
  auto rebuild = [&](int i) {  // A of local step i into its A stage
    E* a = as + (i % T::ASTAGES) * T::BM * T::LDA;
    const uint8_t* sl = raw + static_cast<size_t>(i % kRawStages) * slice;
    const int g0 = (st0 + i) * GK;
    if (GK == 32) {
      rebuild_staged<2, TF32, VT>(a, sl, GK, g0, row0, Mp, G, S, bits);
    } else if (GK == 16) {
      rebuild_staged<4, TF32, VT>(a, sl, GK, g0, row0, Mp, G, S, bits);
    } else if (GK == 8) {
      rebuild_staged<8, TF32, VT>(a, sl, GK, g0, row0, Mp, G, S, bits);
    } else if (GK == 4) {
      rebuild_staged<16, TF32, VT>(a, sl, GK, g0, row0, Mp, G, S, bits);
    } else {
      rebuild_direct<TF32, VT>(a, vals, offs, (st0 + i) * kBK, row0, Mp, Gp, G, group, S, bits);
    }
  };

  float acc[T::MT][T::NT][4] = {};
  if (n > 0) {
    if (GK) stage_slots<TF32>(raw, vals, offs, st0 * GK, GK, row0, Mp, Gp, S, So);
    gather::cp_async_commit();  // Q_-1: the slots of step 0
    issue(0);
    gather::cp_async_commit();
    issue(1);
    gather::cp_async_commit();
    gather::cp_async_wait<2>();
    __syncthreads();
    rebuild(0);
    for (int i = 0; i < n; ++i) {
      gather::cp_async_wait<1>();  // Q_i (X of step i, slots of step i + 1) has landed
      // this thread's copies and stores are seen by wgmma (the async proxy),
      // then by every thread; A of step i is written; step i - 2's stages are read
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      issue(i + 2);
      gather::cp_async_commit();
      const E* a = as + (i % T::ASTAGES) * T::BM * T::LDA;
      const E* xt = xs + (i % T::XSTAGES) * T::XSTAGE;
      if constexpr (TF32) {
        if (i + 1 < n) rebuild(i + 1);
        step_tf32(acc, a, xt, wm, wn, lane);
      } else {  // the tensor cores run step i (and finish i - 1) while the warps
                // rebuild the A tile of step i + 1
        issue_step(acc[0], a, xt, warp / 4);
        if (i + 1 < n) rebuild(i + 1);
        tc::wait_steps<1>(acc[0]);  // step i - 1 done: its stages are free at the next barrier
      }
    }
    if constexpr (!TF32) tc::wait_steps<0>(acc[0]);
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + wm * (T::MT * 16) + mt * 16 + g + (i / 2) * 8;
        const int col = n0 + wn * T::NT * 8 + nt * 8 + 2 * t + i % 2;
        if (row >= Mp || col >= K) continue;
        float* dst = y + static_cast<int64_t>(row) * K + col;
        if (atomic) {
          atomicAdd(dst, acc[mt][nt][i]);
        } else {
          *dst = acc[mt][nt][i];
        }
      }
    }
  }
}

template <typename VT, bool TF32, int BNB>
const void* kernel_of() {
  return reinterpret_cast<const void*>(nm_kernel<VT, TF32, BNB>);
}

template <typename VT, bool TF32, int BNB>
OptIn& optin_of() {  // one per instantiation
  static OptIn optin;
  return optin;
}

template <typename VT, bool TF32, int BNB>
int launch(const void* vals, const void* offs, const void* x, void* y, int S, int Mp, int Gp,
           int G, int group, int K, int ldx, int bits, int splits, cudaStream_t stream) {
  using T = Tile<TF32, BNB>;
  const bool aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(offs) % 16 == 0;
  const int GK = aligned ? staged_groups(group, Gp) : 0;
  const int So = bits ? 1 : S;
  int GKs = GK;
  size_t slice = GK ? slice_bytes(T::BM, S, So, GK, sizeof(VT)) : 0;
  size_t smem = smem_bytes<TF32, BNB>(slice);
  const size_t limit = static_cast<size_t>(gather::optin_shared_bytes());
  if (smem > limit && GKs) {  // the slices of many kept values do not fit: read them directly
    GKs = 0;
    slice = 0;
    smem = smem_bytes<TF32, BNB>(0);
  }
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = optin_of<VT, TF32, BNB>().ensure(kernel_of<VT, TF32, BNB>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_steps = (G * group + kBK - 1) / kBK;
  const int per = (n_steps + splits - 1) / splits;
  const dim3 grid((Mp + T::BM - 1) / T::BM, (K + T::BN - 1) / T::BN, splits);
  nm_kernel<VT, TF32, BNB><<<grid, kThreadsNm, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const int8_t*>(offs),
      static_cast<const typename T::E*>(x), static_cast<float*>(y), S, Mp, Gp, G, group, K, ldx,
      bits, GKs, static_cast<int>(slice), per, splits > 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int launch_vt(const void* vals, const void* offs, const void* x, void* y, int S, int Mp, int Gp,
              int G, int group, int K, int ldx, int bits, int bf16, int splits, int tile_n,
              cudaStream_t s) {
  if (!bf16) {
    return launch<VT, true, 128>(vals, offs, x, y, S, Mp, Gp, G, group, K, ldx, bits, splits, s);
  }
  return tile_n == 256
             ? launch<VT, false, 256>(vals, offs, x, y, S, Mp, Gp, G, group, K, ldx, bits,
                                      splits, s)
             : launch<VT, false, 128>(vals, offs, x, y, S, Mp, Gp, G, group, K, ldx, bits,
                                      splits, s);
}

}  // namespace

extern "C" {

// y [Mp, K] fp32: written whole when splits is 1, added into (zeroed by the
// caller) when the depth is split over `splits` blocks.  vals [S, Mp, Gp] of
// val_code 0 fp32, 1 bf16, 2 int8; offs int8 [1, Mp, Gp] bit-packed at
// `bits` bits a slot, or [S, Mp, Gp] when bits is 0.  x is X [G*group,
// ldx], 16-byte aligned, ldx >= K: bf16 with ldx a multiple of 8 when bf16
// is 1, else (the fp32 mode) fp32 with ldx a multiple of 4.  tile_n: the
// columns of a block's tile of y, 128 or 256 (bf16 only; fp32 takes 128).
// Returns the cudaError_t of the launch (0 on success).
int nm_spmm_launch(const void* vals, const void* offs, const void* x, void* y, int S, int Mp,
                   int Gp, int G, int group, int K, int ldx, int bits, int val_code, int bf16,
                   int splits, int tile_n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int vec = bf16 ? 8 : 4;
  if (group < 2 || group > 128 || S < 1 || S > group || bits < 0 || S * bits > 8 || K < 1 ||
      ldx < K || ldx % vec || splits < 1 || splits > 65535 || G < 0 || G > Gp ||
      (tile_n != 128 && (tile_n != 256 || !bf16)) || reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (val_code == 0) return launch_vt<float>(vals, offs, x, y, S, Mp, Gp, G, group, K, ldx, bits,
                                             bf16, splits, tile_n, s);
  if (val_code == 1) return launch_vt<__nv_bfloat16>(vals, offs, x, y, S, Mp, Gp, G, group, K,
                                                     ldx, bits, bf16, splits, tile_n, s);
  if (val_code == 2) return launch_vt<int8_t>(vals, offs, x, y, S, Mp, Gp, G, group, K, ldx,
                                              bits, bf16, splits, tile_n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What a launch of (val_code, bf16, tile_n) at (S, group, bits, Gp) would
// use, into out[0..5]: registers a thread, local (spill) bytes a thread,
// static shared bytes, dynamic shared bytes, groups a staged step takes (0:
// slots read from device memory) and blocks an SM holds.  Returns a
// cudaError_t.
int nm_spmm_info(int val_code, int bf16, int S, int group, int bits, int Gp, int tile_n,
                 int* out) {
  const int bn = bf16 ? tile_n : 128;
  const void* k = nullptr;
  OptIn* optin = nullptr;
  int vsize = 0;
#define NM_KERNEL(VT, CODE)                                                          \
  if (val_code == CODE) {                                                            \
    k = !bf16 ? kernel_of<VT, true, 128>()                                           \
              : bn == 256 ? kernel_of<VT, false, 256>() : kernel_of<VT, false, 128>(); \
    optin = !bf16 ? &optin_of<VT, true, 128>()                                       \
                  : bn == 256 ? &optin_of<VT, false, 256>() : &optin_of<VT, false, 128>(); \
    vsize = sizeof(VT);                                                              \
  }
  NM_KERNEL(float, 0)
  NM_KERNEL(__nv_bfloat16, 1)
  NM_KERNEL(int8_t, 2)
#undef NM_KERNEL
  if (k == nullptr || group < 2 || group > 128 || (bn != 128 && bn != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bm = bf16 ? Tile<false>::BM : Tile<true>::BM;
  auto smem_of = [&](size_t slice) {
    return !bf16 ? smem_bytes<true, 128>(slice)
                 : bn == 256 ? smem_bytes<false, 256>(slice) : smem_bytes<false, 128>(slice);
  };
  int GK = staged_groups(group, Gp);
  size_t smem = smem_of(GK ? slice_bytes(bm, S, bits ? 1 : S, GK, vsize) : 0);
  if (smem > static_cast<size_t>(gather::optin_shared_bytes())) {  // as the launch does
    GK = 0;
    smem = smem_of(0);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = optin->ensure(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreadsNm, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(smem);
  out[4] = GK;
  out[5] = blocks;
  return 0;
}

}  // extern "C"
