// Gather → distance for beam-search hops, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel hannoy_tpu/ops/beam_pallas.py:fused_gather_reduce
// (body _gather_reduce_kernel, wrapper gathered_distances_pallas) and folds
// the wrapper's epilogue in, so one launch gives final distances. The
// Pallas kernel takes f32 rows only; the JAX package computes the same
// function for its bf16, int8 and bit-packed rows in XLA
// (hannoy_tpu/ops/distances.py:gathered_distances). Here every row type
// goes through this file.
//
// For query b and column k it reads row idx[b,k] of the [N, D*] store and
// reduces it against q[b]. idx < 0 reads row 0 (the caller masks those
// entries, as in the JAX contract); idx >= N writes NaN, so a caller bug
// shows up instead of reading foreign memory.
//
// Row types and what the wrapper hands over (one query type per row type):
//   f32     rows float, q float: dot (cosine), squared L2, L1.
//   bf16    rows __nv_bfloat16, q float. Rows are upcast, sums are f32.
//           For cosine q is rounded to bf16 values as it is loaded (the
//           JAX package casts the query to the rows' type for the dot).
//   int8    rows int8, q float. Cosine casts the row (the stored rows have
//           length 127, which is their norm header, so the scale cancels);
//           euclidean / manhattan multiply each row by its own scale
//           norms[row] (scale_rows != 0); an int8 query was dequantised
//           by the wrapper.
//   packed  rows and q are 32-bit lanes; popc(q ^ r) summed over the
//           lanes, then hamming pc/d_pad, bq euclidean 4·pc, bq manhattan
//           2·pc, bq cosine (1 - (d_pad - 2·pc)/(qn·norm))/2, 0 where
//           qn·norm == 0; d_pad = 32·lanes.
//
// What bounds each form: memory, everywhere. A hop reads B*K randomly
// placed rows (403 MB of f32 rows at B=4096, K=32, D=768; a half of that
// in bf16, a quarter in int8, 12.6 MB packed) for at most 3 operations an
// element, far below the card's compute roofline. The design therefore
// only has to keep the row reads coalesced and never materialise the
// [B, K, D*] gather. f32, bf16 and int8 rows: one warp per (b, k) streams
// the row with 16-byte loads (4, 8 or 16 elements a lane) and the query
// beside it, reduces with warp shuffles, and lane 0 applies the epilogue.
// Packed rows are short (768 bits = 24 lanes = 96 bytes = six 16-byte
// loads), so a whole warp would leave most of its lanes idle: eight
// threads take one pair, four pairs to a warp, reduced over the eight by
// shuffles. At the search hop [256, 32] a packed launch moves under 1 MB:
// its bytes bound is far below the cost of a launch.
// Each row crosses device memory once per launch.
//
// Built by hannoy_tpu_torch/ops/beam_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; gather_distances() returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCosine = 0;
constexpr int kEuclidean = 1;
constexpr int kManhattan = 2;
constexpr int kHamming = 3;
constexpr int kBqCosine = 4;
constexpr int kBqEuclidean = 5;
constexpr int kBqManhattan = 6;

constexpr int kRowF32 = 0;
constexpr int kRowBf16 = 1;
constexpr int kRowInt8 = 2;
constexpr int kRowPacked = 3;

constexpr float kEps = 1.1920929e-07f;  // f32::EPSILON
constexpr int kWarpsPerBlock = 8;
constexpr int kPackedGroup = 8;  // threads per (b, k) pair of packed rows
constexpr int kPackedPairsPerBlock = kWarpsPerBlock * 32 / kPackedGroup;

template <int METRIC>
__device__ __forceinline__ float step(float acc, float q, float r) {
  if (METRIC == kCosine) return fmaf(q, r, acc);
  const float d = q - r;
  if (METRIC == kEuclidean) return fmaf(d, d, acc);
  return acc + fabsf(d);
}

// The query element as the metric reads it: cosine on bf16 rows rounds it
// to bf16 (round to nearest even, as a cast does); everything else as is.
template <bool ROUND>
__device__ __forceinline__ float query(float x) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// One row type's view of a row: ELEMS elements per 16-byte load.
template <typename ROW>
struct RowTraits;

template <>
struct RowTraits<float> {
  static constexpr int ELEMS = 4;
  static __device__ __forceinline__ float at(const float* r, int i) { return __ldg(r + i); }
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

template <>
struct RowTraits<__nv_bfloat16> {
  static constexpr int ELEMS = 8;
  static __device__ __forceinline__ float at(const __nv_bfloat16* r, int i) {
    // a bf16 is the upper half of the f32 of the same value
    return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const uint16_t*>(r) + i)) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <>
struct RowTraits<int8_t> {
  static constexpr int ELEMS = 16;
  static __device__ __forceinline__ float at(const int8_t* r, int i) {
    return static_cast<float>(__ldg(r + i));
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out[4 * j + b] = static_cast<float>(static_cast<int8_t>((w[j] >> (8 * b)) & 0xffu));
      }
    }
  }
};

// f32 / bf16 / int8 rows: one warp per (b, k).
template <typename ROW, int METRIC, bool VEC, bool SCALE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_distances_kernel(const ROW* __restrict__ vectors,
                        const float* __restrict__ norms,
                        const float* __restrict__ q,
                        const float* __restrict__ qn,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out,
                        int64_t n_rows, int dim, int64_t n_pairs, int k) {
  using T = RowTraits<ROW>;
  constexpr bool RQ = METRIC == kCosine && sizeof(ROW) == 2;
  const int lane = threadIdx.x & 31;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // whole warp leaves together
  const int64_t b = pair / k;
  int64_t row = idx[pair];
  if (row >= n_rows) {
    if (lane == 0) out[pair] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  if (row < 0) row = 0;
  const ROW* r = vectors + row * dim;
  const float* qq = q + b * dim;
  const float scale = SCALE ? __ldg(norms + row) : 1.f;

  float acc = 0.f;
  if (VEC) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    const float4* q4 = reinterpret_cast<const float4*>(qq);
    for (int i = lane; i < dim / T::ELEMS; i += 32) {
      float c[T::ELEMS];
      T::unpack(__ldg(r4 + i), c);
#pragma unroll
      for (int j = 0; j < T::ELEMS / 4; ++j) {
        float4 a = __ldg(q4 + i * (T::ELEMS / 4) + j);
        a.x = query<RQ>(a.x);
        a.y = query<RQ>(a.y);
        a.z = query<RQ>(a.z);
        a.w = query<RQ>(a.w);
        if (SCALE) {
          // __fmul_rn: the product is rounded before the subtraction, as in
          // the plain version (no contraction into an fma), so a row
          // against its own dequantised copy gives exactly 0
          acc = step<METRIC>(acc, a.x, __fmul_rn(c[4 * j], scale));
          acc = step<METRIC>(acc, a.y, __fmul_rn(c[4 * j + 1], scale));
          acc = step<METRIC>(acc, a.z, __fmul_rn(c[4 * j + 2], scale));
          acc = step<METRIC>(acc, a.w, __fmul_rn(c[4 * j + 3], scale));
        } else {
          acc = step<METRIC>(acc, a.x, c[4 * j]);
          acc = step<METRIC>(acc, a.y, c[4 * j + 1]);
          acc = step<METRIC>(acc, a.z, c[4 * j + 2]);
          acc = step<METRIC>(acc, a.w, c[4 * j + 3]);
        }
      }
    }
  } else {
    for (int i = lane; i < dim; i += 32) {
      const float c = T::at(r, i);
      acc = step<METRIC>(acc, query<RQ>(__ldg(qq + i)), SCALE ? __fmul_rn(c, scale) : c);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);

  if (lane == 0) {
    float res = acc;
    if (METRIC == kCosine) {
      const float denom = qn[b] * norms[row];
      const float cosv = fminf(fmaxf(acc / fmaxf(denom, kEps), -1.f), 1.f);
      res = denom > kEps ? (1.f - cosv) * 0.5f : 0.f;
    }
    out[pair] = res;
  }
}

// Packed rows: kPackedGroup threads per (b, k). Every thread of a warp
// stays to the end (no early return) so that the shuffles see full groups.
template <int METRIC, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_popcount_kernel(const uint32_t* __restrict__ vectors,
                       const float* __restrict__ norms,
                       const uint32_t* __restrict__ q,
                       const float* __restrict__ qn,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out,
                       int64_t n_rows, int lanes, int64_t n_pairs, int k) {
  const int t = threadIdx.x & (kPackedGroup - 1);
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kPackedPairsPerBlock + (threadIdx.x / kPackedGroup);
  const bool live = pair < n_pairs;
  int64_t row = live ? static_cast<int64_t>(idx[pair]) : 0;
  const bool in_range = row < n_rows;
  if (row < 0 || !in_range) row = 0;
  const int64_t b = live ? pair / k : 0;
  const uint32_t* r = vectors + row * lanes;
  const uint32_t* qq = q + b * lanes;

  int pc = 0;
  if (live && in_range) {
    if (VEC) {
      const uint4* r4 = reinterpret_cast<const uint4*>(r);
      const uint4* q4 = reinterpret_cast<const uint4*>(qq);
      for (int i = t; i < lanes / 4; i += kPackedGroup) {
        const uint4 a = __ldg(q4 + i);
        const uint4 c = __ldg(r4 + i);
        pc += __popc(a.x ^ c.x) + __popc(a.y ^ c.y) + __popc(a.z ^ c.z) + __popc(a.w ^ c.w);
      }
    } else {
      for (int i = t; i < lanes; i += kPackedGroup) pc += __popc(__ldg(qq + i) ^ __ldg(r + i));
    }
  }
#pragma unroll
  for (int off = kPackedGroup / 2; off > 0; off >>= 1) pc += __shfl_xor_sync(0xffffffffu, pc, off);

  if (live && t == 0) {
    const float pcf = static_cast<float>(pc);
    const float d_pad = static_cast<float>(lanes) * 32.f;
    float res;
    if (!in_range) {
      res = __int_as_float(0x7fc00000);  // NaN
    } else if (METRIC == kHamming) {
      res = pcf / d_pad;
    } else if (METRIC == kBqEuclidean) {
      res = 4.f * pcf;
    } else if (METRIC == kBqManhattan) {
      res = 2.f * pcf;
    } else {
      const float prod = qn[b] * norms[row];
      const float cosv = (d_pad - 2.f * pcf) / (prod != 0.f ? prod : 1.f);
      res = prod != 0.f ? (1.f - cosv) * 0.5f : 0.f;
    }
    out[pair] = res;
  }
}

struct Args {
  const void* vectors;
  const float* norms;
  const void* q;
  const float* qn;
  const int32_t* idx;
  float* out;
  int64_t n_rows;
  int dim;
  int64_t n_pairs;
  int k;
  bool vec;
  bool scale_rows;
  cudaStream_t stream;
};

template <typename ROW, int METRIC, bool SCALE>
void launch_scaled(const Args& a) {
  const int64_t blocks = (a.n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  const ROW* v = static_cast<const ROW*>(a.vectors);
  const float* q = static_cast<const float*>(a.q);
  if (a.vec) {
    gather_distances_kernel<ROW, METRIC, true, SCALE><<<grid, block, 0, a.stream>>>(
        v, a.norms, q, a.qn, a.idx, a.out, a.n_rows, a.dim, a.n_pairs, a.k);
  } else {
    gather_distances_kernel<ROW, METRIC, false, SCALE><<<grid, block, 0, a.stream>>>(
        v, a.norms, q, a.qn, a.idx, a.out, a.n_rows, a.dim, a.n_pairs, a.k);
  }
}

// Only int8 rows of euclidean / manhattan carry a scale; no other form
// pays for the choice.
template <typename ROW, int METRIC>
void launch(const Args& a) {
  if constexpr (sizeof(ROW) == 1 && METRIC != kCosine) {
    if (a.scale_rows) {
      launch_scaled<ROW, METRIC, true>(a);
      return;
    }
  }
  launch_scaled<ROW, METRIC, false>(a);
}

template <typename ROW>
bool launch_rows(const Args& a, int metric) {
  switch (metric) {
    case kCosine: launch<ROW, kCosine>(a); return true;
    case kEuclidean: launch<ROW, kEuclidean>(a); return true;
    case kManhattan: launch<ROW, kManhattan>(a); return true;
    default: return false;
  }
}

template <int METRIC>
void launch_packed(const Args& a) {
  const int64_t blocks = (a.n_pairs + kPackedPairsPerBlock - 1) / kPackedPairsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  const uint32_t* v = static_cast<const uint32_t*>(a.vectors);
  const uint32_t* q = static_cast<const uint32_t*>(a.q);
  if (a.vec) {
    gather_popcount_kernel<METRIC, true><<<grid, block, 0, a.stream>>>(
        v, a.norms, q, a.qn, a.idx, a.out, a.n_rows, a.dim, a.n_pairs, a.k);
  } else {
    gather_popcount_kernel<METRIC, false><<<grid, block, 0, a.stream>>>(
        v, a.norms, q, a.qn, a.idx, a.out, a.n_rows, a.dim, a.n_pairs, a.k);
  }
}

bool launch_packed_rows(const Args& a, int metric) {
  switch (metric) {
    case kHamming: launch_packed<kHamming>(a); return true;
    case kBqCosine: launch_packed<kBqCosine>(a); return true;
    case kBqEuclidean: launch_packed<kBqEuclidean>(a); return true;
    case kBqManhattan: launch_packed<kBqManhattan>(a); return true;
    default: return false;
  }
}

}  // namespace

// row_type: 0 f32, 1 bf16, 2 int8 (q is float for all three), 3 packed
// 32-bit lanes (q is lanes too). metric: 0 cosine, 1 euclidean,
// 2 manhattan for row types 0-2; 3 hamming, 4 bq cosine, 5 bq euclidean,
// 6 bq manhattan for row type 3. dim counts elements of a row (lanes when
// packed). vec != 0 requires a row to be a whole number of 16-byte loads
// and vectors and q to be 16-byte aligned. scale_rows != 0 multiplies
// each row by norms[row] (the int8 tier of euclidean / manhattan).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a row type or metric it does not know).
extern "C" int gather_distances(const void* vectors, const float* norms, const void* q,
                                const float* qn, const int32_t* idx, float* out,
                                long long n_rows, int dim, int batch, int k, int metric,
                                int row_type, int vec, int scale_rows, void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(batch) * k;
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  const Args a{vectors, norms, q, qn, idx, out, n_rows, dim, n_pairs, k,
               vec != 0, scale_rows != 0, static_cast<cudaStream_t>(stream)};
  bool known = false;
  switch (row_type) {
    case kRowF32: known = launch_rows<float>(a, metric); break;
    case kRowBf16: known = launch_rows<__nv_bfloat16>(a, metric); break;
    case kRowInt8: known = launch_rows<int8_t>(a, metric); break;
    case kRowPacked: known = launch_packed_rows(a, metric); break;
    default: break;
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
