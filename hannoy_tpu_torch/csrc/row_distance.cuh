// One row's distance to a query, as every kernel of the port computes it:
// gather_distances.cu's staged and packed designs, and search.cu's beam
// search and greedy descent; and the asynchronous copies that stage rows in
// shared memory for both sources. Each dense form calls row_partial and
// warp_sum below, each packed form popc_xor and packed_distance, so a
// distance has the same bits whichever kernel computed it, and the search
// kernels can be held to exact equality with the host loop that calls the
// gather kernel hop by hop.
//
// What a row's distance is. Lane l of a warp takes the row's units l,
// l + 32, ... in order (16 bytes of f32 or bf16 rows, 8 bytes of int8
// rows), each as groups of four elements against the query's matching
// float4s, into four partial sums, one for each element of a group; the
// lane's part is (acc0 + acc1) + (acc2 + acc3); the warp adds the lanes'
// parts by a butterfly of xor shuffles (16, 8, 4, 2, 1). Cosine then takes
// cosine_distance(dot, qn * norm).
//
// The query is f32 in shared memory, as the metric reads it: for cosine on
// bf16 rows each element is first rounded to bf16 (query<true>). int8 rows
// of euclidean / manhattan are scaled by their own scale with __fmul_rn, so
// that the product is rounded before the subtraction (no contraction into
// an fma) and a row against its own dequantised copy gives exactly 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace rowdist {

constexpr int kCosine = 0;
constexpr int kEuclidean = 1;
constexpr int kManhattan = 2;
constexpr int kHamming = 3;
constexpr int kBqCosine = 4;
constexpr int kBqEuclidean = 5;
constexpr int kBqManhattan = 6;

constexpr float kEps = 1.1920929e-07f;  // f32::EPSILON

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

// The cosine epilogue: the distance from a dot product and qn * norm. The
// clamp to [-1, 1] keeps a NaN, as jnp.clip and torch.clamp do (fminf and
// fmaxf would drop it): a row that holds NaN, with a finite norm, is at
// distance NaN. A NaN or tiny denom still gives 0.
__device__ __forceinline__ float cosine_distance(float dot, float denom) {
  const float c = dot / fmaxf(denom, kEps);
  const float cosv = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);
  return denom > kEps ? (1.f - cosv) * 0.5f : 0.f;
}

// The 32-bit word i (0-3) of a 16-byte load.
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One row type's view of a row: ELEMS elements per 16-byte load. A row is
// read in Units of UNIT_ELEMS elements (8 bytes of int8 rows, so that a
// 768-wide row is 96 of them, three for each lane of a warp); group(u, g,
// out) gives elements 4g .. 4g+3 of a unit.
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
  using Unit = uint4;
  static constexpr int UNIT_ELEMS = 4;
  static __device__ __forceinline__ void group(const uint4& v, int, float* out) { unpack(v, out); }
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
  using Unit = uint4;
  static constexpr int UNIT_ELEMS = 8;
  static __device__ __forceinline__ void group(const uint4& v, int g, float* out) {
    const uint32_t lo = word(v, 2 * g), hi = word(v, 2 * g + 1);
    out[0] = __uint_as_float(lo << 16);
    out[1] = __uint_as_float(lo & 0xffff0000u);
    out[2] = __uint_as_float(hi << 16);
    out[3] = __uint_as_float(hi & 0xffff0000u);
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
  // The int → float conversion runs at a quarter of the f32 rate, so only
  // group 0 takes it; group 1 goes by the integer and f32 pipes, which
  // work beside it: byte v ^ 0x80 = v + 128 becomes the low byte of the
  // float 2^23 + v + 128, and subtracting 2^23 + 128 leaves v, exactly.
  using Unit = uint2;
  static constexpr int UNIT_ELEMS = 8;
  static __device__ __forceinline__ void group(const uint2& v, int g, float* out) {
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = static_cast<float>(static_cast<int8_t>((v.x >> (8 * e)) & 0xffu));
    } else {
      const uint32_t biased = v.y ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = __uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7650u + e)) - 8388736.f;
    }
  }
};

// A unit with its two halves swapped when `swap` (groups 0 and 1 of an
// 8-element unit).
__device__ __forceinline__ uint4 swap_halves(uint4 v, bool swap) {
  return swap ? make_uint4(v.z, v.w, v.x, v.y) : v;
}
__device__ __forceinline__ uint2 swap_halves(uint2 v, bool swap) { return swap ? make_uint2(v.y, v.x) : v; }

// Lane `lane`'s part of the reduction of one row (`units` Units at `ru`)
// against the f32 query `q4` in shared memory: its units lane, lane + 32,
// ... in order, four partial sums, then (acc0 + acc1) + (acc2 + acc3).
// A lane of a unit of two groups (bf16, int8) starts at group `swap`, so
// that the 8 lanes of a quarter-warp hit 8 different 16-byte bank groups
// of the query; the order of its additions is part of the result.
// `scale`: the row's own scale (SCALE: int8 rows of euclidean /
// manhattan). GLOBAL: `ru` lies in device memory (read through the
// read-only path), else in shared memory. BATCH: units a lane loads before
// it adds the first of them (more rows' bytes in flight from device
// memory); it changes no arithmetic.
template <typename ROW, int METRIC, bool SCALE, int BATCH, bool GLOBAL>
__device__ __forceinline__ float row_partial(const typename RowTraits<ROW>::Unit* ru, const float4* q4, int units,
                                             int lane, float scale) {
  using T = RowTraits<ROW>;
  using Unit = typename T::Unit;
  constexpr int GROUPS = T::UNIT_ELEMS / 4;  // float4s of query per unit of row
  const bool swap = GROUPS == 2 && ((lane >> 2) & 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = lane; i0 < units; i0 += 32 * BATCH) {
    Unit u[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + 32 * j;
      if (i < units) {
        if constexpr (GLOBAL) {
          u[j] = __ldg(ru + i);
        } else {
          u[j] = ru[i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + 32 * j;
      if (i >= units) break;
      const Unit v = swap_halves(u[j], swap);
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const float4 a = q4[i * GROUPS + (g ^ static_cast<int>(swap))];
        float c[4];
        T::group(v, g, c);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // __fmul_rn: the product is rounded before the subtraction
          acc[e] = step<METRIC>(acc[e], av[e], SCALE ? __fmul_rn(c[e], scale) : c[e]);
        }
      }
    }
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The warp's sum of R rows' parts, each by the same butterfly of xor
// shuffles (16, 8, 4, 2, 1); every lane ends with the sums.
template <int R>
__device__ __forceinline__ void warp_sum(float (&part)[R]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
  }
}

// ---- packed rows: 32-bit lanes of sign bits ----
//
// A packed row's distance is an integer popcount of the query's lanes xor
// the row's, summed in any order, then one epilogue: gather_distances.cu's
// pair and group designs and search.cu's packed form both end in
// packed_distance, so their distances have the same bits.

// The packed epilogue: the distance from the popcount pc of a row of
// `lanes` 32-bit lanes; `prod` = qn * norm (read by BQ cosine only).
template <int METRIC>
__device__ __forceinline__ float packed_distance(int pc, int lanes, float prod) {
  const float pcf = static_cast<float>(pc);
  const float d_pad = static_cast<float>(lanes) * 32.f;
  if (METRIC == kHamming) return pcf / d_pad;
  if (METRIC == kBqEuclidean) return 4.f * pcf;
  if (METRIC == kBqManhattan) return 2.f * pcf;
  const float cosv = (d_pad - 2.f * pcf) / (prod != 0.f ? prod : 1.f);
  return prod != 0.f ? (1.f - cosv) * 0.5f : 0.f;
}

__device__ __forceinline__ int popc_xor(const uint4& a, const uint4& c) {
  return __popc(a.x ^ c.x) + __popc(a.y ^ c.y) + __popc(a.z ^ c.z) + __popc(a.w ^ c.w);
}

// ---- asynchronous copies into shared memory (the staged designs) ----

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(bar)) : "memory");
}

// Arrive once and expect `bytes` of transactions, then copy `bytes` from
// device memory to shared memory; the copy's completion counts them down.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// A block's barrier serves one phase (each block stages one query): wait
// for phase 0 to complete.
__device__ __forceinline__ void barrier_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar))
        : "memory");
  }
}

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// 16-byte asynchronous copy from device to shared memory, through L2 only.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)), "l"(src) : "memory");
}

// Lets `kernel` take the card's whole opt-in shared memory a block (above
// the 48 KB default) on the current device. cudaFuncSetAttribute applies
// to the current device only, so `done` keeps one bit per device id for
// which it was set; every call sets the same value, so threads that race
// here agree. Devices past id 63 set it on every call.
template <typename KERNEL>
cudaError_t allow_opt_in_shared(KERNEL kernel, std::atomic<uint64_t>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int opt_in = 0;
  err = cudaDeviceGetAttribute(&opt_in, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             opt_in - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace rowdist
