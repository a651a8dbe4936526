// Gather → distance for beam-search hops, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel hannoy_tpu/ops/beam_pallas.py:fused_gather_reduce
// (body _gather_reduce_kernel, wrapper gathered_distances_pallas) and folds
// the wrapper's cosine epilogue in, so one launch gives final distances.
//
// For query b and column k it reads row idx[b,k] of the [N, D] f32 store
// and reduces it against q[b]: dot product (cosine), squared L2
// (euclidean) or L1 (manhattan). idx < 0 reads row 0 (the caller masks
// those entries, as in the JAX contract); idx >= N writes NaN, so a caller
// bug shows up instead of reading foreign memory.
//
// What bounds it: memory. Each hop reads B*K*D*4 bytes of randomly placed
// rows (403 MB at B=4096, K=32, D=768) for 2 flops a byte, far below the
// card's compute roofline. The design therefore only has to keep the row
// reads coalesced and never materialise the [B, K, D] gather: one warp per
// (b, k) streams the row and the query with 16-byte loads (D % 4 == 0),
// reduces with warp shuffles, and lane 0 applies the epilogue. Each row
// crosses device memory once.
//
// Built by hannoy_tpu_torch/ops/beam_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; gather_distances() returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCosine = 0;
constexpr int kEuclidean = 1;
constexpr int kManhattan = 2;
constexpr float kEps = 1.1920929e-07f;  // f32::EPSILON
constexpr int kWarpsPerBlock = 8;

template <int METRIC>
__device__ __forceinline__ float step(float acc, float q, float r) {
  if (METRIC == kCosine) return fmaf(q, r, acc);
  const float d = q - r;
  if (METRIC == kEuclidean) return fmaf(d, d, acc);
  return acc + fabsf(d);
}

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_distances_kernel(const float* __restrict__ vectors,
                        const float* __restrict__ norms,
                        const float* __restrict__ q,
                        const float* __restrict__ qn,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out,
                        int64_t n_rows, int dim, int64_t n_pairs, int k) {
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
  const float* r = vectors + row * dim;
  const float* qq = q + b * dim;

  float acc = 0.f;
  if (VEC4) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const float4* q4 = reinterpret_cast<const float4*>(qq);
    for (int i = lane; i < dim / 4; i += 32) {
      const float4 a = __ldg(q4 + i);
      const float4 c = __ldg(r4 + i);
      acc = step<METRIC>(acc, a.x, c.x);
      acc = step<METRIC>(acc, a.y, c.y);
      acc = step<METRIC>(acc, a.z, c.z);
      acc = step<METRIC>(acc, a.w, c.w);
    }
  } else {
    for (int i = lane; i < dim; i += 32) acc = step<METRIC>(acc, __ldg(qq + i), __ldg(r + i));
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

template <int METRIC>
void launch(const float* vectors, const float* norms, const float* q, const float* qn,
            const int32_t* idx, float* out, int64_t n_rows, int dim, int64_t n_pairs, int k,
            bool vec4, cudaStream_t stream) {
  const int64_t blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  if (vec4) {
    gather_distances_kernel<METRIC, true><<<grid, block, 0, stream>>>(
        vectors, norms, q, qn, idx, out, n_rows, dim, n_pairs, k);
  } else {
    gather_distances_kernel<METRIC, false><<<grid, block, 0, stream>>>(
        vectors, norms, q, qn, idx, out, n_rows, dim, n_pairs, k);
  }
}

}  // namespace

// metric: 0 cosine, 1 euclidean, 2 manhattan. vec4 != 0 requires dim % 4 == 0
// and 16-byte aligned vectors and q. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a metric id it does not know).
extern "C" int gather_distances(const float* vectors, const float* norms, const float* q,
                                const float* qn, const int32_t* idx, float* out,
                                long long n_rows, int dim, int batch, int k, int metric,
                                int vec4, void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(batch) * k;
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kCosine:
      launch<kCosine>(vectors, norms, q, qn, idx, out, n_rows, dim, n_pairs, k, vec4 != 0, s);
      break;
    case kEuclidean:
      launch<kEuclidean>(vectors, norms, q, qn, idx, out, n_rows, dim, n_pairs, k, vec4 != 0, s);
      break;
    case kManhattan:
      launch<kManhattan>(vectors, norms, q, qn, idx, out, n_rows, dim, n_pairs, k, vec4 != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
