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
// shows up instead of reading foreign memory (the plain twin does the
// same; the JAX package's XLA gather would clamp to row N-1).
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
// What bounds each form on the H100. f32, bf16 and int8 rows: device
// memory. A hop reads B*K randomly placed rows (403 MB of f32 rows at
// B=4096, K=32, D=768; a half of that in bf16, a quarter in int8) for at
// most 3 operations an element, two orders of magnitude below the 295
// operations a byte where the card stops being memory-bound; so a form is
// as fast as it keeps rows in flight from HBM. Packed rows are 96 bytes
// (768 bits): a store of the main path's 100k items is 9.6 MB and sits
// whole in the 50 MB L2, so there the latency of a pair's chain of
// dependent memory trips (its index, then its row) and the L2's request
// rate bound the form, not HBM bytes; only a store past L2 (about 520k
// items of 768 bits and more) is bound by its bytes over HBM, read at
// random. A hop of B*K packed pairs moves 12.6 MB at [4096, 32] and under
// 1 MB at the search hop [256, 32], where the launch itself is most of
// the time.
//
// Two designs for f32, bf16 and int8 rows; ops/beam_cuda.py:design_of
// picks one per launch and passes it in:
//   staged  (rows that are whole 16-byte units from 16-byte aligned bases,
//           with a tile that fits in shared memory: every launch of the
//           main path): one block per query and tile of up to kTile
//           candidates, one warp per kRowsPerWarp of them. The query, in
//           its f32 form, is copied once per block by one bulk
//           asynchronous copy (cp.async.bulk, completing on an mbarrier).
//           Each warp loads its rows' indices and, with all of its lanes,
//           pulls its rows into shared memory by 16-byte asynchronous
//           copies (cp.async, one commit group a row) and loads their
//           headers; then it waits for the query and reduces each row
//           against the staged query as soon as the row's group has
//           landed, four independent sums a lane, so that the rows still
//           in flight hide the reduction. Half of the int8 codes become
//           floats without the quarter-rate conversion, so that both kinds
//           of pipe work at once. The reduction of a row is
//           row_distance.cuh's row_partial and warp_sum, which search.cu's
//           kernels call too, so their distances have these bits. This is
//           the TPU kernel's structure
//           (start the copies of all of a block's rows, then wait and
//           reduce) in Hopper's terms: a tile's rows are all in flight at
//           once without holding registers, a pair's chain is two trips
//           (index; then row, header and query together), and the query
//           crosses device memory once per block. Rows are not bulk copies:
//           at these sizes the SM's copy unit takes bulk copies one after
//           another and becomes the limit (PERF.md §6 has the measurement).
//   warp    (rows of other widths or bases): one warp per (b, k) streams
//           the row with 16-byte loads (4, 8 or 16 elements a lane; single
//           elements where rows are not whole 16-byte units) and the query
//           beside it, reduces with warp shuffles, and lane 0 applies the
//           epilogue.
// Two designs for packed rows:
//   pair    (rows that are whole 16-byte units from 16-byte aligned bases:
//           every packed launch of the main path): two threads a (b, k)
//           pair, each holding half of the row's units in registers, so
//           that every lane loads, one instruction of a pair reads a whole
//           32-byte sector, and a thread has three 16-byte loads in flight
//           (768 bits). Two trips a pair: the index, issued first, with the
//           query's units and qn in flight beside it (they do not depend on
//           it); then the row's units and, under BQ cosine, its norm, all
//           at once. One shuffle a pair. Blocks shrink to one warp at small
//           B*K so that [128, 32] and [256, 32] spread over the SMs. The
//           query is read per pair through L1, off the chain, not staged
//           in shared memory: a staged query (by cp.async or by plain
//           loads) adds a wait and a barrier to every launch that cost
//           more than the re-reads. One thread a pair (two 16-byte
//           requests for each 32-byte sector), four threads a pair, and
//           rows pulled in by warp-issued cp.async (the staged design's
//           pattern) were all slower on the main path's shapes (PERF.md
//           §6 has the measurements).
//   group   (rows of other widths or bases): eight threads a pair, lane by
//           lane, reduced over the eight by shuffles.
//
// Built by hannoy_tpu_torch/ops/beam_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (keyed by a hash of this file and the csrc/*.cuh headers) and called
// through ctypes; gather_distances() returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "row_distance.cuh"

namespace {

using namespace rowdist;

constexpr int kRowF32 = 0;
constexpr int kRowBf16 = 1;
constexpr int kRowInt8 = 2;
constexpr int kRowPacked = 3;

constexpr int kDesignWarp = 0;
constexpr int kDesignStaged = 1;
constexpr int kDesignGroup = 2;
constexpr int kDesignPair = 3;

constexpr int kWarpsPerBlock = 8;
constexpr int kPackedGroup = 8;  // threads per (b, k) pair of packed rows
constexpr int kPackedPairsPerBlock = kWarpsPerBlock * 32 / kPackedGroup;
constexpr int kTile = 32;  // candidates per block of the staged design: every K the main path launches (8, 16, 32)
constexpr int kRowsPerWarp = kTile / kWarpsPerBlock;  // staged design: rows a warp stages and reduces
static_assert(kRowsPerWarp <= 4, "the staged kernel waits on at most 4 copy groups a warp");
constexpr int kPairThreads = 2;  // pair design: threads a (b, k) pair
constexpr int kPairUnits = 4;  // pair design: 16-byte units of a row a thread holds at once
constexpr int kPairBlock = 256;  // pair design: the most threads a block takes
constexpr int kSms = 132;  // the H100's SMs: a pair launch spreads over at least this many blocks where it can

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

  if (lane == 0) out[pair] = METRIC == kCosine ? cosine_distance(acc, qn[b] * norms[row]) : acc;
}

// ---- the staged design (its copies: row_distance.cuh) ----

// One block per (query b, tile of up to kTile candidates), one warp per
// kRowsPerWarp candidates of the tile. Dynamic shared memory: the query
// (dim f32, a multiple of 16 bytes) and then the tile's rows, each
// dim * sizeof(ROW) bytes, a multiple of 16. The query arrives by one bulk
// copy on an mbarrier; a warp loads its rows' indices and pulls its rows
// in with 16-byte copies from all of its lanes, one copy group a row (one
// bulk copy a row would leave the block's 33 copies queued one behind
// another in the SM's copy unit). Every warp waits for the query, so no
// copy is in flight when the block leaves, then reduces each of its rows
// as soon as that row's group has landed, with four independent sums a
// lane; the warps' shuffles run once, for all of their rows together.
template <typename ROW, int METRIC, bool SCALE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_staged_kernel(const ROW* __restrict__ vectors,
                     const float* __restrict__ norms,
                     const float* __restrict__ q,
                     const float* __restrict__ qn,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ out,
                     int64_t n_rows, int dim, int k, int tiles) {
  using T = RowTraits<ROW>;
  using Unit = typename T::Unit;
  constexpr bool RQ = METRIC == kCosine && sizeof(ROW) == 2;
  constexpr bool HEADER = METRIC == kCosine || SCALE;
  constexpr int R = kRowsPerWarp;
  extern __shared__ __align__(128) unsigned char staged[];
  __shared__ uint64_t q_bar;

  const int64_t b = blockIdx.x / tiles;
  const int first = static_cast<int>(blockIdx.x - b * tiles) * kTile;
  const int count = min(kTile, k - first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t q_bytes = static_cast<uint32_t>(dim) * 4u;
  const uint32_t row_bytes = static_cast<uint32_t>(dim) * sizeof(ROW);
  float* sq = reinterpret_cast<float*>(staged);

  if (threadIdx.x == 0) {
    barrier_init(&q_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) bulk_copy(sq, q + b * dim, q_bytes, &q_bar);

  // this warp's rows: base .. base + mine - 1 of the tile; lane j < mine
  // holds row j's index (-1: past the store) and header
  const int base = warp * R;
  const int mine = min(R, count - base);
  int64_t row = -1;
  if (lane < mine) {
    row = __ldg(idx + b * k + first + base + lane);
    if (row >= n_rows) row = -1;
    else if (row < 0) row = 0;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t rj = __shfl_sync(0xffffffffu, row, j);
    if (j < mine && rj >= 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(vectors + rj * dim);
      unsigned char* dst = staged + q_bytes + (base + j) * row_bytes;
      for (uint32_t c = 16 * lane; c < row_bytes; c += 16 * 32) copy16(dst + c, src + c);
    }
    copies_commit();  // one group a row, empty or not
  }
  const float head = HEADER && row >= 0 ? __ldg(norms + row) : 1.f;
  const float q_norm = METRIC == kCosine ? __ldg(qn + b) : 0.f;

  barrier_wait(&q_bar);
  if (RQ) {
    // the query as the metric reads it, rounded once for the whole tile
    for (int i = threadIdx.x; i < dim; i += blockDim.x) sq[i] = query<true>(sq[i]);
    __syncthreads();
  }
  if (mine <= 0) return;

  const float4* q4 = reinterpret_cast<const float4*>(sq);
  const int units = static_cast<int>(row_bytes / sizeof(Unit));
  float part[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    part[j] = 0.f;
    if (j >= mine) continue;
    switch (R - 1 - j) {  // row j's group has landed once R - 1 - j are left
      case 3: copies_wait<3>(); break;
      case 2: copies_wait<2>(); break;
      case 1: copies_wait<1>(); break;
      default: copies_wait<0>(); break;
    }
    __syncwarp();
    // a row past the store is read all the same (its result is NaN)
    const Unit* ru = reinterpret_cast<const Unit*>(staged + q_bytes + (base + j) * row_bytes);
    const float scale = SCALE ? __shfl_sync(0xffffffffu, head, j) : 1.f;
    part[j] = row_partial<ROW, METRIC, SCALE, 1, false>(ru, q4, units, lane, scale);
  }
  warp_sum(part);  // the rows' shuffles run once, for all of them together
  // lane j < mine writes row j
  float res = part[0];
#pragma unroll
  for (int j = 1; j < R; ++j) res = lane == j ? part[j] : res;
  if (lane < mine) {
    if (row < 0) res = __int_as_float(0x7fc00000);  // NaN past the store
    else if (METRIC == kCosine) res = cosine_distance(res, q_norm * head);
    out[b * k + first + base + lane] = res;
  }
}

// Packed rows that are whole 16-byte units from aligned bases (768 bits:
// six units), kPairThreads threads a (b, k) pair: a block takes
// blockDim.x / kPairThreads consecutive pairs, and thread h of a pair takes
// units h, h + 2, ... of its row, so that one instruction of the pair's two
// threads reads one whole 32-byte sector. Trip 1: the pair's index, issued
// first; the query's units (and qn) do not wait for it and are in flight
// beside it. Trip 2: the row's units, up to kPairUnits a thread at once in
// registers, and under BQ cosine the row's norm, all issued together. One
// shuffle adds the two halves.
template <int METRIC>
__global__ void __launch_bounds__(kPairBlock)
gather_popcount_pair_kernel(const uint4* __restrict__ vectors,
                            const float* __restrict__ norms,
                            const uint4* __restrict__ q,
                            const float* __restrict__ qn,
                            const int32_t* __restrict__ idx,
                            float* __restrict__ out,
                            int64_t n_rows, int units, int64_t n_pairs, int k) {
  constexpr int G = kPairThreads, H = kPairUnits;
  const int h = threadIdx.x % G;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G) + threadIdx.x / G;
  const bool live = pair < n_pairs;
  int64_t row = live ? static_cast<int64_t>(__ldg(idx + pair)) : 0;
  const int64_t b = live ? pair / k : 0;
  const uint4* qq = q + b * units + h;
  uint4 a[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (h + G * j < units) a[j] = __ldg(qq + G * j);
  }
  const float q_norm = METRIC == kBqCosine ? __ldg(qn + b) : 0.f;

  const bool in_range = row < n_rows;
  if (row < 0 || !in_range) row = 0;
  const uint4* r = vectors + row * units + h;
  const float norm = METRIC == kBqCosine ? __ldg(norms + row) : 0.f;
  uint4 c[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (h + G * j < units) c[j] = __ldg(r + G * j);
  }
  int pc = 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (h + G * j < units) pc += popc_xor(a[j], c[j]);
  }
  for (int base = G * H; base < units; base += G * H) {  // rows wider than G * H units
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (base + h + G * j < units) pc += popc_xor(__ldg(qq + base + G * j), __ldg(r + base + G * j));
    }
  }
  pc += __shfl_xor_sync(0xffffffffu, pc, 1);
  if (live && h == 0) {
    out[pair] = in_range ? packed_distance<METRIC>(pc, units * 4, q_norm * norm) : __int_as_float(0x7fc00000);  // NaN
  }
}

// The group design: packed rows of other widths or bases, kPackedGroup
// threads per (b, k), lane by lane. Every thread of a warp stays to the end
// (no early return) so that the shuffles see full groups.
template <int METRIC>
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
    for (int i = t; i < lanes; i += kPackedGroup) pc += __popc(__ldg(qq + i) ^ __ldg(r + i));
  }
#pragma unroll
  for (int off = kPackedGroup / 2; off > 0; off >>= 1) pc += __shfl_xor_sync(0xffffffffu, pc, off);

  if (live && t == 0) {
    out[pair] = in_range ? packed_distance<METRIC>(pc, lanes, METRIC == kBqCosine ? qn[b] * norms[row] : 0.f)
                         : __int_as_float(0x7fc00000);  // NaN
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
  int64_t batch;
  int k;
  int64_t n_pairs;
  bool vec;
  bool scale_rows;
  int design;
  cudaStream_t stream;
};

template <typename ROW, int METRIC, bool SCALE>
cudaError_t launch_warp(const Args& a) {
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
  return cudaSuccess;
}

// The staged design needs whole 16-byte rows from aligned bases (vec).
// Its shared memory grows with dim: above 48 KB the kernel has to be
// allowed more first, and a size the card refuses comes back as that
// call's error (ops/beam_cuda.py:design_of keeps launches inside it).
template <typename ROW, int METRIC, bool SCALE>
cudaError_t launch_staged(const Args& a) {
  if (!a.vec) return cudaErrorInvalidValue;
  const auto kernel = gather_staged_kernel<ROW, METRIC, SCALE>;
  const int tiles = (a.k + kTile - 1) / kTile;
  const int64_t blocks = a.batch * tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int rows = a.k < kTile ? a.k : kTile;
  const size_t smem = static_cast<size_t>(a.dim) * (4 + static_cast<size_t>(rows) * sizeof(ROW));
  static std::atomic<uint64_t> allowed_on{0};  // one per kernel: devices on which it may take more
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_opt_in_shared(kernel, allowed_on);
    if (err != cudaSuccess) return err;
  }
  // one warp per kRowsPerWarp rows of a tile: K = 8 takes 2 warps a
  // block, so that more blocks, and more rows, are in flight on an SM
  const int warps = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, a.stream>>>(
      static_cast<const ROW*>(a.vectors), a.norms, static_cast<const float*>(a.q), a.qn, a.idx, a.out, a.n_rows,
      a.dim, a.k, tiles);
  return cudaSuccess;
}

template <typename ROW, int METRIC, bool SCALE>
cudaError_t launch_design(const Args& a) {
  switch (a.design) {
    case kDesignWarp: return launch_warp<ROW, METRIC, SCALE>(a);
    case kDesignStaged: return launch_staged<ROW, METRIC, SCALE>(a);
    default: return cudaErrorInvalidValue;
  }
}

// Only int8 rows of euclidean / manhattan carry a scale; no other form
// pays for the choice.
template <typename ROW, int METRIC>
cudaError_t launch(const Args& a) {
  if constexpr (sizeof(ROW) == 1 && METRIC != kCosine) {
    if (a.scale_rows) return launch_design<ROW, METRIC, true>(a);
  }
  return launch_design<ROW, METRIC, false>(a);
}

template <typename ROW>
cudaError_t launch_rows(const Args& a, int metric) {
  switch (metric) {
    case kCosine: return launch<ROW, kCosine>(a);
    case kEuclidean: return launch<ROW, kEuclidean>(a);
    case kManhattan: return launch<ROW, kManhattan>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int METRIC>
cudaError_t launch_group(const Args& a) {
  const int64_t blocks = (a.n_pairs + kPackedPairsPerBlock - 1) / kPackedPairsPerBlock;
  gather_popcount_kernel<METRIC><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const uint32_t*>(a.vectors), a.norms, static_cast<const uint32_t*>(a.q), a.qn, a.idx, a.out,
      a.n_rows, a.dim, a.n_pairs, a.k);
  return cudaSuccess;
}

// The pair design needs whole 16-byte units from aligned bases (vec). A
// block has kPairBlock threads, halved (down to one warp) while the launch
// would have fewer than kSms blocks: the search hop [256, 32] and the
// descent's [128, 32] then spread over every SM.
template <int METRIC>
cudaError_t launch_pair(const Args& a) {
  if (!a.vec || a.dim % 4 != 0) return cudaErrorInvalidValue;
  int threads = kPairBlock;
  while (threads > 32 && (a.n_pairs + threads / kPairThreads - 1) / (threads / kPairThreads) < kSms) threads >>= 1;
  const int64_t blocks = (a.n_pairs + threads / kPairThreads - 1) / (threads / kPairThreads);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gather_popcount_pair_kernel<METRIC><<<static_cast<unsigned>(blocks), threads, 0, a.stream>>>(
      static_cast<const uint4*>(a.vectors), a.norms, static_cast<const uint4*>(a.q), a.qn, a.idx, a.out, a.n_rows,
      a.dim / 4, a.n_pairs, a.k);
  return cudaSuccess;
}

template <int METRIC>
cudaError_t launch_packed_design(const Args& a) {
  switch (a.design) {
    case kDesignGroup: return launch_group<METRIC>(a);
    case kDesignPair: return launch_pair<METRIC>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_packed_rows(const Args& a, int metric) {
  switch (metric) {
    case kHamming: return launch_packed_design<kHamming>(a);
    case kBqCosine: return launch_packed_design<kBqCosine>(a);
    case kBqEuclidean: return launch_packed_design<kBqEuclidean>(a);
    case kBqManhattan: return launch_packed_design<kBqManhattan>(a);
    default: return cudaErrorInvalidValue;
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
// design: 0 warp, 1 staged (row types 0-2; staged needs vec), 2 group,
// 3 pair (row type 3; pair needs vec). Returns cudaGetLastError() after
// the launch, or the error that kept it from launching
// (cudaErrorInvalidValue for a row type, metric or design it does not
// take).
extern "C" int gather_distances(const void* vectors, const float* norms, const void* q,
                                const float* qn, const int32_t* idx, float* out,
                                long long n_rows, int dim, int batch, int k, int metric,
                                int row_type, int vec, int scale_rows, int design, void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(batch) * k;
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  const Args a{vectors, norms, q, qn, idx, out, n_rows, dim, batch, k, n_pairs,
               vec != 0, scale_rows != 0, design, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (row_type) {
    case kRowF32: err = launch_rows<float>(a, metric); break;
    case kRowBf16: err = launch_rows<__nv_bfloat16>(a, metric); break;
    case kRowInt8: err = launch_rows<int8_t>(a, metric); break;
    case kRowPacked: err = launch_packed_rows(a, metric); break;
    default: break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
