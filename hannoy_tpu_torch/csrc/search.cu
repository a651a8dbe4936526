// The search's loops on the card, hand-written for Hopper (sm_90a): the
// beam search and the greedy descent of an HNSW graph, each one launch for
// a whole batch, with the gather-distance reduction inside every hop.
//
// Replaces the device program the JAX package compiles for a search:
// hannoy_tpu/ops/beam.py:hnsw_search (@jax.jit), whose greedy descent
// (_greedy_level, a lax.while_loop) and beams (beam_search, a
// lax.while_loop over _beam_step) run on the device with the Pallas
// kernel hannoy_tpu/ops/beam_pallas.py:fused_gather_reduce inside each
// hop. The port's host loop (ops/beam.py:_while_loop) issues about 35
// torch ops a hop and reads a flag every SYNC_EVERY hops; these kernels
// issue none.
//
// Why one row at a time gives the batch's answers. The JAX loop (and the
// host loop) runs its body on every row while ANY row is active, up to
// max_iters times. For tail_allow == 0, which every search uses:
//   - the body is a no-op on a row that is not active: it expands no entry,
//     reads no links (its current slot is -1), and merges only +inf
//     entries, which the pool keeps behind its own;
//   - a row that is not active never becomes active again (the body left
//     its pool as it was);
// so running each row alone, until it is not active or has run max_iters
// hops, gives the same pools, and the batch's iteration count is the
// largest row's hop count. The same holds for the greedy descent: a row
// that did not improve keeps its slot and distance, so it never improves
// again, and the batch loop's `any(improved)` stops when the last row
// stops. So each block here runs one query's loop on its own and keeps
// its state in shared memory.
//
// beam_search_kernel: one block per query (kWarps warps). Shared memory:
// the query in f32 as the metric reads it (bf16-rounded for cosine on bf16
// rows), two copies of the pool (distance, id, expanded; 12 bytes an
// entry each, written alternately by the merges), and the hop's
// candidates: its size is ops/search_cuda.py:beam_shared's, which the
// routing rule and the launch share. Per row:
//   1. seed: the seeds pass if >= 0 and node_ok, the first occurrence of
//      each; their distances are merged into an empty pool of ef entries
//      (a seed at +inf or NaN keeps its distance but no id, as
//      ops/beam.py:_seed_pool does). Seeds arrive in chunks of the
//      candidate buffer; a later chunk's duplicate of an earlier seed is
//      dropped by the test against the pool (or lands past ef), so the
//      chunks give the one stable sort of all of them.
//   2. hop: the first pool entry with expanded == 0 and id != -1 (the pool
//      is sorted, so this is argmin's lowest-index tie), found by a
//      block-wide minimum; the row is active if its distance is <= the
//      pool's last and finite, else it is finished. Mark it expanded, read
//      its link row (links0[slot], or upper_links[l-1][slot_rows[l-1][slot]]
//      at level l >= 1; a row of -1 has no links) at its physical width,
//      keep a link if >= 0, node_ok, not in the current pool and the first
//      of its value in the row; one warp a candidate computes its distance
//      (row_distance.cuh: the gather kernel's own bits). The candidates
//      are ranked by (distance, link position) and merged with the pool,
//      the pool winning ties (torch.sort(stable=True) of concat(pool, new)
//      with NaN last), and the first ef kept. The pool holds ef entries
//      from the start (+inf where empty) and NaN sorts after +inf, so a
//      NaN distance (a row that holds NaN) never enters it.
//   3. stop when the row is not active or has run `budget` hops; write the
//      pool, add the hops and the distances computed to the row's counts,
//      and write whether the final pool is active (ops/beam.py:_rows_active).
// A launch with seeded != 0 starts from the pool in device memory instead
// of the seeds: a search with a cancel runs in chunks of SYNC_EVERY hops
// with the host's check between them, as the JAX package's _beam_chunk
// does.
//
// greedy_descend_kernel: one block per query, so that the M links of a
// step are M warps' distances at once (one warp per query would compute
// them one after another). From the entry points (those >= 0 and node_ok;
// argmin over their distances, lowest index on ties) through levels
// from_level .. to_level: each step reads the current slot's link row,
// keeps the links >= 0 and node_ok, and moves to the argmin only if its
// distance is strictly less than the current one, at most max_steps steps
// a level (ops/beam.py:greedy_descend / _greedy_level).
//
// What bounds them on the H100. A hop's work is a chain: the pool's first
// unexpanded entry, then its link row (one dependent trip to device
// memory), then the node_ok bytes and the candidates' rows (a second and
// a third), then the ranking and the merge in shared memory. Each block
// moves (links + distances) x a row's bytes a hop: 32 rows of 3 KB for
// f32 at 768, which is 96 KB, so a batch of 256 queries moves 25 MB a hop
// (7.5 us at 3.35 TB/s) while the chain costs about three trips of about
// a microsecond. So the latency of the chain bounds a hop at these batch
// sizes, not the bytes; the design keeps the chain to those trips (a lane
// loads kBatch of a row's units before it adds the first; the pool and
// the candidates never leave shared memory) and runs many blocks at once
// (shared memory is a few KB a block).
//
// Scope: f32, bf16 and int8 rows of whole 16-byte units from aligned bases
// (the gather kernel's staged design) under cosine, euclidean and
// manhattan, one entry expanded a hop, every link of a row, no tail
// allowance (ops/search_cuda.py:search_design_of). Ids and row offsets are
// 64-bit where they address the store.
//
// Built by hannoy_tpu_torch/ops/search_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; search_beam() and search_greedy() return
// cudaGetLastError() after the launch, or the error that kept it from
// launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "row_distance.cuh"

namespace {

using namespace rowdist;

constexpr int kRowF32 = 0;
constexpr int kRowBf16 = 1;
constexpr int kRowInt8 = 2;

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;  // units of a row a lane loads before it adds the first
constexpr int kEntryChunk = 1024;  // entry points a chunk of the greedy descent's start

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// torch.sort's order of floats: NaN after everything, NaNs equal.
__device__ __forceinline__ bool key_lt(float a, float b) { return a < b || (isnan(b) && !isnan(a)); }

// torch.argmin's order: NaN before everything (the first NaN wins), then
// the least number.
__device__ __forceinline__ bool argmin_lt(float a, float b) { return isnan(a) ? !isnan(b) : a < b; }

// Entries of the sorted a[0..n) that come before x (key_lt), and those that
// do not come after it.
__device__ __forceinline__ int count_lt(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_lt(a[mid], x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_le(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!key_lt(x, a[mid])) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

struct Graph {
  const void* vectors;  // [n_rows, dim] of ROW
  const float* norms;   // [n_rows]
  int64_t n_rows;
  int dim;
  const int32_t* links0;  // [n_pad, w0]
  int w0;
  const int32_t* upper;  // [L, u_pad, wu]
  int64_t u_pad;
  int wu;
  const int32_t* slot_rows;  // [L, n_pad]
  int64_t n_pad;
  const uint8_t* node_ok;  // [n_ok]
  int64_t n_ok;
  int64_t n_levels;  // L
  uint8_t* seen;  // nullptr, or the marks of what a launch reads (mark())
};

// With seen != nullptr a launch marks a byte for each thing it reads from
// the graph, at its place in [n_rows store rows | n_pad layer-0 link rows |
// L x u_pad upper link rows | L x n_pad slot-row entries], so that the
// bound of a timing can count each distinct row once. Timed launches pass
// nullptr.
__device__ __forceinline__ void mark(const Graph& g, int64_t at) {
  if (g.seen != nullptr) g.seen[at] = 1;
}

// The link row of `slot` at `level`, or nullptr where it has none.
__device__ __forceinline__ const int32_t* link_row(const Graph& g, int level, int32_t slot) {
  if (slot < 0) return nullptr;
  const bool marks = g.seen != nullptr && threadIdx.x == 0;
  if (level == 0) {
    if (marks) mark(g, g.n_rows + slot);
    return g.links0 + static_cast<int64_t>(slot) * g.w0;
  }
  const int32_t row = __ldg(g.slot_rows + static_cast<int64_t>(level - 1) * g.n_pad + slot);
  if (marks) mark(g, g.n_rows + g.n_pad + g.n_levels * g.u_pad + static_cast<int64_t>(level - 1) * g.n_pad + slot);
  if (row < 0) return nullptr;
  if (marks) mark(g, g.n_rows + g.n_pad + static_cast<int64_t>(level - 1) * g.u_pad + row);
  return g.upper + (static_cast<int64_t>(level - 1) * g.u_pad + row) * g.wu;
}

__device__ __forceinline__ bool node_ok(const Graph& g, int32_t id) {
  return id >= 0 && id < g.n_ok && __ldg(g.node_ok + id) != 0;
}

// The distance from the query (q4 in shared memory) to row `id` >= 0, by
// the whole warp; every lane returns it. An id past the store gives NaN.
template <typename ROW, int METRIC, bool SCALE>
__device__ __forceinline__ float distance(const Graph& g, const float4* q4, float q_norm, int32_t id, int lane) {
  using Unit = typename RowTraits<ROW>::Unit;
  constexpr bool HEADER = METRIC == kCosine || SCALE;
  if (id >= g.n_rows) return __int_as_float(0x7fc00000);
  if (lane == 0) mark(g, id);
  const int units = static_cast<int>(static_cast<int64_t>(g.dim) * sizeof(ROW) / sizeof(Unit));
  const ROW* row = static_cast<const ROW*>(g.vectors) + static_cast<int64_t>(id) * g.dim;
  const float head = HEADER ? __ldg(g.norms + id) : 1.f;
  float part[1] = {row_partial<ROW, METRIC, SCALE, kBatch, true>(reinterpret_cast<const Unit*>(row), q4, units, lane,
                                                                 SCALE ? head : 1.f)};
  warp_sum(part);
  return METRIC == kCosine ? cosine_distance(part[0], q_norm * head) : part[0];
}

// The query of block b into shared memory, as the metric reads it.
template <typename ROW, int METRIC>
__device__ __forceinline__ void stage_query(float* sq, const float* q, int64_t b, int dim) {
  constexpr bool RQ = METRIC == kCosine && sizeof(ROW) == 2;
  for (int i = threadIdx.x; i < dim; i += kThreads) sq[i] = query<RQ>(__ldg(q + b * dim + i));
}

struct Pool {
  float* d;
  int32_t* id;
  int32_t* exp;
};

struct Scratch {
  int32_t* raw;  // [cap] candidate ids that pass >= 0 and node_ok, else -1
  int32_t* id;   // [cap] ids admitted (-1 where not)
  float* d;      // [cap] their distances (+inf where not computed)
  float* sd;     // [cap] the candidates' distances in (distance, position) order
  int32_t* sid;  // [cap] their ids in that order
  int* red;      // [kWarps] the warps' minima
};

// Merge the n candidates at src[0..n) (nullptr: none) into the pool `cur`,
// writing the result to `nxt`; `seeds`: the seeding rules (a seed at +inf
// keeps no id). Ends with the block synchronised.
template <typename ROW, int METRIC, bool SCALE>
__device__ void admit(const Graph& g, const float4* q4, float q_norm, const int32_t* src, int n, bool seeds, Pool cur,
                      Pool nxt, int ef, Scratch s, int& n_dist) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < n; t += kThreads) {
    const int32_t id = src != nullptr ? __ldg(src + t) : -1;
    s.raw[t] = node_ok(g, id) ? id : -1;
  }
  __syncthreads();
  // one warp a candidate: the first of its value in the row, not in the
  // pool, then its distance
  for (int c = warp; c < n; c += kWarps) {
    const int32_t id = s.raw[c];
    float d = inf();
    int32_t kept = -1;
    if (id >= 0) {
      bool seen = false;
      for (int j = lane; j < c; j += 32) seen |= s.raw[j] == id;
      for (int i = lane; i < ef; i += 32) seen |= cur.id[i] == id;
      if (!__any_sync(0xffffffffu, seen)) {
        d = distance<ROW, METRIC, SCALE>(g, q4, q_norm, id, lane);
        kept = (!seeds || d < inf()) ? id : -1;
        n_dist += lane == 0;
      }
    }
    if (lane == 0) {
      s.id[c] = kept;
      s.d[c] = d;
    }
  }
  __syncthreads();
  // the candidates' stable order: key (distance, position)
  for (int t = tid; t < n; t += kThreads) {
    const float d = s.d[t];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const float e = s.d[j];
      r += key_lt(e, d) || (j < t && !key_lt(d, e));
    }
    s.sd[r] = d;
    s.sid[r] = s.id[t];
  }
  __syncthreads();
  // the merge: an entry's place is its own position plus the entries of
  // the other list before it, the pool's first on ties; keep ef
  for (int i = tid; i < ef; i += kThreads) {
    const float d = cur.d[i];
    const int at = i + count_lt(s.sd, n, d);
    if (at < ef) {
      nxt.d[at] = d;
      nxt.id[at] = cur.id[i];
      nxt.exp[at] = cur.exp[i];
    }
  }
  for (int r = tid; r < n; r += kThreads) {
    const float d = s.sd[r];
    const int at = r + count_le(cur.d, ef, d);
    if (at < ef) {
      nxt.d[at] = d;
      nxt.id[at] = s.sid[r];
      nxt.exp[at] = 0;
    }
  }
  __syncthreads();
}

// The position of the pool's first unexpanded entry (INT_MAX: none), the
// same in every thread. It is torch.argmin's choice as well: the pool is
// sorted and never holds a NaN (below). Ends with the block synchronised.
__device__ __forceinline__ int first_unexpanded(Pool p, int ef, int* red) {
  int best = INT_MAX;
  for (int i = threadIdx.x; i < ef; i += kThreads) {
    if (p.exp[i] == 0 && p.id[i] != -1) {
      best = i;  // a thread's positions rise, so its first is its least
      break;
    }
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  int m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, red[w]);
  return m;
}

struct BeamArgs {
  Graph g;
  const float* q;   // [B, dim] f32
  const float* qn;  // [B]
  const int32_t* start;  // [B, n_start]
  int n_start;
  int level;
  int width;  // link columns a hop reads
  int cap;    // the candidate buffer: a multiple of 32, >= width
  size_t smem;  // dynamic shared memory: ops/search_cuda.py:beam_shared, which sizes the layout below
  int ef;
  int budget;  // hops a row may run in this launch
  int seeded;  // 0: seed the pool from `start`; else read it from pool_*
  float* pool_d;      // [B, ef]
  int32_t* pool_id;   // [B, ef]
  int32_t* pool_exp;  // [B, ef]
  int32_t* hops;      // [B] hops run, added to
  int32_t* n_dist;    // [B] distances computed, added to
  uint8_t* active;    // [B] the final pool is active
};

template <typename ROW, int METRIC, bool SCALE>
__global__ void __launch_bounds__(kThreads) beam_search_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, ef = a.ef, cap = a.cap, dim = a.g.dim;
  float* sq = reinterpret_cast<float*>(smem);
  float* f = sq + dim;
  Pool pool[2] = {{f, reinterpret_cast<int32_t*>(f + ef), reinterpret_cast<int32_t*>(f + 2 * ef)},
                  {f + 3 * ef, reinterpret_cast<int32_t*>(f + 4 * ef), reinterpret_cast<int32_t*>(f + 5 * ef)}};
  int32_t* tail = reinterpret_cast<int32_t*>(f + 6 * ef);
  const Scratch s{tail, tail + cap, reinterpret_cast<float*>(tail + 2 * cap), reinterpret_cast<float*>(tail + 3 * cap),
                  tail + 4 * cap, tail + 5 * cap};

  stage_query<ROW, METRIC>(sq, a.q, b, dim);
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  const float q_norm = METRIC == kCosine ? __ldg(a.qn + b) : 0.f;
  float* gd = a.pool_d + b * ef;
  int32_t* gi = a.pool_id + b * ef;
  int32_t* ge = a.pool_exp + b * ef;
  for (int i = tid; i < ef; i += kThreads) {
    pool[0].d[i] = a.seeded ? gd[i] : inf();
    pool[0].id[i] = a.seeded ? gi[i] : -1;
    pool[0].exp[i] = a.seeded ? ge[i] : 0;
  }
  __syncthreads();
  int cur = 0, n_dist = 0;
  if (!a.seeded) {
    for (int c0 = 0; c0 < a.n_start; c0 += cap) {
      admit<ROW, METRIC, SCALE>(a.g, q4, q_norm, a.start + b * a.n_start + c0, min(cap, a.n_start - c0), true,
                                pool[cur], pool[cur ^ 1], ef, s, n_dist);
      cur ^= 1;
    }
  }
  int hops = 0;
  bool active = false;
  while (true) {
    const int p = first_unexpanded(pool[cur], ef, s.red);
    const float exp_d = p < ef ? pool[cur].d[p] : inf();
    active = exp_d <= pool[cur].d[ef - 1] && exp_d < inf();
    if (!active || hops == a.budget) break;
    const int32_t slot = pool[cur].id[p];
    if (tid == 0) pool[cur].exp[p] = 1;
    admit<ROW, METRIC, SCALE>(a.g, q4, q_norm, link_row(a.g, a.level, slot), a.width, false, pool[cur],
                              pool[cur ^ 1], ef, s, n_dist);
    cur ^= 1;
    ++hops;
  }
  for (int i = tid; i < ef; i += kThreads) {
    gd[i] = pool[cur].d[i];
    gi[i] = pool[cur].id[i];
    ge[i] = pool[cur].exp[i];
  }
  if ((tid & 31) == 0 && n_dist > 0) atomicAdd(a.n_dist + b, n_dist);
  if (tid == 0) {
    a.hops[b] += hops;
    a.active[b] = active ? 1 : 0;
  }
}

struct GreedyArgs {
  Graph g;
  const float* q;
  const float* qn;
  const int32_t* entry;  // [n_entry] entry points (-1 padded)
  int n_entry;
  int cap;  // the candidate buffer: a multiple of 32, >= wu
  int from_level;
  int to_level;  // levels from_level .. to_level, descending (none if from < to)
  int max_steps;  // steps a row may take a level in this launch
  int init;  // != 0: start from the entry points, every level from improved = 1
  int32_t* cur;      // [B] the slot (in/out)
  float* cur_d;      // [B] its distance (in/out)
  uint8_t* improved;  // [B] the last step improved (in/out; read where init == 0)
  int32_t* steps;    // [B] steps taken, added to
  int32_t* n_dist;   // [B] distances computed, added to
};

size_t greedy_smem(int dim, int cap) {
  return 4 * (static_cast<size_t>(dim) + 2 * static_cast<size_t>(cap) + 4);
}

// torch.argmin over the block's n distances in d (the first NaN, else the
// first of equal minima) by thread 0, into red: [0] the position, [1] the
// distance bits, [2] the id at that position in `ids`.
__device__ __forceinline__ void argmin_to(const float* d, const int32_t* ids, int n, int* red) {
  if (threadIdx.x == 0) {
    int best = 0;
    for (int j = 1; j < n; ++j) best = argmin_lt(d[j], d[best]) ? j : best;
    red[0] = best;
    red[1] = __float_as_int(d[best]);
    red[2] = ids[best];
  }
}

template <typename ROW, int METRIC, bool SCALE>
__global__ void __launch_bounds__(kThreads) greedy_descend_kernel(GreedyArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cap = a.cap, dim = a.g.dim;
  float* sq = reinterpret_cast<float*>(smem);
  int32_t* raw = reinterpret_cast<int32_t*>(sq + dim);
  float* cd = reinterpret_cast<float*>(raw + cap);
  int* red = reinterpret_cast<int*>(cd + cap);

  stage_query<ROW, METRIC>(sq, a.q, b, dim);
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  const float q_norm = METRIC == kCosine ? __ldg(a.qn + b) : 0.f;
  int n_dist = 0, steps = 0;
  int32_t cur;
  float cur_d;
  if (a.init) {
    // the entry points: torch.argmin over those >= 0 and node_ok (the
    // others at +inf), in chunks; a later chunk wins only if it comes
    // strictly first in argmin's order
    int best = -1;
    float best_d = inf();
    for (int c0 = 0; c0 < a.n_entry; c0 += cap) {
      const int n = min(cap, a.n_entry - c0);
      __syncthreads();  // the last chunk's argmin has read the buffers
      for (int t = tid; t < n; t += kThreads) {
        const int32_t id = __ldg(a.entry + c0 + t);
        raw[t] = node_ok(a.g, id) ? id : -1;
      }
      __syncthreads();
      for (int c = warp; c < n; c += kWarps) {
        const int32_t id = raw[c];
        const float d = id >= 0 ? distance<ROW, METRIC, SCALE>(a.g, q4, q_norm, id, lane) : inf();
        n_dist += lane == 0 && id >= 0;
        if (lane == 0) cd[c] = d;
      }
      __syncthreads();
      if (tid == 0) {
        for (int j = 0; j < n; ++j) {
          if (best < 0 || argmin_lt(cd[j], best_d)) {
            best = c0 + j;
            best_d = cd[j];
          }
        }
      }
    }
    if (tid == 0) {
      red[0] = __ldg(a.entry + best);  // the entry point itself, as torch's gather takes it
      red[1] = __float_as_int(best_d);
    }
    __syncthreads();
    cur = red[0];
    cur_d = __int_as_float(red[1]);
  } else {
    cur = a.cur[b];
    cur_d = a.cur_d[b];
  }
  bool improved = a.init ? true : a.improved[b] != 0;
  for (int level = a.from_level; level >= a.to_level; --level) {
    if (a.init) improved = true;
    for (int s = 0; improved && s < a.max_steps; ++s) {
      const int32_t* row = link_row(a.g, level, cur);
      const int n = a.g.wu;
      __syncthreads();  // the last step has read the buffers
      for (int t = tid; t < n; t += kThreads) {
        const int32_t id = row != nullptr ? __ldg(row + t) : -1;
        raw[t] = node_ok(a.g, id) ? id : -1;
      }
      __syncthreads();
      for (int c = warp; c < n; c += kWarps) {
        const int32_t id = raw[c];
        const float d = id >= 0 ? distance<ROW, METRIC, SCALE>(a.g, q4, q_norm, id, lane) : inf();
        n_dist += lane == 0 && id >= 0;
        if (lane == 0) cd[c] = d;
      }
      __syncthreads();
      argmin_to(cd, raw, n, red);
      __syncthreads();
      const float best_d = __int_as_float(red[1]);
      improved = best_d < cur_d;
      if (improved) cur = red[2];
      cur_d = improved ? best_d : (isnan(best_d) ? best_d : cur_d);  // torch.minimum
      ++steps;
    }
  }
  if ((tid & 31) == 0 && n_dist > 0) atomicAdd(a.n_dist + b, n_dist);
  if (tid == 0) {
    a.cur[b] = cur;
    a.cur_d[b] = cur_d;
    a.improved[b] = improved ? 1 : 0;
    a.steps[b] += steps;
  }
}

template <typename KERNEL, typename ARGS>
cudaError_t launch_with(KERNEL kernel, const ARGS& args, int batch, size_t smem, std::atomic<uint64_t>& allowed_on,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_opt_in_shared(kernel, allowed_on);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(batch), kThreads, smem, stream>>>(args);
  return cudaSuccess;
}

template <typename ROW, int METRIC, bool SCALE>
cudaError_t launch_beam(const BeamArgs& a, int batch, cudaStream_t stream) {
  static std::atomic<uint64_t> allowed_on{0};
  return launch_with(beam_search_kernel<ROW, METRIC, SCALE>, a, batch, a.smem, allowed_on, stream);
}

template <typename ROW, int METRIC, bool SCALE>
cudaError_t launch_greedy(const GreedyArgs& a, int batch, cudaStream_t stream) {
  static std::atomic<uint64_t> allowed_on{0};
  return launch_with(greedy_descend_kernel<ROW, METRIC, SCALE>, a, batch, greedy_smem(a.g.dim, a.cap), allowed_on,
                     stream);
}

// The form of a launch: row type × metric × (int8 rows of euclidean /
// manhattan carry a scale); only those pay for the choice.
template <template <typename, int, bool> class LAUNCH, typename ARGS>
struct Dispatch {
  template <typename ROW, int METRIC>
  static cudaError_t metric_of(const ARGS& a, int batch, bool scale_rows, cudaStream_t stream) {
    if constexpr (sizeof(ROW) == 1 && METRIC != kCosine) {
      if (scale_rows) return LAUNCH<ROW, METRIC, true>::run(a, batch, stream);
    }
    return LAUNCH<ROW, METRIC, false>::run(a, batch, stream);
  }
  template <typename ROW>
  static cudaError_t row_of(const ARGS& a, int batch, int metric, bool scale_rows, cudaStream_t stream) {
    switch (metric) {
      case kCosine: return metric_of<ROW, kCosine>(a, batch, scale_rows, stream);
      case kEuclidean: return metric_of<ROW, kEuclidean>(a, batch, scale_rows, stream);
      case kManhattan: return metric_of<ROW, kManhattan>(a, batch, scale_rows, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  static cudaError_t run(const ARGS& a, int batch, int metric, int row_type, bool scale_rows, cudaStream_t stream) {
    switch (row_type) {
      case kRowF32: return row_of<float>(a, batch, metric, scale_rows, stream);
      case kRowBf16: return row_of<__nv_bfloat16>(a, batch, metric, scale_rows, stream);
      case kRowInt8: return row_of<int8_t>(a, batch, metric, scale_rows, stream);
      default: return cudaErrorInvalidValue;
    }
  }
};

template <typename ROW, int METRIC, bool SCALE>
struct BeamLaunch {
  static cudaError_t run(const BeamArgs& a, int batch, cudaStream_t stream) {
    return launch_beam<ROW, METRIC, SCALE>(a, batch, stream);
  }
};

template <typename ROW, int METRIC, bool SCALE>
struct GreedyLaunch {
  static cudaError_t run(const GreedyArgs& a, int batch, cudaStream_t stream) {
    return launch_greedy<ROW, METRIC, SCALE>(a, batch, stream);
  }
};

int round_cap(int width) { return ((width > 1 ? width : 1) + 31) / 32 * 32; }

// The rows must be whole 16-byte units from a 16-byte aligned base, as the
// staged design of the gather kernel needs (ops/search_cuda.py checks).
bool rows_ok(const Graph& g, int row_type) {
  const int elem = row_type == kRowF32 ? 4 : row_type == kRowBf16 ? 2 : 1;
  return (static_cast<int64_t>(g.dim) * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(g.vectors) % 16 == 0;
}

}  // namespace

// The graph (every launch): vectors [n_rows, dim] (row_type 0 f32, 1 bf16,
// 2 int8), norms [n_rows], links0 [n_pad, w0], upper [L, u_pad, wu],
// slot_rows [L, n_pad], node_ok [n_ok] (bytes), L = n_levels; seen:
// nullptr, or n_rows + n_pad x (1 + L) + L x u_pad bytes (mark()); metric 0 cosine,
// 1 euclidean, 2 manhattan; scale_rows != 0 scales int8 rows by norms[row]
// (euclidean / manhattan). q [batch, dim] f32, qn [batch].
#define GRAPH_PARAMS                                                                                              \
  const void *vectors, const float *norms, long long n_rows, int dim, const int32_t *links0, int w0,              \
      const int32_t *upper, long long u_pad, int wu, const int32_t *slot_rows, long long n_pad,                   \
      const uint8_t *node_ok, long long n_ok, long long n_levels, uint8_t *seen
#define GRAPH_ARGS \
  Graph { vectors, norms, n_rows, dim, links0, w0, upper, u_pad, wu, slot_rows, n_pad, node_ok, n_ok, n_levels, seen }

// One beam at `level` for each of `batch` queries: seeded from start
// [batch, n_start] (seeded == 0) or continued from the pool (seeded != 0),
// at most `budget` hops a row. cap and smem: the candidate buffer and the
// block's shared memory, from ops/search_cuda.py:beam_shared. pool_*
// [batch, ef] out (in where seeded); hops and n_dist [batch] are added to;
// active [batch] out.
extern "C" int search_beam(GRAPH_PARAMS, const float* q, const float* qn, int batch, const int32_t* start, int n_start,
                           int level, int ef, int cap, long long smem, int budget, int seeded, float* pool_d,
                           int32_t* pool_id, int32_t* pool_exp, int32_t* hops, int32_t* n_dist, uint8_t* active,
                           int metric, int row_type, int scale_rows, void* stream) {
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Graph g = GRAPH_ARGS;
  const int width = level == 0 ? w0 : wu;
  if (!rows_ok(g, row_type) || ef < 1 || budget < 0 || cap < width || cap % 32 != 0 || smem <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BeamArgs a{g, q, qn, start, n_start, level, width, cap, static_cast<size_t>(smem), ef, budget, seeded,
                   pool_d, pool_id, pool_exp, hops, n_dist, active};
  const cudaError_t err = Dispatch<BeamLaunch, BeamArgs>::run(a, batch, metric, row_type, scale_rows != 0,
                                                              static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The greedy descent of `batch` queries through levels from_level ..
// to_level (>= 1), at most max_steps steps a level: from the entry points
// [n_entry] (init != 0) or from cur / cur_d / improved. cur, cur_d and
// improved [batch] out; steps and n_dist [batch] are added to.
extern "C" int search_greedy(GRAPH_PARAMS, const float* q, const float* qn, int batch, const int32_t* entry,
                             int n_entry, int from_level, int to_level, int max_steps, int init, int32_t* cur,
                             float* cur_d, uint8_t* improved, int32_t* steps, int32_t* n_dist, int metric,
                             int row_type, int scale_rows, void* stream) {
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Graph g = GRAPH_ARGS;
  if (!rows_ok(g, row_type) || (init && n_entry < 1) || (from_level >= to_level && to_level < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the entry points go through the candidate buffer in chunks of up to
  // kEntryChunk (a flat graph may have thousands)
  const int entries = n_entry < kEntryChunk ? n_entry : kEntryChunk;
  const GreedyArgs a{g, q, qn, entry, n_entry, round_cap(init && entries > wu ? entries : wu),
                     from_level, to_level, max_steps, init, cur, cur_d, improved, steps, n_dist};
  const cudaError_t err = Dispatch<GreedyLaunch, GreedyArgs>::run(a, batch, metric, row_type, scale_rows != 0,
                                                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
