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
// beam_search_kernel: one block per query (kWarps warps). Shared memory,
// sized by ops/search_cuda.py:beam_shared (the routing rule and the launch
// share it): the query in f32 as the metric reads it (bf16-rounded for
// cosine on bf16 rows), the staging buffer (kWarps x S rows, S slots a
// warp; packed rows have neither, see below), the split's clocks, two copies of the pool (distance, id,
// expanded; written alternately by the merges), the hop's distances and
// ids, and the warps' finds in the pool. Per row:
//   1. seed: the seeds pass if >= 0 and node_ok, the first occurrence of
//      each; their distances are merged into an empty pool of ef entries
//      (a seed at +inf or NaN keeps its distance but no id, as
//      ops/beam.py:_seed_pool does). Seeds arrive in chunks of the
//      candidate capacity; a later chunk's duplicate of an earlier seed is
//      dropped by the test against the pool (or lands past ef), so the
//      chunks give the one stable sort of all of them.
//   2. hop: the first pool entry with expanded == 0 and id != -1 (the pool
//      is sorted, so this is argmin's lowest-index tie); the row is active
//      if its distance is <= the pool's last and finite, else it is
//      finished. Read its link row (links0[slot], or
//      upper_links[l-1][slot_rows[l-1][slot]] at level l >= 1; a row of -1
//      has no links) at its physical width, keep a link if >= 0, node_ok,
//      not in the current pool and the first of its value in the row,
//      compute its distance (row_distance.cuh: the gather kernel's own
//      bits), rank the candidates by (distance, link position) and merge
//      them with the pool, the pool winning ties (torch.sort(stable=True)
//      of concat(pool, new) with NaN last), keeping the first ef and
//      marking the expanded entry. The pool holds ef entries from the
//      start (+inf where empty) and NaN sorts after +inf, so a NaN distance
//      (a row that holds NaN) never enters it.
//   3. stop when the row is not active or has run `budget` hops; write the
//      pool, add the hops and the distances computed to the row's counts,
//      and write whether the final pool is active (ops/beam.py:_rows_active).
// A launch with seeded != 0 starts from the pool in device memory instead
// of the seeds: a search with a cancel runs in chunks of SYNC_EVERY hops
// with the host's check between them, as the JAX package's _beam_chunk
// does.
//
// greedy_descend_kernel: one block per query. From the entry points (those
// >= 0 and node_ok; argmin over their distances, lowest index on ties)
// through levels from_level .. to_level: each step reads the current
// slot's link row, keeps the links >= 0 and node_ok, and moves to the
// argmin only if its distance is strictly less than the current one, at
// most max_steps steps a level (ops/beam.py:greedy_descend /
// _greedy_level).
//
// What bounds a hop on the H100, and the design. A hop is a chain: the
// pool's first unexpanded entry, its link row (a dependent trip to device
// memory; at level >= 1 the slot-row entry is one more before it), then
// the candidates' rows (a second), then the ranking and the merge in
// shared memory. At 1M x 768 f32, ef 100, a batch of 256 queries moves
// about 3.2 us a hop of rows at 3.35 TB/s if every distance read its row
// anew. The first design took 12.9 us a hop; its split (cycles of thread 0
// a hop, chip_smoke.py phase 13 with `clocks`): the rank 0.36 (an O(n^2)
// count on one warp), dedup 0.15, barriers 0.13, row trips 0.12 (one warp
// a candidate, one row after another), merge 0.11, link row and node_ok
// 0.10 (two dependent trips before the first row). So here:
//   - every warp reads the link row and takes the candidates itself
//     (first of its value by __match_any_sync, compacted by ballots); the
//     test against the pool is split among the warps (each scans every
//     8th group of the pool's ids) and joined after one barrier;
//   - node_ok's bytes are loaded beside the rows, not before them: a
//     candidate's row is copied before its node_ok is known (a row not
//     node_ok is dropped after it landed), so the chain is two trips, the
//     link row and then every row at once;
//   - warp w stages and reduces candidates w, w + 8, ...: all of its rows
//     by 16-byte cp.async from all lanes into its own S slots, with their
//     headers, then one wait, and the reduction from shared memory
//     (row_partial<GLOBAL=false>, the gather kernel's staged reduction);
//     a warp with more rows than slots takes them in rounds;
//   - the rank is a count: candidate e's place is the number of keys
//     before it in (distance, position) order, by one thread of the last
//     warps, and a pool entry's shift the number of candidates before it,
//     by its own thread, so neither needs a sorted list;
//   - three block barriers a hop: the pool's test joined, the distances
//     written, the merge written.
// The new hop takes 7.9 us at 1M (0.41 of the per-pair floor); its split:
// rows 0.18, reduce 0.17, dedup 0.15, merge 0.10, entry 0.08, links 0.06,
// and the waits at the barriers 0.24 (the slowest warp's rows and the
// rank). What bounds it now is that chain of small in-block steps, each
// 3-4x its instructions' latency, more than its two trips. The greedy
// descent stages its <= 64 rows the same way, takes the argmin by every
// warp's shuffle reduction (no barrier after it: the distances alternate
// between two buffers) and syncs the block once a step; its step (3.8 us)
// is as long as the first design's, the chain link row -> rows -> argmin
// the same.
// With `clocks` a launch records, per block, the cycles thread 0 spends
// in each stage (Stage below; a barrier's wait from the warps' arrival
// clocks); PERF.md §6 has the splits.
//
// The packed form (hamming and the BQ metrics: rows of 32-bit lanes, 192
// bytes at 1,536 bits). A packed hop moves little (32 rows of 192 B is
// 6 KB), so it is bound by its chain of latencies, not by bytes, and the
// staging that dense rows need (the copies, their wait, the barrier-free
// reduction from shared memory) would only lengthen it. So a packed block
// stages nothing: each thread holds its share of the query's lanes in
// registers, read once a block (PackedQuery); a hop's candidates go to
// groups of kGroup lanes, 8 a warp and 64 a block, so that every
// candidate of a hop is read in the one trip: group j of warp w loads the
// row of the candidate at link position w + 8j, units s, s + 4, ... into
// registers (three 16-byte loads a lane at 1,536 bits, 64 contiguous bytes
// a group an instruction), beside its norm under BQ cosine; then __popc of
// the xor, two shuffles, and packed_distance (row_distance.cuh, the gather
// kernel's epilogue). The entry, the link row, the dedup, the rank and the
// merge are the dense forms' code, so the tie rule is the same: the host
// loop's stable merge, the pool first.
//
// Scope: f32, bf16 and int8 rows of whole 16-byte units from aligned bases
// (the gather kernel's staged design) under cosine, euclidean and
// manhattan, and packed rows of whole 16-byte units from aligned bases (its
// pair design) under the four packed metrics; one entry expanded a hop,
// every link of a row (at most kMaxCap), no tail allowance
// (ops/search_cuda.py:search_design_of). Ids and row offsets are 64-bit
// where they address the store.
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
#include <type_traits>

#include "row_distance.cuh"

namespace {

using namespace rowdist;

constexpr int kRowF32 = 0;
constexpr int kRowBf16 = 1;
constexpr int kRowInt8 = 2;
constexpr int kRowPacked = 3;  // 32-bit lanes of sign bits (the packed metrics), uint32_t below

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCap = 64;  // candidates a hop or step takes at most: two a lane
constexpr unsigned kAll = 0xffffffffu;
constexpr int kGroup = 4;  // packed form: lanes of a warp that take one candidate
constexpr int kHold = 4;   // packed form: 16-byte units of the query each of them holds in registers
static_assert(kWarps * (32 / kGroup) == kMaxCap, "the packed form's groups take a hop's candidates in one trip");

// The packed form's row type: the lanes of hamming and the BQ metrics.
template <typename ROW>
constexpr bool kPacked = std::is_same_v<ROW, uint32_t>;

// The stages of a hop that `clocks` splits a launch's time into (cycles of
// thread 0, summed over the block's hops or steps).
enum Stage {
  kEntry,    // the pool's first unexpanded entry (greedy: the entry points)
  kLinks,    // the link row (and the slot-row entry before it)
  kDedup,    // first of its value, not in the pool, the compaction
  kRows,     // the rows' copies issued and landed
  kReduce,   // the reduction and the epilogue
  kRank,     // the rank of the candidates (greedy: the argmin)
  kMerge,    // the merge into the next pool (greedy: the move)
  kBarrier,  // waiting at the block's barriers
  kStages
};
// The clocks in shared memory: kStages + 1 int64 of thread 0 (the last one
// keeps a loaded id alive), then 2 x kWarps arrival times at the barriers
// (alternate barriers use alternate halves), 16-byte aligned.
constexpr int kClockBytes = 208;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.sort's order of floats: NaN after everything, NaNs equal.
__device__ __forceinline__ bool key_lt(float a, float b) { return a < b || (isnan(b) && !isnan(a)); }

// torch.argmin's order: NaN before everything (the first NaN wins), then
// the least number.
__device__ __forceinline__ bool argmin_lt(float a, float b) { return isnan(a) ? !isnan(b) : a < b; }

// Entries of the sorted a[0..n) that do not come after x (key_lt).
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

// With seen != nullptr a launch marks a byte for each thing it needs from
// the graph, at its place in [n_rows store rows | n_pad layer-0 link rows |
// L x u_pad upper link rows | L x n_pad slot-row entries]: each row it
// computes a distance to, each link row and slot-row entry its hops read,
// so that the bound of a timing can count each distinct one once. Timed
// launches pass nullptr.
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

// Cycles of thread 0 per stage (acc: shared [kStages + 1] in a timed
// launch, nullptr in every other thread and in untimed launches). A
// barrier's time is read from the warps' arrivals (arrive: shared
// [2][kWarps], set in lane 0 of every warp of a timed launch): thread 0
// waits there until the last warp arrives, whatever the clock read after
// the barrier says.
struct Stopwatch {
  long long* acc;
  long long* arrive;
  long long last;
  int half;  // the half of `arrive` the next barrier uses
  __device__ __forceinline__ void lap(int stage) {
    if (acc != nullptr) {
      const long long now = clock64();
      acc[stage] += now - last;
      last = now;
    }
  }
  // Wait for a loaded value before the next lap (a store reads it).
  __device__ __forceinline__ void wait_for(int32_t v) {
    if (acc != nullptr) acc[kStages] = v;
  }
};

__device__ __forceinline__ void block_sync(Stopwatch& sw) {
  long long* at = sw.arrive != nullptr ? sw.arrive + sw.half * kWarps : nullptr;
  if (at != nullptr) at[threadIdx.x >> 5] = clock64();
  __syncthreads();
  if (sw.acc != nullptr) {
    long long release = at[0];
    for (int w = 1; w < kWarps; ++w) release = max(release, at[w]);
    sw.acc[kBarrier] += release - sw.last;
    sw.last = release;
  }
  sw.half ^= 1;
}

// The Stopwatch of this thread: `clk` the block's clocks in shared memory
// (zeroed), `timed` whether the launch records them.
__device__ __forceinline__ Stopwatch stopwatch(long long* clk, bool timed) {
  const bool lane0 = (threadIdx.x & 31) == 0;
  return Stopwatch{timed && threadIdx.x == 0 ? clk : nullptr, timed && lane0 ? clk + kStages + 1 : nullptr,
                   clock64(), 0};
}

// A warp's view of up to kMaxCap candidates, the same in every warp of the
// block: lane l holds candidates l and 32 + l.
struct Cands {
  int32_t id[2];   // the candidate ids (-1 past the count)
  uint32_t ok[2];  // their node_ok bytes, loaded beside the rows: read only after them
  int slot[2];     // their place among the taken candidates (-1: not taken)
  int n0, n;       // candidates taken in the first 32, in all
};

__device__ __forceinline__ void load_cands(const Graph& g, const int32_t* src, int n, int lane, Cands& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = 32 * h + lane;
    c.id[h] = (src != nullptr && t < n) ? __ldg(src + t) : -1;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int32_t id = c.id[h];
    c.ok[h] = (id >= 0 && id < g.n_ok) ? static_cast<uint32_t>(__ldg(g.node_ok + id)) : 0u;
  }
}

// Take the candidates with take[h] set, in order: their places and counts.
__device__ __forceinline__ void compact(Cands& c, const bool (&take)[2], int lane) {
  const unsigned below = (1u << lane) - 1u;
  const unsigned m0 = __ballot_sync(kAll, take[0]), m1 = __ballot_sync(kAll, take[1]);
  c.n0 = __popc(m0);
  c.n = c.n0 + __popc(m1);
  c.slot[0] = take[0] ? __popc(m0 & below) : -1;
  c.slot[1] = take[1] ? c.n0 + __popc(m1 & below) : -1;
}

// The beam's candidates: >= 0, the first of its value among the n
// candidates, not among the pool's ids (efp of them, -1 past ef). Warp w
// compares them with every kWarps-th group of 4 of the pool's ids and
// leaves the ballot of its finds in masks[w] (and masks[kWarps + w] for
// the second 32); after a barrier every warp joins the 8 ballots. node_ok
// is applied after the rows (a row not node_ok is staged and dropped).
__device__ __forceinline__ void take_fresh(Cands& c, int n, const int32_t* pool_id, int efp, unsigned* masks,
                                           int lane, Stopwatch& sw) {
  const int warp = threadIdx.x >> 5;
  bool take[2];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the lowest lane of each value within the 32 wins (every lane takes
    // part in the match)
    const unsigned same = __match_any_sync(kAll, c.id[h]);
    take[h] = c.id[h] >= 0 && (same & below) == 0;
  }
  if (n > 32) {
    for (int j = 0; j < 32; ++j) take[1] &= __shfl_sync(kAll, c.id[0], j) != c.id[1];
  }
  if (__any_sync(kAll, take[0] || take[1])) {  // the same in every warp
    bool in0 = false, in1 = false;
    const int4* p4 = reinterpret_cast<const int4*>(pool_id);
    const int32_t a = c.id[0], b = c.id[1];
    for (int i = warp; i < efp / 4; i += kWarps) {
      const int4 v = p4[i];  // a broadcast
      in0 |= (v.x == a) | (v.y == a) | (v.z == a) | (v.w == a);
      in1 |= (v.x == b) | (v.y == b) | (v.z == b) | (v.w == b);
    }
    const unsigned m0 = __ballot_sync(kAll, in0), m1 = __ballot_sync(kAll, in1);
    if (lane == 0) {
      masks[warp] = m0;
      masks[kWarps + warp] = m1;
    }
    sw.lap(kDedup);
    block_sync(sw);
    unsigned all0 = 0, all1 = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      all0 |= masks[w];
      all1 |= masks[kWarps + w];
    }
    take[0] &= ((all0 >> lane) & 1u) == 0;
    take[1] &= ((all1 >> lane) & 1u) == 0;
  }
  compact(c, take, lane);
}

// Candidate k of the taken ones: (its half, its lane), the same in every lane.
__device__ __forceinline__ int holder(const Cands& c, int k, int& h) {
  const unsigned m0 = __ballot_sync(kAll, c.slot[0] == k);
  const unsigned m1 = __ballot_sync(kAll, c.slot[1] == k);
  h = m0 ? 0 : 1;
  return __ffs(m0 ? m0 : m1) - 1;
}

__device__ __forceinline__ int32_t pick(const int32_t (&v)[2], int h, int src) {
  return __shfl_sync(kAll, h ? v[1] : v[0], src);
}
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[2], int h, int src) {
  return __shfl_sync(kAll, h ? v[1] : v[0], src);
}

// The distances of this warp's candidates k = warp, warp + kWarps, ... of
// the c.n taken: their rows and headers staged in the warp's S slots (a
// round of at most S rows at a time), reduced from shared memory. d[k]:
// the distance, NaN past the store, +inf where not node_ok; ids[k]
// (optional): the id where node_ok (and, with `seeds`, the distance is
// below +inf), else -1. n_dist counts the distances computed (lane 0).
template <typename ROW, int METRIC, bool SCALE>
__device__ __forceinline__ void warp_distances(const Graph& g, const Cands& c, const float4* q4, float q_norm,
                                               unsigned char* slots, int S, float* d, int32_t* ids, bool seeds,
                                               Stopwatch& sw, int& n_dist) {
  using Unit = typename RowTraits<ROW>::Unit;
  constexpr bool HEADER = METRIC == kCosine || SCALE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_bytes = g.dim * static_cast<int>(sizeof(ROW));
  const int units = row_bytes / static_cast<int>(sizeof(Unit));
  const unsigned char* vectors = static_cast<const unsigned char*>(g.vectors);
  for (int k0 = warp; k0 < c.n; k0 += kWarps * S) {
    // every row of the round in flight at once; lane j keeps row j's id,
    // its holder and its header
    int32_t rid = -1;
    int rsrc = 0;
    float head = 1.f;
    __syncwarp();  // the last round's rows have been read
    for (int j = 0; j < S; ++j) {
      const int k = k0 + kWarps * j;
      if (k >= c.n) break;
      int h;
      const int src = holder(c, k, h);
      const int32_t id = pick(c.id, h, src);
      if (lane == j) {
        rid = id;
        rsrc = h * 32 + src;
      }
      if (id < g.n_rows) {
        const unsigned char* from = vectors + static_cast<int64_t>(id) * row_bytes;
        unsigned char* to = slots + j * row_bytes;
        for (int u = 16 * lane; u < row_bytes; u += 16 * 32) copy16(to + u, from + u);
        if (HEADER && lane == j) head = __ldg(g.norms + id);
      }
    }
    copies_commit();
    copies_wait<0>();
    __syncwarp();
    sw.lap(kRows);
    for (int j = 0; j < S; ++j) {
      const int k = k0 + kWarps * j;
      if (k >= c.n) break;
      const int32_t id = __shfl_sync(kAll, rid, j);
      const int src = __shfl_sync(kAll, rsrc, j);
      const bool ok = pick(c.ok, src >> 5, src & 31) != 0;
      const float hj = __shfl_sync(kAll, head, j);
      float dist = inf();
      if (ok && id >= g.n_rows) {
        dist = nan_f();
      } else if (ok) {
        float part[1] = {row_partial<ROW, METRIC, SCALE, 1, false>(reinterpret_cast<const Unit*>(slots + j * row_bytes),
                                                                   q4, units, lane, SCALE ? hj : 1.f)};
        warp_sum(part);
        dist = METRIC == kCosine ? cosine_distance(part[0], q_norm * hj) : part[0];
      }
      if (lane == 0) {
        d[k] = dist;
        if (ids != nullptr) ids[k] = (ok && (!seeds || dist < inf())) ? id : -1;
        if (ok) {
          ++n_dist;
          if (id < g.n_rows) mark(g, id);
        }
      }
    }
    sw.lap(kReduce);
  }
}

// A packed query as the packed form holds it, read once a block: lane s of
// each group of kGroup lanes keeps units s, s + kGroup, ... (the first kHold
// of them, zero past the row) in registers; a row wider than kGroup x kHold
// units reads its further units from `lanes` through L1. The query is read
// by 32-bit loads, so it needs no alignment of its own.
struct PackedQuery {
  uint4 u[kHold];
  const uint32_t* lanes;  // the query's lanes in device memory
  int units;              // 16-byte units of a row
};

__device__ __forceinline__ uint4 lanes4(const uint32_t* p) {
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ PackedQuery packed_query(const float* q, int64_t b, int units) {
  PackedQuery pq;
  pq.lanes = reinterpret_cast<const uint32_t*>(q) + b * 4 * units;
  pq.units = units;
  const int s = threadIdx.x % kGroup;
#pragma unroll
  for (int j = 0; j < kHold; ++j) {
    const int u = s + kGroup * j;
    pq.u[j] = u < units ? lanes4(pq.lanes + 4 * u) : make_uint4(0u, 0u, 0u, 0u);
  }
  return pq;
}

// The packed form's distances, arguments as warp_distances' (no staging):
// group j of warp w takes the candidate at position w + kWarps * j of the up
// to kMaxCap the hop offered (lane t % 32 holds position t), if it was
// taken. Its kGroup lanes load the row's units straight into registers, all
// in one trip, with the norm under BQ cosine, xor them with the query's,
// count the bits, and add the counts by two shuffles; the first lane
// applies packed_distance. A count is an integer, so any order of the sums
// gives the gather kernel's bits.
template <int METRIC>
__device__ __forceinline__ void packed_distances(const Graph& g, const Cands& c, const PackedQuery& q, float q_norm,
                                                 float* d, int32_t* ids, bool seeds, Stopwatch& sw, int& n_dist) {
  const int lane = threadIdx.x & 31, s = lane % kGroup;
  const int t = (threadIdx.x >> 5) + kWarps * (lane / kGroup);
  const int src = t & 31;
  const bool hi = t >= 32;
  const int32_t id0 = __shfl_sync(kAll, c.id[0], src), id1 = __shfl_sync(kAll, c.id[1], src);
  const int k0 = __shfl_sync(kAll, c.slot[0], src), k1 = __shfl_sync(kAll, c.slot[1], src);
  const int32_t id = hi ? id1 : id0;
  const int k = hi ? k1 : k0;  // its place among the taken candidates (-1: not taken)
  const bool load = k >= 0 && id < g.n_rows;
  const int units = q.units;
  const uint4* row = reinterpret_cast<const uint4*>(g.vectors) + static_cast<int64_t>(load ? id : 0) * units;
  uint4 v[kHold];
#pragma unroll
  for (int j = 0; j < kHold; ++j) {
    const int u = s + kGroup * j;
    v[j] = load && u < units ? __ldg(row + u) : make_uint4(0u, 0u, 0u, 0u);
  }
  const float norm = METRIC == kBqCosine && load && s == 0 ? __ldg(g.norms + id) : 0.f;
  const uint32_t ok0 = __shfl_sync(kAll, c.ok[0], src), ok1 = __shfl_sync(kAll, c.ok[1], src);
  const bool ok = k >= 0 && (hi ? ok1 : ok0) != 0;
  int pc = 0;
#pragma unroll
  for (int j = 0; j < kHold; ++j) pc += popc_xor(q.u[j], v[j]);
  for (int u = kGroup * kHold + s; load && u < units; u += kGroup) pc += popc_xor(lanes4(q.lanes + 4 * u), __ldg(row + u));
  sw.lap(kRows);
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) pc += __shfl_xor_sync(kAll, pc, off);
  const bool lead = s == 0 && k >= 0;
  if (lead) {
    float dist = inf();
    if (ok && id >= g.n_rows) {
      dist = nan_f();
    } else if (ok) {
      dist = packed_distance<METRIC>(pc, 4 * units, q_norm * norm);
    }
    d[k] = dist;
    if (ids != nullptr) ids[k] = (ok && (!seeds || dist < inf())) ? id : -1;
    if (ok && id < g.n_rows) mark(g, id);
  }
  const unsigned counted = __ballot_sync(kAll, lead && ok);
  if (lane == 0) n_dist += __popc(counted);
  sw.lap(kReduce);
}

// What a hop's distances take of the query: the staged query in shared
// memory (dense rows), or the registers of the packed form.
template <typename ROW>
struct QueryOf {
  using type = const float4*;
};
template <>
struct QueryOf<uint32_t> {
  using type = const PackedQuery&;
};
template <typename ROW>
using QueryArg = typename QueryOf<ROW>::type;

template <typename ROW>
__device__ __forceinline__ QueryArg<ROW> query_of(const float4* q4, const PackedQuery& pq) {
  if constexpr (kPacked<ROW>) {
    return pq;
  } else {
    return q4;
  }
}

// The distances of a hop's taken candidates, by the row type's form.
template <typename ROW, int METRIC, bool SCALE>
__device__ __forceinline__ void hop_distances(const Graph& g, const Cands& c, QueryArg<ROW> q, float q_norm,
                                              unsigned char* slots, int S, float* d, int32_t* ids, bool seeds,
                                              Stopwatch& sw, int& n_dist) {
  if constexpr (kPacked<ROW>) {
    packed_distances<METRIC>(g, c, q, q_norm, d, ids, seeds, sw, n_dist);
  } else {
    warp_distances<ROW, METRIC, SCALE>(g, c, q, q_norm, slots, S, d, ids, seeds, sw, n_dist);
  }
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

// The block's scratch for a hop (shared memory).
struct Scratch {
  unsigned char* slots;  // this warp's S slots of the staging buffer
  int S;
  float* d;         // [cap] the taken candidates' distances
  int32_t* id;      // [cap] their ids (-1 where not kept)
  unsigned* masks;  // [2 x kWarps] the warps' finds in the pool (take_fresh)
};

// before: (da, ka) comes before (db, kb) in (distance as torch.sort, position).
__device__ __forceinline__ bool before(float da, int ka, float db, int kb) {
  return key_lt(da, db) || (!key_lt(db, da) && ka < kb);
}

// Merge the n candidates at src[0..n) (nullptr: none) into the pool `cur`,
// writing the result to `nxt` with pool entry `expanded` (-1: none) marked;
// `seeds`: the seeding rules (a seed at +inf keeps no id). Starts and ends
// with the block synchronised.
template <typename ROW, int METRIC, bool SCALE>
__device__ void admit(const Graph& g, QueryArg<ROW> q, float q_norm, const int32_t* src, int n, bool seeds, Pool cur,
                      Pool nxt, int ef, int efp, int expanded, const Scratch& s, Stopwatch& sw, int& n_dist) {
  const int tid = threadIdx.x, lane = tid & 31;
  Cands c;
  load_cands(g, src, n, lane, c);
  sw.wait_for(c.id[0]);
  sw.lap(kLinks);
  take_fresh(c, n, cur.id, efp, s.masks, lane, sw);
  sw.lap(kDedup);
  if (c.n > 0) {
    hop_distances<ROW, METRIC, SCALE>(g, c, q, q_norm, s.slots, s.S, s.d, s.id, seeds, sw, n_dist);
    block_sync(sw);
  }
  // the rank, by the last threads: candidate e comes after the r
  // candidates before it in (distance, position) order
  const int e = kThreads - 1 - tid;
  int r = 0;
  float de = 0.f;
  if (e < c.n) {
    de = s.d[e];
    for (int j = 0; j < c.n; ++j) r += before(s.d[j], j, de, e);
  }
  sw.lap(kRank);
  // the merge: an entry's place is its own position plus the entries of
  // the other list before it, the pool's first on ties; keep ef
  for (int i = tid; i < ef; i += kThreads) {
    const float d = cur.d[i];
    int at = i;
    for (int j = 0; j < c.n; ++j) at += key_lt(s.d[j], d);
    if (at < ef) {
      nxt.d[at] = d;
      nxt.id[at] = cur.id[i];
      nxt.exp[at] = i == expanded ? 1 : cur.exp[i];
    }
  }
  if (e < c.n) {
    const int at = r + count_le(cur.d, ef, de);
    if (at < ef) {
      nxt.d[at] = de;
      nxt.id[at] = s.id[e];
      nxt.exp[at] = 0;
    }
  }
  sw.lap(kMerge);
  block_sync(sw);
}

// The position of the pool's first unexpanded entry (INT_MAX: none), found
// by each warp alone (the same in every lane). It is torch.argmin's choice
// as well: the pool is sorted and never holds a NaN (above).
__device__ __forceinline__ int first_unexpanded(Pool p, int ef, int lane) {
  for (int i0 = 0; i0 < ef; i0 += 32) {
    const int i = i0 + lane;
    const unsigned m = __ballot_sync(kAll, i < ef && p.exp[i] == 0 && p.id[i] != -1);
    if (m) return i0 + __ffs(m) - 1;
  }
  return INT_MAX;
}

struct BeamArgs {
  Graph g;
  const float* q;   // [B, dim] f32
  const float* qn;  // [B]
  const int32_t* start;  // [B, n_start]
  int n_start;
  int level;
  int width;  // link columns a hop reads
  int cap;    // candidates a hop takes: a multiple of 32, >= width, <= kMaxCap
  int rows;   // rows of the staging buffer: kWarps x S
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
  long long* clocks;  // nullptr, or [B, kStages] cycles of thread 0 per stage, added to
};

__host__ __device__ __forceinline__ int pad4(int ef) { return (ef + 3) / 4 * 4; }

// The beam's shared memory in the kernel's layout: query | staging rows |
// clocks | 2 pools of (d, id, exp) x efp | d, id [cap] | masks [2 x kWarps].
__host__ __device__ __forceinline__ size_t beam_bytes(int dim, int row_bytes, int ef, int cap, int rows) {
  return 4 * static_cast<size_t>(dim) + static_cast<size_t>(rows) * row_bytes + kClockBytes +
         24 * static_cast<size_t>(pad4(ef)) + 8 * static_cast<size_t>(cap) + 8 * kWarps;
}

template <typename ROW, int METRIC, bool SCALE>
__global__ void __launch_bounds__(kThreads, 2) beam_search_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ef = a.ef, efp = pad4(ef), cap = a.cap,
            dim = a.g.dim;
  const int row_bytes = dim * static_cast<int>(sizeof(ROW)), S = a.rows / kWarps;
  float* sq = reinterpret_cast<float*>(smem);
  unsigned char* stage = reinterpret_cast<unsigned char*>(sq + (kPacked<ROW> ? 0 : dim));
  long long* clk = reinterpret_cast<long long*>(stage + static_cast<size_t>(a.rows) * row_bytes);
  float* f = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(clk) + kClockBytes);
  Pool pool[2] = {{f, reinterpret_cast<int32_t*>(f + efp), reinterpret_cast<int32_t*>(f + 2 * efp)},
                  {f + 3 * efp, reinterpret_cast<int32_t*>(f + 4 * efp), reinterpret_cast<int32_t*>(f + 5 * efp)}};
  float* hop_d = f + 6 * efp;
  int32_t* hop_id = reinterpret_cast<int32_t*>(hop_d + cap);
  const Scratch s{stage + static_cast<size_t>(warp) * S * row_bytes, S, hop_d, hop_id,
                  reinterpret_cast<unsigned*>(hop_id + cap)};

  [[maybe_unused]] PackedQuery pq;
  if constexpr (kPacked<ROW>) {
    pq = packed_query(a.q, b, dim / 4);
  } else {
    stage_query<ROW, METRIC>(sq, a.q, b, dim);
  }
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  const float q_norm = METRIC == kCosine || METRIC == kBqCosine ? __ldg(a.qn + b) : 0.f;
  float* gd = a.pool_d + b * ef;
  int32_t* gi = a.pool_id + b * ef;
  int32_t* ge = a.pool_exp + b * ef;
  for (int i = tid; i < efp; i += kThreads) {
    const bool in = i < ef;
    for (int p = 0; p < 2; ++p) {
      pool[p].d[i] = in && a.seeded ? gd[i] : inf();
      pool[p].id[i] = in && a.seeded ? gi[i] : -1;
      pool[p].exp[i] = in && a.seeded ? ge[i] : 0;
    }
  }
  if (tid < kClockBytes / 8) clk[tid] = 0;
  __syncthreads();
  Stopwatch sw = stopwatch(clk, a.clocks != nullptr);
  int cur = 0, n_dist = 0, hops = 0;
  bool active = false;
  // the seeds' chunks, then the hops: one call of admit (one copy of its
  // code in the loop, which the instruction cache holds)
  for (int c0 = a.seeded ? a.n_start : 0;;) {
    const bool seeds = c0 < a.n_start;
    const int32_t* src;
    int n, p = -1;
    if (seeds) {
      src = a.start + b * a.n_start + c0;
      n = min(cap, a.n_start - c0);
      c0 += cap;
    } else {
      p = first_unexpanded(pool[cur], ef, lane);
      const float exp_d = p < ef ? pool[cur].d[p] : inf();
      active = exp_d <= pool[cur].d[ef - 1] && exp_d < inf();
      if (!active || hops == a.budget) break;
      src = link_row(a.g, a.level, pool[cur].id[p]);
      n = a.width;
      ++hops;
      sw.lap(kEntry);
    }
    admit<ROW, METRIC, SCALE>(a.g, query_of<ROW>(q4, pq), q_norm, src, n, seeds, pool[cur], pool[cur ^ 1], ef, efp, p,
                              s, sw, n_dist);
    cur ^= 1;
  }
  for (int i = tid; i < ef; i += kThreads) {
    gd[i] = pool[cur].d[i];
    gi[i] = pool[cur].id[i];
    ge[i] = pool[cur].exp[i];
  }
  if (lane == 0 && n_dist > 0) atomicAdd(a.n_dist + b, n_dist);
  if (tid == 0) {
    a.hops[b] += hops;
    a.active[b] = active ? 1 : 0;
    if (a.clocks != nullptr) {
      for (int st = 0; st < kStages; ++st) a.clocks[b * kStages + st] += clk[st];
    }
  }
}

struct GreedyArgs {
  Graph g;
  const float* q;
  const float* qn;
  const int32_t* entry;  // [n_entry] entry points (-1 padded)
  int n_entry;
  int rows;  // rows of the staging buffer: kWarps x S
  size_t smem;  // dynamic shared memory: ops/search_cuda.py:greedy_shared
  int from_level;
  int to_level;  // levels from_level .. to_level, descending (none if from < to)
  int max_steps;  // steps a row may take a level in this launch
  int init;  // != 0: start from the entry points, every level from improved = 1
  int32_t* cur;      // [B] the slot (in/out)
  float* cur_d;      // [B] its distance (in/out)
  uint8_t* improved;  // [B] the last step improved (in/out; read where init == 0)
  int32_t* steps;    // [B] steps taken, added to
  int32_t* n_dist;   // [B] distances computed, added to
  long long* clocks;  // nullptr, or [B, kStages] cycles of thread 0 per stage, added to
};

// The greedy descent's shared memory: query | staging rows | clocks | 2 x kMaxCap distances.
__host__ __device__ __forceinline__ size_t greedy_bytes(int dim, int row_bytes, int rows) {
  return 4 * static_cast<size_t>(dim) + static_cast<size_t>(rows) * row_bytes + kClockBytes + 8 * kMaxCap;
}

// torch.argmin over d[0..n) (the first NaN, else the first of equal
// minima) by each warp alone → its position (0 where n == 0) and value
// (+inf where n == 0).
__device__ __forceinline__ int warp_argmin(const float* d, int n, int lane, float& best_d) {
  int best = INT_MAX;
  float bd = inf();
  for (int k = lane; k < n; k += 32) {
    const float v = d[k];
    if (best == INT_MAX || argmin_lt(v, bd)) {
      best = k;
      bd = v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kAll, best, off);
    const float od = __shfl_xor_sync(kAll, bd, off);
    if (ob != INT_MAX && (best == INT_MAX || argmin_lt(od, bd) || (!argmin_lt(bd, od) && ob < best))) {
      best = ob;
      bd = od;
    }
  }
  best_d = bd;
  return best == INT_MAX ? 0 : best;
}

template <typename ROW, int METRIC, bool SCALE>
__global__ void __launch_bounds__(kThreads, 2) greedy_descend_kernel(GreedyArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, dim = a.g.dim;
  const int row_bytes = dim * static_cast<int>(sizeof(ROW)), S = a.rows / kWarps;
  float* sq = reinterpret_cast<float*>(smem);
  unsigned char* stage = reinterpret_cast<unsigned char*>(sq + (kPacked<ROW> ? 0 : dim));
  long long* clk = reinterpret_cast<long long*>(stage + static_cast<size_t>(a.rows) * row_bytes);
  float* cd = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(clk) + kClockBytes);  // [2][kMaxCap]
  unsigned char* slots = stage + static_cast<size_t>(warp) * S * row_bytes;

  [[maybe_unused]] PackedQuery pq;
  if constexpr (kPacked<ROW>) {
    pq = packed_query(a.q, b, dim / 4);
  } else {
    stage_query<ROW, METRIC>(sq, a.q, b, dim);
  }
  if (tid < kClockBytes / 8) clk[tid] = 0;
  __syncthreads();
  Stopwatch sw = stopwatch(clk, a.clocks != nullptr);
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  const float q_norm = METRIC == kCosine || METRIC == kBqCosine ? __ldg(a.qn + b) : 0.f;
  int n_dist = 0, steps = 0, par = 0;  // par: the distance buffer of the next step
  int32_t cur;
  float cur_d;
  if (a.init) {
    // the entry points: torch.argmin over those >= 0 and node_ok (the
    // others at +inf), in chunks; a later chunk wins only if it comes
    // strictly first in argmin's order
    int best = -1;
    float best_d = inf();
    for (int c0 = 0; c0 < a.n_entry; c0 += kMaxCap) {
      const int n = min(kMaxCap, a.n_entry - c0);
      Cands c;
      load_cands(a.g, a.entry + c0, n, lane, c);
      const bool take[2] = {c.id[0] >= 0, c.id[1] >= 0};
      compact(c, take, lane);
      float cd_best = inf();
      int at = 0;  // the chunk's argmin; +inf (none, or all at +inf): its first entry
      if (c.n > 0) {
        float* d = cd + par * kMaxCap;
        hop_distances<ROW, METRIC, SCALE>(a.g, c, query_of<ROW>(q4, pq), q_norm, slots, S, d, nullptr, false, sw,
                                          n_dist);
        block_sync(sw);
        par ^= 1;
        const int k = warp_argmin(d, c.n, lane, cd_best);
        if (cd_best != inf()) {
          int h;
          const int src = holder(c, k, h);
          at = 32 * h + src;
        }
      }
      if (best < 0 || argmin_lt(cd_best, best_d)) {
        best = c0 + at;
        best_d = cd_best;
      }
    }
    cur = __ldg(a.entry + best);  // the entry point itself, as torch's gather takes it
    cur_d = best_d;
    sw.lap(kEntry);
  } else {
    cur = a.cur[b];
    cur_d = a.cur_d[b];
  }
  bool improved = a.init ? true : a.improved[b] != 0;
  for (int level = a.from_level; level >= a.to_level; --level) {
    if (a.init) improved = true;
    for (int st = 0; improved && st < a.max_steps; ++st) {
      Cands c;
      load_cands(a.g, link_row(a.g, level, cur), a.g.wu, lane, c);
      sw.wait_for(c.id[0]);
      sw.lap(kLinks);
      const bool take[2] = {c.id[0] >= 0, c.id[1] >= 0};
      compact(c, take, lane);
      sw.lap(kDedup);
      float best_d = inf();
      int32_t best_id = -1;
      if (c.n > 0) {
        // the distances alternate between two buffers, so that the next
        // step writes the other while a warp may still read this one
        float* d = cd + par * kMaxCap;
        hop_distances<ROW, METRIC, SCALE>(a.g, c, query_of<ROW>(q4, pq), q_norm, slots, S, d, nullptr, false, sw,
                                          n_dist);
        block_sync(sw);
        par ^= 1;
        const int k = warp_argmin(d, c.n, lane, best_d);
        int h;
        const int src = holder(c, k, h);
        best_id = pick(c.id, h, src);
        sw.lap(kRank);
      }
      improved = best_d < cur_d;
      if (improved) cur = best_id;
      cur_d = improved ? best_d : (isnan(best_d) ? best_d : cur_d);  // torch.minimum
      ++steps;
      sw.lap(kMerge);
    }
  }
  if (lane == 0 && n_dist > 0) atomicAdd(a.n_dist + b, n_dist);
  if (tid == 0) {
    a.cur[b] = cur;
    a.cur_d[b] = cur_d;
    a.improved[b] = improved ? 1 : 0;
    a.steps[b] += steps;
    if (a.clocks != nullptr) {
      for (int s = 0; s < kStages; ++s) a.clocks[b * kStages + s] += clk[s];
    }
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
struct BeamLaunch {
  static cudaError_t run(const BeamArgs& a, int batch, cudaStream_t stream) {
    static std::atomic<uint64_t> allowed_on{0};
    return launch_with(beam_search_kernel<ROW, METRIC, SCALE>, a, batch, a.smem, allowed_on, stream);
  }
};

template <typename ROW, int METRIC, bool SCALE>
struct GreedyLaunch {
  static cudaError_t run(const GreedyArgs& a, int batch, cudaStream_t stream) {
    static std::atomic<uint64_t> allowed_on{0};
    return launch_with(greedy_descend_kernel<ROW, METRIC, SCALE>, a, batch, a.smem, allowed_on, stream);
  }
};

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
  // packed rows: one form, the metric in packed_distance's epilogue
  static cudaError_t packed_of(const ARGS& a, int batch, int metric, cudaStream_t stream) {
    switch (metric) {
      case kHamming: return LAUNCH<uint32_t, kHamming, false>::run(a, batch, stream);
      case kBqCosine: return LAUNCH<uint32_t, kBqCosine, false>::run(a, batch, stream);
      case kBqEuclidean: return LAUNCH<uint32_t, kBqEuclidean, false>::run(a, batch, stream);
      case kBqManhattan: return LAUNCH<uint32_t, kBqManhattan, false>::run(a, batch, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  static cudaError_t run(const ARGS& a, int batch, int metric, int row_type, bool scale_rows, cudaStream_t stream) {
    switch (row_type) {
      case kRowF32: return row_of<float>(a, batch, metric, scale_rows, stream);
      case kRowBf16: return row_of<__nv_bfloat16>(a, batch, metric, scale_rows, stream);
      case kRowInt8: return row_of<int8_t>(a, batch, metric, scale_rows, stream);
      case kRowPacked: return scale_rows ? cudaErrorInvalidValue : packed_of(a, batch, metric, stream);
      default: return cudaErrorInvalidValue;
    }
  }
};

int row_size(int row_type) { return row_type == kRowBf16 ? 2 : row_type == kRowInt8 ? 1 : 4; }

// The rows must be whole 16-byte units from a 16-byte aligned base, as the
// gather kernel's staged design (dense rows) and pair design (packed rows)
// need (ops/search_cuda.py checks).
bool rows_ok(const Graph& g, int row_type) {
  return row_type >= kRowF32 && row_type <= kRowPacked &&
         (static_cast<int64_t>(g.dim) * row_size(row_type)) % 16 == 0 && reinterpret_cast<uintptr_t>(g.vectors) % 16 == 0;
}

// Dense rows stage in whole warps' slots; packed rows stage nothing.
bool staging_ok(int rows, int row_type) {
  return row_type == kRowPacked ? rows == 0 : rows >= kWarps && rows % kWarps == 0;
}

// The query's f32 elements in shared memory: none for packed rows (their
// lanes stay in registers).
int staged_query(int dim, int row_type) { return row_type == kRowPacked ? 0 : dim; }

}  // namespace

// The graph (every launch): vectors [n_rows, dim] (row_type 0 f32, 1 bf16,
// 2 int8, 3 packed 32-bit lanes), norms [n_rows], links0 [n_pad, w0], upper [L, u_pad, wu],
// slot_rows [L, n_pad], node_ok [n_ok] (bytes), L = n_levels; seen:
// nullptr, or n_rows + n_pad x (1 + L) + L x u_pad bytes (mark()); metric 0 cosine,
// 1 euclidean, 2 manhattan for row types 0-2, 3 hamming, 4 bq cosine, 5 bq
// euclidean, 6 bq manhattan for row type 3; scale_rows != 0 scales int8 rows by norms[row]
// (euclidean / manhattan). q [batch, dim] f32 (lanes for row type 3), qn [batch]; clocks: nullptr
// or [batch, 8] int64 (Stage), added to.
#define GRAPH_PARAMS                                                                                              \
  const void *vectors, const float *norms, long long n_rows, int dim, const int32_t *links0, int w0,              \
      const int32_t *upper, long long u_pad, int wu, const int32_t *slot_rows, long long n_pad,                   \
      const uint8_t *node_ok, long long n_ok, long long n_levels, uint8_t *seen
#define GRAPH_ARGS \
  Graph { vectors, norms, n_rows, dim, links0, w0, upper, u_pad, wu, slot_rows, n_pad, node_ok, n_ok, n_levels, seen }

// One beam at `level` for each of `batch` queries: seeded from start
// [batch, n_start] (seeded == 0) or continued from the pool (seeded != 0),
// at most `budget` hops a row. cap, rows and smem: the candidates a hop
// takes, the staging buffer's rows (0 for packed rows) and the block's
// shared memory, from ops/search_cuda.py:beam_shared. pool_* [batch, ef] out (in where seeded);
// hops and n_dist [batch] are added to; active [batch] out.
extern "C" int search_beam(GRAPH_PARAMS, const float* q, const float* qn, int batch, const int32_t* start, int n_start,
                           int level, int ef, int cap, int rows, long long smem, int budget, int seeded, float* pool_d,
                           int32_t* pool_id, int32_t* pool_exp, int32_t* hops, int32_t* n_dist, uint8_t* active,
                           long long* clocks, int metric, int row_type, int scale_rows, void* stream) {
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Graph g = GRAPH_ARGS;
  const int width = level == 0 ? w0 : wu;
  if (!rows_ok(g, row_type) || ef < 1 || budget < 0 || cap < width || cap % 32 != 0 || cap > kMaxCap ||
      !staging_ok(rows, row_type) || smem < 0 ||
      static_cast<size_t>(smem) < beam_bytes(staged_query(dim, row_type), dim * row_size(row_type), ef, cap, rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BeamArgs a{g, q, qn, start, n_start, level, width, cap, rows, static_cast<size_t>(smem), ef, budget, seeded,
                   pool_d, pool_id, pool_exp, hops, n_dist, active, clocks};
  const cudaError_t err = Dispatch<BeamLaunch, BeamArgs>::run(a, batch, metric, row_type, scale_rows != 0,
                                                              static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The greedy descent of `batch` queries through levels from_level ..
// to_level (>= 1), at most max_steps steps a level: from the entry points
// [n_entry] (init != 0) or from cur / cur_d / improved. rows and smem: the
// staging buffer's rows (0 for packed rows) and the block's shared memory,
// from ops/search_cuda.py:greedy_shared. cur, cur_d and improved [batch] out;
// steps and n_dist [batch] are added to.
extern "C" int search_greedy(GRAPH_PARAMS, const float* q, const float* qn, int batch, const int32_t* entry,
                             int n_entry, int from_level, int to_level, int max_steps, int init, int rows,
                             long long smem, int32_t* cur, float* cur_d, uint8_t* improved, int32_t* steps,
                             int32_t* n_dist, long long* clocks, int metric, int row_type, int scale_rows,
                             void* stream) {
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Graph g = GRAPH_ARGS;
  if (!rows_ok(g, row_type) || (init && n_entry < 1) || (from_level >= to_level && to_level < 1) || wu > kMaxCap ||
      !staging_ok(rows, row_type) || smem < 0 ||
      static_cast<size_t>(smem) < greedy_bytes(staged_query(dim, row_type), dim * row_size(row_type), rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GreedyArgs a{g, q, qn, entry, n_entry, rows, static_cast<size_t>(smem), from_level, to_level, max_steps, init,
                     cur, cur_d, improved, steps, n_dist, clocks};
  const cudaError_t err = Dispatch<GreedyLaunch, GreedyArgs>::run(a, batch, metric, row_type, scale_rows != 0,
                                                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
