"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the ``nvidia-smi`` name and power limit, TF32 off;
2. build: the gather-distance kernel and the search kernels, compiled
   with nvcc from ``hannoy_tpu_torch/csrc/gather_distances.cu`` and
   ``hannoy_tpu_torch/csrc/search.cu`` (one nvcc each, started together),
   and the store library, compiled with g++ from
   ``hannoy_tpu_torch/store/native/kvstore.cpp``;
3. kernel against its plain twin on a random [100000, 768] store, at the
   main path's shapes — build hop [4096, 32], search hop [256, 32], the
   bulk build's random candidates [8192, 8], the upper-layer rows of
   ``fill_link_dists`` [4096, 16] — for cosine (atol 1e-5),
   euclidean and manhattan (rtol 1e-5), and the deletion repair's
   spliced candidates [512, 64] for cosine and euclidean; then the same
   store in the bf16 and int8 tiers (the port's encoders) for the three
   metrics, and a random store of 768-bit packed rows for hamming and the
   three binary quantized metrics, at the first three shapes (and the
   tiers' cosine at [512, 64] too; packed rows also at the BQ wave hop of
   narrower waves [1024, 32] and the descent's [128, 32], and on a second
   store of 1,000,000 rows, 96 MB, past the L2 cache, at [4096, 32] and
   [256, 32] for hamming and BQ cosine; f32 cosine rows also on a store of
   1,000,000 rows, 3.07 GB, past 2**31 bytes, at the search hop [256, 32]
   and at the other shapes phase 12 launches) (f32 cosine: 1e-5 absolute;
   tiers: 1e-5 relative, summation order only; packed: bit-equal, BQ
   cosine 1.2e-7 absolute).
   For each packed store and metric the launch floor — one pair a launch,
   [1, 1], timed the same way — is printed on a line of its own and beside
   each packed case.
   Every case also checks that an index past the store gives NaN and, for
   the tiers, a query gathered from the store (a build's), which under a
   difference metric must find its own row at exactly 0. Each time is
   one pair of CUDA events around many back-to-back launches, over the
   count, with the candidate rows rotating through 8 index sets so that
   they come from device memory, not the 50 MB L2 cache (median of 5 such
   pairs); beside it the least time the card could take (its bound: the
   distinct rows the indices touch, read once) and the per-pair floor
   (each pair's row read once);
4. the insertion-wave path at 100k × 768 cosine (``bench.py``'s data,
   seed 42): stage → ``build_graph(bulk=False)`` (efc 48, wave 4096) →
   ``check_validity`` → ``to_device`` → ``hnsw_search`` at ef 50 and 100,
   recall@10 against ``flat_topk`` (required >= 0.93 at ef=100); then
   the same build four times more, in turns with its searches' loops on
   the search kernels and on the host loop (kernels, host loop, host
   loop, kernels: seconds, and whether the links are the same);
5. the default build on the same data: ``BuildOptions`` with ``bulk``
   left at None, which at 100k fresh items is the bulk (cluster-blocked)
   path; then the same checks, plus the peak device memory. It fails if
   the bulk path did not run. Then the same build twice more: once with
   every span fenced by ``torch.cuda.synchronize()`` for the time of each
   span, once under ``torch.profiler`` for the device's idle share;
6. the API path on the same data, in a temporary directory, through
   ``Database(path, Metric.COSINE)`` (device ``"cuda"``, the native store,
   ``map_size`` 4 GiB): ``writer.add_items`` → ``builder(seed=42).build()``
   (must take the bulk path) → ``commit_rw_txn`` → ``Reader.by_vecs`` of
   the 256 queries at ef 100 → ``close`` → a new ``Database`` and Reader
   (100,000 items, the same answers item for item, recall@10 >= 0.93
   against ``flat_topk``, ``assert_validity``) → append 2,000 items from
   the same centres → ``build()`` (incremental, from a fork of the graph the
   Reader loaded, through ``fill_link_dists``) → commit → a new Reader (102,000 items, each
   appended vector finds itself first in >= 0.99 of rows at ef 100).
   Every span of this phase is fenced, and each carries the kernel
   launches made inside it. ``Reader.by_vecs`` is timed beside
   ``hnsw_search`` on the Reader's own device graph: the gap is the API's
   host cost.

7. the packed metrics through the API at the same size: ``Database(path,
   Metric.BQ_COSINE)`` → ``add_items`` of the 100k × 768 → ``build()``
   (must take the bulk path) → commit → ``by_vecs`` at ef 100 → close →
   reopen → the same distances for every query (equal distances tie, and
   ties may name other items once the link rows come back from the store
   in id order), ``assert_validity``, tie-aware recall@10
   >= 0.93 against ``flat_topk`` under the same metric; a HAMMING build of
   the first 20,000 items by waves (``bulk(False)``, wave 4096), searched
   and held to the same bar; and the migration: a cosine database of the
   100k → ``prepare_changing_distance(Metric.BQ_COSINE)`` (the fast path:
   the links records must all survive the prepare) → ``build()`` →
   commit → search, recall as above; and HAMMING at 1,536 bits on 100k
   items of 1,536 dimensions (``bench_data``, seed 44) with M 16 and efc
   64, the benchmark's hamming cell's shape: build → commit → search,
   recall as above, then phase 13 on it;
8. the storage tiers through the API at the same size: cosine with
   ``tier="bf16"`` and ``tier="int8"``, euclidean with ``"raw"``, ``"bf16"``
   and ``"int8"``: add → build → commit → Reader → ``by_vecs`` at ef 100,
   recall@10 by id against the exact f32 top-10, beside what an exact
   scan of the tier's rows keeps of that answer (the encoding's own
   ceiling) and the recall against that scan (>= 0.93; against f32 at
   least 0.93 of the ceiling), and the device bytes the Reader's
   serve-only upload holds and peaks at; then euclidean ``"raw"`` built by
   waves (``bulk(False)``), and both euclidean ``"raw"`` builds searched at
   ef 100 and 200 as well: the triage of euclidean f32 recall (the graph,
   the ef, or the bulk candidates);
9. deletions and filtered search on the phase-6 database (102,000 items):
   delete 2,000 items (seed 44), every entry point among them, and add
   2,000 (seed 45) → ``build()`` (the repair ``repair_deletions``, one
   span per level with its owners and blocks, then the waves and
   ``inbound_recheck``) → commit → ``assert_validity``, no deleted id in
   any of the 256 answers, recall@10 >= 0.93 at ef 100 against
   ``flat_topk`` over the survivors, self-hit of the new items >= 0.99 →
   close → reopen → the same answers; then ``by_vecs`` with candidate
   sets of 0.5%, 1%, 10% and 50% of the items, each holding 100 deleted
   ids too (below 1,000 candidates the exact linear scan answers, which
   must reach recall 1.0; the others take the filtered beam, the 50% set
   held to 0.93): every answer a live candidate, every row full, QPS and
   recall@10 against the masked ``flat_topk``; and ``Reader.by_items`` of
   256 present and 2 absent items (``None`` there, no item returned for
   itself, recall@10 >= 0.93 against ``flat_topk`` without the item; one
   launch of the beam kernel, none of the gather kernel);
   then cancellation: ``by_vectors``, ``by_items`` and a filtered
   ``by_vectors`` at 10% with a cancel that never fires (the uncancelled
   answers, id for id and distance for distance) and with one that fires
   at its 1st, 2nd and 4th check (``did_cancel`` on every row, live ids
   only, sorted, each distance within 1e-5 of ``flat_topk``'s), and a
   ``builder().cancel(fn).build()`` over 500 added and 100 deleted items
   that fires at its 3rd check: ``BuildCancelled``, ``abort_rw_txn``, and a
   new Reader gives the answers of before;
10. sharded build and serving on the one card: 100,000 × 768 cosine
   (``bench_data``, seed 42, n/256 centres) in 4 shards of 25k, all on
   ``cuda:0``, in a temporary directory: ``ShardedWriter`` add →
   ``build(spmd=False)`` (every shard by the bulk path) → commit →
   ``ShardedReader`` → ``assert_validity`` → search of the 256 queries at
   ef 100 (recall@10 >= 0.93 against ``flat_topk`` over all 100k; QPS
   beside one shard's ``Reader.by_vecs``; device bytes per shard) → append
   2,000 (seed 43) and delete 400, every shard's entry points among them
   → the lockstep build (``spmd_wave`` spans) → commit → a new
   ``ShardedReader``: no deleted id, self-hit >= 0.99, recall >= 0.93 → a
   lockstep build whose cancel fires at its 2nd check raises
   ``BuildCancelled``, and after the abort the answers are those of before;
11. the build options on phase 4/5's data, each between two default
   builds of its path: the wave path (``bulk=False``, wave 4096, the first
   ``N_OPTION_WAVE`` = 25,000 items) with ``beam_expand=2``,
   ``traverse=24``, ``link_slack=16`` and ``chain_seeding`` (at least one
   chained wave); the bulk path (the first ``N_OPTION_BULK`` = 50,000
   items) with ``bulk_renumber`` (the 256 answers equal the default
   build's by item id and distance, and both graphs searched in turns for
   QPS),
   ``bulk_backbone=False, bulk_upper=1`` (recall printed only),
   ``backbone_flat=False`` and ``bulk_init="random"``: each build timed
   with its waves, chained waves, beam iterations and kernel launches,
   ``check_validity``, recall@10 at ef 100 >= 0.93 against ``flat_topk``;
   then phase 10's database, reopened: +2,000 / -400 (every shard's entry
   points among them) by the lockstep build with ``link_slack=8``
   (``prune_slack_rows`` and the stranding re-check per shard) →
   validity, no deleted id, recall, self-hit >= 0.99;
12. the main path at the size its users run: 1,000,000 x 768 cosine
   (``bench_data``, seed 42, n/256 centres; m 16, ef_construction 96, as
   ``bench.py`` sets it above 200k items) through ``Database`` (native
   store, ``map_size`` 8 GiB) / ``Writer`` / ``Reader`` in a temporary
   directory: ``add_items`` → ``build()`` (the bulk path with the flat
   backbone: its k-means clusters, backbone waves and peak device memory
   above the start) → commit → ``by_vecs`` of the 256 queries at ef 50,
   100 and 200 (QPS, the median of single calls; tie-aware recall@10
   against ``flat_topk`` over every item, >= 0.93 at ef 100) → close →
   reopen → ``Reader.open`` (load and upload apart; device bytes per item)
   → the same answers, ``assert_validity`` → append 2,000 → ``build()``
   (``fork_graph``, ``fill_link_dists``, waves) → commit → self-hit >= 0.99
   and ``assert_validity`` on all 1,002,000 items. The widths of the
   search's pooled layer-1 descent and of the append's level-0 insertion
   seeds are read from the port's spans (``reader_search``,
   ``insert_seeds``) and must be 32. Every span is fenced and carries its
   kernel launches, and every launch must take the staged design.

13. the search kernels (``csrc/search.cu``: the beam search and the
   greedy descent, each one launch for a batch), which serve every search
   of dense rows, and of packed rows of whole 16-byte units, on the card: first, on stores built on the card that no
   other phase holds — one row (ef 10), 40 items searched at ef 64 (a
   pool that never fills), 3,000 euclidean and 3,000 cosine items with NaN
   rows on the walks and then at an entry point — the kernels equal the
   host loop
   (``beam.beam_search_loop``, ``greedy_descend_loop``, called directly)
   and their plain versions (``search_cuda.*_rowwise``) bit for bit; then
   on the Readers of phase 6 (100k f32 cosine), of phase 7 (100k BQ cosine
   at 768 bits, and 100k hamming at 1,536 bits with M 16 and efc 64, the
   shape of the benchmark's hamming cell: the packed form), of every
   phase-8 cell
   (bf16 and int8 cosine, euclidean raw / bf16 / int8, euclidean raw by
   waves) and of phase 12 (1M f32 cosine): ``hnsw_search`` at ef 100 by
   at most 3 launches of them and none of the gather kernel, equal bit for
   bit to the host loop on the batch and to the plain versions on its
   first 16 rows (which are also the batch's rows: a row is searched on
   its own), and with the plain twin's distances 99% of the slots within
   1e-5 relative; the same at ef 512 and (phases 6 and 12) on the graph
   uploaded with 8 empty layer-0 columns; each launch of that search timed
   on its own inputs (CUDA-graph replay, as phase 3 times; and one call
   between CUDA events; at phases 6 and 12 the layer-0 beam also at ef 50
   and 200) beside the host loop's call, its
   bound (each distinct store row it computed a distance to, each
   distinct link row and slot-row entry its hops read, the queries, seeds
   and pools, over the HBM rate: one more call of it marks what it reads,
   ``search_cuda.seen_buffer``) and its per-pair floor (every distance's
   row and every hop's link row read anew, from its per-row counters),
   hops per row and µs per hop, the split of a hop (one more call with
   ``clocks=``: the cycles thread 0 of each block spent in each stage,
   per hop), and once per form (f32 cosine at 1M; packed rows on the
   1,536-bit hamming Reader) the
   plain versions of the greedy descent and the layer-0 beam on the
   batch's first 16 rows; and at phases 6 and 12 ``by_vecs`` in turns (kernels,
   host loop, host loop, kernels: the same answers at every ef, QPS) with
   one profiled window of each (5 calls in a row: the idle share). Every
   ``hnsw_search`` and ``descend_for_slots`` of phases 4-12 is watched:
   each one on dense rows, or on packed rows of whole 16-byte units (768
   bits: 24 lanes), must launch the search kernels and no gather kernel (a
   search without a cancel at most 3 launches), each on other rows none of
   them.

The build seconds of phases 4 and 5 are the wall time of an unfenced
``build_graph``, ended by one ``torch.cuda.synchronize()``. The kernels'
launch counts (in all and per [B, K]) are set to 0 just before the build
and before the search and read just after each: the build must launch a
kernel, the search only the search kernels (1-3 a call).

The last three lines are the card line, a JSON object describing the
kernel, and ``{"ok": true, "device": {...}}``; the line before them
(``detail {...}``) holds every timed case and each phase's record. The
kernel line has one
entry for each form of the kernel — row type (f32, bf16, int8, packed) ×
family (dot: cosine; difference: euclidean, manhattan; popcount: the
packed metrics) — with the launches that phases 5-12 made in that form,
each step counted from 0, the kernel design that served them, and as its
headline the phase-3 case of the shape those phases launch most. The run
fails if a form was never launched, or if a launch of phases 5-12 (all at
768-wide rows, whole 16-byte units) did not take the design for such rows:
the staged design for f32, bf16 and int8, the pair design for packed rows. The
search kernels have one entry for each kernel and form the main path
launched (``beam_search[f32/dot]``, ``greedy_descend[bf16/difference]``,
...): their launches in phases 5-12 and, as the headline, phase 13's case
of that form on the largest store (the layer-0 beam), with the host
loop's time beside the plain version's. Phase 3
also gives each case's per-pair floor (each pair's row read once) beside
its bound. ``--kernel-only`` stops after phase 3. ``--search-only`` runs
phase 13 alone after phase 2 (the small stores, then a 100k and a 1M
Reader built through the API for it, and at 1M the staging budgets of
``BUDGET_SWEEP``), for a change to the search kernels. ``--against
PATH`` builds a second search library from another ``search.cu`` of the
same C entries and the first design's layout of shared memory (kept
outside the package, e.g. in the gitignored ``_work/``) and times it in
turns with the package's at every timed case of phase 13 (the same
answers, the ratio, its split). It needs no network and imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, DIM, N_QUERIES, K = 100_000, 768, 256, 10
M, M0, EFC, WAVE = 16, 32, 48, 4096
EF_SWEEP = (50, 100)
RECALL_BAR = 0.93
#: build hop, search hop, the bulk build's random-candidate step, the
#: upper-layer rows of fill_link_dists
KERNEL_SHAPES = ((4096, 32), (256, 32), (8192, 8), (4096, 16))
#: the deletion repair's spliced candidates: REPAIR_BLOCK owners × ext_cap
#: (timed for f32 cosine and euclidean, bf16 and int8 cosine)
REPAIR_SHAPE = (512, 64)
#: the shapes timed for the tier and packed forms: wave hop, search hop,
#: the bulk build's random candidates
NEW_FORM_SHAPES = ((256, 32), (4096, 32), (8192, 8))
#: the packed form's other shapes on the main path: the BQ wave hops of
#: narrower waves and the descent's layer-1 beam
PACKED_SHAPES = ((1024, 32), (128, 32))
#: the build options' wave hops (phase 11), each row ending in a run of -1:
#: ``traverse=24``, chain seeds [W, 1 + M0] and [W, 1 + M0 + 16] with
#: ``link_slack=16``, and ``beam_expand=2``'s [W, 2·M0]; timed for f32
#: cosine and euclidean, bf16 and int8 cosine, and BQ cosine
OPTION_SHAPES = ((4096, 24), (4096, 33), (4096, 49), (4096, 64))
PACKED_METRICS = ("hamming", "binary quantized cosine", "binary quantized euclidean", "binary quantized manhattan")
#: a packed store past the 50 MB L2 cache (96 MB of 768-bit rows: what a
#: BQ index of a million items reads), timed at the wave hop and the
#: search hop for hamming and BQ cosine
N_PAST_L2 = 1_000_000
PAST_L2_SHAPES = ((4096, 32), (256, 32))
PAST_L2_METRICS = ("hamming", "binary quantized cosine")
#: launches a CUDA-event pair brackets for the launch floor ([1, 1])
FLOOR_LAUNCHES = 1024
#: phase 7: items of the HAMMING wave build
N_HAMMING = 20_000
#: phase 7: the benchmark's hamming cell's shape (ada-002 as 1,536 sign
#: bits, M 16, efc 64) on N items: phase 13's packed headline
HAMMING_DIM, HAMMING_EFC = 1536, 64
#: phase 8: (metric, tier, build) cells; euclidean "raw" gives the f32
#: figures. "default" takes the bulk path; "waves" (``bulk(False)``) is
#: there to tell apart what lowers euclidean f32 recall: the graph, the
#: ef or the bulk candidates (both raw cells are searched at TRIAGE_EF too)
TIER_CELLS = (("cosine", "bf16", "default"), ("cosine", "int8", "default"), ("euclidean", "raw", "default"),
              ("euclidean", "bf16", "default"), ("euclidean", "int8", "default"), ("euclidean", "raw", "waves"))
TRIAGE_EF = 200
#: phase 6: items appended after the reopen, the store's size limit, and
#: the least share of appended vectors that must find themselves first
N_APPEND = 2000
API_MAP_SIZE = 4 * 2**30
SELF_HIT_BAR = 0.99
#: phase 9: items deleted (and as many added) on the phase-6 database, and
#: the candidate sets' shares of its items
N_DELETE = 2000
FILTER_SHARES = (0.005, 0.01, 0.1, 0.5)
#: phase 9 (d): the checks at which a search's cancel fires, the filter
#: share it is also run under, how far a partial row's distance may be
#: from flat_topk's, and the build the cancel stops (items added, deleted)
CANCEL_AT = (1, 2, 4)
CANCEL_FILTER_SHARE = 0.1
CANCEL_ATOL = 1e-5
CANCEL_ADD, CANCEL_DELETE = 500, 100
#: phase 10: items and shards of the sharded database (every shard on the
#: one card), items deleted after the first build, and the store's size
#: limit. 4 x 25k, cut from 4 x 50k, whose phase took 88 s on an H100
#: (700 W) against a budget of about 60; each shard still takes the bulk
#: path (>= 8,192 items) and the search-seeded insertion (>= 16,384)
N_SHARDED, N_SHARDS, SHARDED_DELETE = 100_000, 4, 400
SHARDED_MAP_SIZE = 8 * 2**30
#: phase 11: the build options, each built between two default builds of
#: its path in the same call — the wave path (``bulk=False``, wave 4096) on
#: the first N_OPTION_WAVE items, the bulk path on the first N_OPTION_BULK
#: (both cut from 100k, the wave path first, where phase 11 took ≈ 120 s
#: against a budget of 75, then both again once phase 12 took 200-250 s of
#: a run that has to stay near half of its 1,200 s limit; 25k still chains
#: waves, 50k still takes the k-means candidates, > 16,384, and the pooled
#: 8-wide descent); the recall of
#: ``bulk_upper=1`` is printed, not barred (the JAX package expects a
#: bulk-built layer 1 to lose recall); QPS_TURNS searches of each of the
#: plain and the renumbered bulk graph, in turns; the sharded churn of
#: phase 10's layout with SHARDED_SLACK slack columns
N_OPTION_WAVE = 25_000
N_OPTION_BULK = 50_000
WAVE_OPTIONS = (("default", {}), ("beam_expand=2", {"beam_expand": 2}), ("traverse=24", {"traverse": 24}),
                ("link_slack=16", {"link_slack": 16}), ("chain_seeding", {"chain_seeding": True}),
                ("default again", {}))
BULK_OPTIONS = (("default", {}), ("bulk_renumber", {"bulk_renumber": True}),
                ("bulk_backbone=False,bulk_upper=1", {"bulk_backbone": False, "bulk_upper": 1}),
                ("backbone_flat=False", {"backbone_flat": False}), ("bulk_init=random", {"bulk_init": "random"}),
                ("default again", {}))
UNBARRED = ("bulk_backbone=False,bulk_upper=1",)
QPS_TURNS = 3
SHARDED_SLACK = 8
#: phase 12: the main path at the size its users run — the upstream
#: benchmarks' 1M rows (BASELINE.md), bench.py's data at 1,000,000 items
#: and its ef_construction above 200k items — searched at SCALE_EF (QPS
#: the median of SCALE_QPS_CALLS single calls); the store's size limit
#: (the 1 GiB default holds about 350k items of 768 f32); the width that
#: default_ef_upper gives at >= 500,000 items, which the port's spans must
#: record for the search's pooled descent and the append's level-0 seeds
N_SCALE = 1_000_000
EFC_SCALE = 96
SCALE_EF = (50, 100, 200)
SCALE_QPS_CALLS = 5
SCALE_MAP_SIZE = 8 * 2**30
SCALE_EF_UPPER = 32
#: phase 3: f32 cosine on a random store of N_SCALE rows (3.07 GB, past
#: 2**31 bytes) at the shapes phase 12 launches: the search's hops (layer
#: 1 [256, 16], layer 0 [256, 32]) and entry points [256, 1]; the append's
#: waves [128, ·] and its self-hit search [2000, ·]; fill_link_dists
#: [4096, 32 / 16]; the bulk build's random candidates [8192, 8] and
#: their last chunk [576, 8]
SCALE_STORE_SHAPES = ((256, 32), (256, 16), (256, 1), (128, 32), (128, 16), (128, 1), (2000, 32), (2000, 16),
                      (2000, 1), (4096, 32), (4096, 16), (8192, 8), (576, 8))
#: index sets the timed launches rotate through (keeps rows out of L2)
INDEX_SETS = 8
TIMED_PAIRS = 5
#: H100 SXM: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_launch_ms(fns, launches: int) -> float:
    """Median over ``TIMED_PAIRS`` CUDA-event pairs of the time of one
    launch, each pair around ``launches`` back-to-back calls rotating
    through ``fns``, after a warm-up round. The calls are captured once
    into a CUDA graph and the pair brackets its replay, so the host's cost
    per call (Python, ctypes, allocation) is out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    cg = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cg):
        for i in range(launches):
            fns[i % len(fns)]()
    cg.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_PAIRS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        cg.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def bound(b: int, k: int, rows: float, row_bytes: int, q_bytes: int, header: bool, ops: int) -> tuple[float, str]:
    """The least time (ms) for the gather-distance function at [b, k] whose
    indices touch ``rows`` distinct store rows of ``row_bytes`` each: the
    larger of its bytes over the HBM rate — each distinct row once (a row
    gathered twice need not be read twice) with its header where the form
    reads it (``header``: a norm or a scale), the queries b·``q_bytes``
    (and their headers), indices and outputs b·k·(4+4) — and its
    operations, ``ops`` per (query, row) pair (per element 2 for a dot, 3
    for a difference and its square or absolute value; per 32-bit lane 3
    for xor, popcount and add), over the f32 rate outside the tensor
    cores (taken for the integer pipe as well)."""
    head = 4 if header else 0
    nbytes = rows * (row_bytes + head) + b * (q_bytes + head) + b * k * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = b * k * ops / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def pair_floor(b: int, k: int, row_bytes: int, q_bytes: int, header: bool) -> float:
    """The least time (ms) for the same launch if each (query, candidate)
    pair's row is read once (what a kernel that does not find repeated
    indices has to read): b·k rows and headers, the queries, indices and
    outputs, over the HBM rate."""
    head = 4 if header else 0
    return (b * k * (row_bytes + head) + b * (q_bytes + head) + b * k * 8) / HBM_BYTES_PER_S * 1e3


def _index_sets(gen, device, make_query, b: int, k: int, tails: bool = False, n: int = 0):
    """``INDEX_SETS`` × (q, qn, idx) into a store of ``n`` rows (``N`` when
    0), with 5% of the indices at -1; with ``tails``, each row also ends in
    a run of -1 of random length (a hop over truncated rows or inactive
    expansions)."""
    import torch

    sets = []
    for _ in range(INDEX_SETS):
        q, qn = make_query(b)
        idx = torch.randint(0, n or N, (b, k), generator=gen, device=device, dtype=torch.int32)
        idx[torch.rand((b, k), generator=gen, device=device) < 0.05] = -1
        if tails:
            cut = torch.randint(1, k + 1, (b, 1), generator=gen, device=device)
            idx[torch.arange(k, device=device)[None, :] >= cut] = -1
        sets.append((q, qn, idx))
    return sets


def kernel_case(metric, row: str, store, norms, sets, tol: str, row_bytes: int, q_bytes: int, ops: int, build_query=None,
                floor_ms: float | None = None) -> dict:
    """One phase-3 case: the kernel against its twin on ``sets[0]`` (also
    with one index past the store, which must give NaN, and with
    ``build_query`` = (q, qn) gathered from the store), then both timed
    over all the sets. ``tol``: "abs" 1e-5, "rel" 1e-5, "exact", or "ulp"
    (1.2e-7 absolute). ``floor_ms``: the launch floor, printed beside."""
    import torch

    from hannoy_tpu_torch.ops import beam_cuda

    name = metric.name
    q, qn, idx = sets[0]
    b, k = idx.shape

    def errors(got, want):
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp(min=1e-30)).max())
        ok = {"abs": max_abs <= 1e-5, "rel": float((err - 1e-5 * want.abs()).max()) <= 1e-6 if name == "cosine" else max_rel <= 1e-5,
              "exact": bool(torch.equal(got, want)), "ulp": max_abs <= 1.2e-7}[tol]
        return ok and bool(torch.isfinite(got).all()), max_abs, max_rel

    got = beam_cuda.gathered_distances(metric, store, norms, q, qn, idx)
    want = beam_cuda.gathered_distances_plain(metric, store, norms, q, qn, idx)
    torch.cuda.synchronize()
    ok, max_abs, max_rel = errors(got, want)
    # an index past the store gives NaN there and changes nothing else
    past = idx.clone()
    past[0, 0] = store.shape[0]
    marked = beam_cuda.gathered_distances(metric, store, norms, q, qn, past)
    ok = ok and bool(torch.isnan(marked[0, 0])) and int(torch.isnan(marked).sum()) == 1
    ok = ok and bool(torch.equal(marked.flatten()[1:], got.flatten()[1:]))
    if build_query is not None:
        # a build's query, gathered from the store; column 0 holds its own
        # row, which a difference metric must find at exactly 0
        bq, bqn, pick = build_query
        own = idx.clone()
        own[:, 0] = pick.to(torch.int32)
        got_b = beam_cuda.gathered_distances(metric, store, norms, bq, bqn, own)
        ok_b, abs_b, rel_b = errors(got_b, beam_cuda.gathered_distances_plain(metric, store, norms, bq, bqn, own))
        ok, max_abs, max_rel = ok and ok_b, max(max_abs, abs_b), max(max_rel, rel_b)
        if name != "cosine" and not bool((got_b[:, 0] == 0).all()):
            raise AssertionError(f"kernel {row} {name}: a row against its own copy is not exactly 0: {got_b[:, 0].abs().max()}")
    kernel_fns = [lambda s=s: beam_cuda.gathered_distances(metric, store, norms, *s) for s in sets]
    plain_fns = [lambda s=s: beam_cuda.gathered_distances_plain(metric, store, norms, *s) for s in sets]
    launches = max(16, (1 << 22) // (b * k))
    rows = float(np.mean([torch.unique(s[2].clamp(min=0)).numel() for s in sets]))
    family = beam_cuda.form_of(metric, store.dtype)[1]
    header = name in ("cosine", "binary quantized cosine") or (row == "int8" and family == "difference")
    bound_ms, bound_by = bound(b, k, rows, row_bytes, q_bytes, header, ops)
    pair_ms = pair_floor(b, k, row_bytes, q_bytes, header)
    case = {
        "form": f"{row}/{family}", "metric": name, "shape": [b, k, store.shape[1]], "store_rows": store.shape[0],
        "tolerance": tol,
        "design": beam_cuda.design_of(store.dtype, metric, store.shape[1], True),
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": per_launch_ms(kernel_fns, launches),
        "plain_ms": per_launch_ms(plain_fns, max(8, launches // 8)),
        "bound_ms": bound_ms, "bound_by": bound_by, "distinct_rows": rows, "pair_floor_ms": pair_ms,
        "launches_per_event_pair": launches,
    }
    case["roofline_share"] = bound_ms / case["ms"]
    case["pair_floor_share"] = pair_ms / case["ms"]
    beside = ""
    if floor_ms is not None:
        case["launch_floor_ms"] = floor_ms
        beside = f"launch floor {floor_ms:.5f} ms (x {case['ms'] / floor_ms:.3f}); "
    print(f"kernel {row} {name} [{b},{k},{store.shape[1]}] of {store.shape[0]} rows ({case['design']}): "
          f"max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} ({tol}) kernel {case['ms']:.5f} ms plain "
          f"{case['plain_ms']:.5f} ms bound {bound_ms:.5f} ms ({bound_by}, {rows:.0f} distinct rows; share "
          f"{case['roofline_share']:.3f}); per-pair floor {pair_ms:.5f} ms (share {case['pair_floor_share']:.3f}); "
          f"{beside}{launches} launches per event pair", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with its twin: {case}")
    return case


def check_kernel(device) -> tuple[list[dict], list[dict]]:
    """Phase 3: every form of the kernel against its plain twin at the
    main path's shapes → the cases, and the packed launch floors."""
    import torch

    from hannoy_tpu_torch.models import hnsw
    from hannoy_tpu_torch.ops import beam_cuda, distances

    gen = torch.Generator(device=device).manual_seed(0)
    store = torch.randn((N, DIM), generator=gen, device=device)
    zeros = torch.zeros(N, device=device)
    cases, floors = [], []

    def f32_query(name):
        def make(b):
            q = torch.randn((b, DIM), generator=gen, device=device)
            return q, (q.norm(dim=1) if name == "cosine" else torch.zeros(b, device=device))
        return make

    for name in ("cosine", "euclidean", "manhattan"):
        metric = distances.by_name(name)
        norms = store.norm(dim=1) if name == "cosine" else zeros
        shapes = KERNEL_SHAPES + ((REPAIR_SHAPE,) if name != "manhattan" else ())
        for b, k in shapes + (OPTION_SHAPES if name != "manhattan" else ()):
            sets = _index_sets(gen, device, f32_query(name), b, k, tails=(b, k) not in shapes)
            cases.append(kernel_case(metric, "f32", store, norms, sets, "abs" if name == "cosine" else "rel",
                                     DIM * 4, DIM * 4, DIM * (2 if name == "cosine" else 3)))

    # the storage tiers of the same store, through the port's encoders
    host = store.cpu().numpy()
    for tier, elem in (("bf16", 2), ("int8", 1)):
        for name in ("cosine", "euclidean", "manhattan"):
            metric = distances.by_name(name)
            rows, headers = hnsw.encode_tier(metric, host, distances.np_norms(metric, host), tier)
            t_rows = (rows if isinstance(rows, torch.Tensor) else torch.from_numpy(rows)).to(device)
            t_norms = torch.from_numpy(np.ascontiguousarray(headers)).to(device)
            shapes = NEW_FORM_SHAPES + ((REPAIR_SHAPE,) if name == "cosine" else ())
            for b, k in shapes + (OPTION_SHAPES if name == "cosine" else ()):
                sets = _index_sets(gen, device, f32_query(name), b, k, tails=(b, k) not in shapes)
                pick = torch.randint(0, N, (b,), generator=gen, device=device)
                cases.append(kernel_case(metric, tier, t_rows, t_norms, sets, "rel", DIM * elem, DIM * 4,
                                         DIM * (2 if name == "cosine" else 3),
                                         build_query=(t_rows[pick].contiguous(), t_norms[pick].contiguous(), pick)))
            del t_rows, t_norms
    del host

    # packed rows: 768 random bits a row, as int32 lanes, in a store of N
    # rows (in L2) and one of N_PAST_L2 (past it)
    lanes = DIM // 32
    del store, zeros
    for n_rows in (N, N_PAST_L2):
        packed = torch.randint(-(2**31), 2**31, (n_rows, lanes), generator=gen, device=device,
                               dtype=torch.int64).to(torch.int32)
        for name in PACKED_METRICS if n_rows == N else PAST_L2_METRICS:
            metric = distances.by_name(name)
            fill = float(np.sqrt(np.float32(DIM))) if name == "binary quantized cosine" else 0.0
            norms = torch.full((n_rows,), fill, device=device)

            def packed_query(b, fill=fill):
                q = torch.randint(-(2**31), 2**31, (b, lanes), generator=gen, device=device,
                                  dtype=torch.int64).to(torch.int32)
                return q, torch.full((b,), fill, device=device)

            # the launch floor: one pair a launch, timed like every case
            one = _index_sets(gen, device, packed_query, 1, 1, n=n_rows)
            floor_ms = per_launch_ms([lambda s=s: beam_cuda.gathered_distances(metric, packed, norms, *s) for s in one],
                                     FLOOR_LAUNCHES)
            print(f"launch floor: packed {name} [1,1,{lanes}] of {n_rows} rows "
                  f"({beam_cuda.design_of(packed.dtype, metric, lanes, True)}): {floor_ms:.5f} ms", flush=True)
            floors.append({"metric": name, "store_rows": n_rows, "ms": floor_ms})
            if n_rows == N:
                shapes = NEW_FORM_SHAPES + PACKED_SHAPES + (OPTION_SHAPES if name == "binary quantized cosine" else ())
            else:
                shapes = PAST_L2_SHAPES
            for b, k in shapes:
                sets = _index_sets(gen, device, packed_query, b, k, tails=(b, k) in OPTION_SHAPES, n=n_rows)
                cases.append(kernel_case(metric, "packed", packed, norms, sets,
                                         "ulp" if name == "binary quantized cosine" else "exact", lanes * 4, lanes * 4,
                                         lanes * 3, floor_ms=floor_ms))
        del packed, norms
    return cases + scale_store_cases(gen, device), floors


def scale_store_cases(gen, device) -> list[dict]:
    """Phase 3's f32 cosine cases on a random store of phase 12's size,
    ``N_SCALE`` rows (3.07 GB, so that row offsets pass 2**31 bytes), at
    ``SCALE_STORE_SHAPES``."""
    import torch

    from hannoy_tpu_torch.ops import distances

    store = torch.randn((N_SCALE, DIM), generator=gen, device=device)
    norms = store.norm(dim=1)

    def query(b):
        q = torch.randn((b, DIM), generator=gen, device=device)
        return q, q.norm(dim=1)

    return [kernel_case(distances.COSINE, "f32", store, norms, _index_sets(gen, device, query, b, k, n=N_SCALE), "abs",
                        DIM * 4, DIM * 4, DIM * 2) for b, k in SCALE_STORE_SHAPES]


def bench_data(rng: np.random.Generator, n: int = 0, dim: int = DIM) -> tuple[np.ndarray, np.ndarray]:
    """``bench.py``'s clustered synthetic data: ``n`` items (``N`` when 0)
    of ``dim`` dimensions, a Gaussian mixture with n//256 centres, plus
    queries drawn around the same centres."""
    n = n or N
    n_clusters = max(32, n // 256)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    # in chunks of rows: the same draws in the same order, and the same
    # sums, as one (n, dim) draw, without its float64 temporaries
    data = np.empty((n, dim), dtype=np.float32)
    for p0 in range(0, n, 65536):
        a = assign[p0 : p0 + 65536]
        data[p0 : p0 + 65536] = centers[a] + rng.standard_normal((len(a), dim))
    q_assign = rng.integers(0, n_clusters, size=N_QUERIES)
    queries = (centers[q_assign] + rng.standard_normal((N_QUERIES, dim))).astype(np.float32)
    return data, queries


def bench_append(n: int, seed: int = 43, n_data: int = 0) -> np.ndarray:
    """``n`` more items around the centres of ``bench_data(.., n_data)``
    (seed 42 draws the centres first; the items come from ``seed``)."""
    n_data = n_data or N
    n_clusters = max(32, n_data // 256)
    centers = np.random.default_rng(42).standard_normal((n_clusters, DIM)).astype(np.float32) * 4.0
    rng = np.random.default_rng(seed)
    return (centers[rng.integers(0, n_clusters, size=n)] + rng.standard_normal((n, DIM))).astype(np.float32)


def stage(data):
    """A host graph with ``data`` staged in slots 0..len(data)-1, cosine."""
    from hannoy_tpu_torch import HostGraph
    from hannoy_tpu_torch.models.hnsw import slot_capacity
    from hannoy_tpu_torch.ops import distances

    n = len(data)
    g = HostGraph.empty(distances.COSINE, DIM, M, M0, capacity=slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(distances.COSINE, data)
    return g


def timed_build(device, data, fence=None, **opts):
    """Stage ``data`` and build it → (graph, stats, wall seconds, spans).
    The wall time ends with one ``torch.cuda.synchronize()``; with
    ``fence``, both ends of every span wait for the device as well."""
    from hannoy_tpu_torch import BuildOptions, build_graph
    from hannoy_tpu_torch.utils import tracing

    g = stage(data)
    _sync(device)
    t0 = time.perf_counter()
    with tracing.record(fence=fence) as spans:
        stats = build_graph(
            g, np.arange(len(data), dtype=np.int64), np.empty(0, dtype=np.int64),
            BuildOptions(ef_construction=EFC, wave_size=WAVE, **opts), device=device,
        )
        _sync(device)
    return g, stats, time.perf_counter() - t0, spans


def build_turns(device, data, label: str, card: str, **opts) -> dict:
    """The build with its searches' loops (insertion seeds, the upper
    levels' beams) on the search kernels and on the host loop
    (``host_loops``), in turns: kernels, host loop, host loop, kernels →
    the wall seconds of each side, and whether the two built the same
    links (the kernels equal the host loop bit for bit; recorded, not
    required, as a build on the card is not held to be deterministic)."""
    t: dict[str, list] = {"kernels": [], "host_loop": []}
    links = {}
    for who in ("kernels", "host_loop", "host_loop", "kernels"):
        build = lambda: timed_build(device, data, **opts)  # noqa: E731
        g, _, wall, _ = build() if who == "kernels" else host_loops(build)
        t[who].append(wall)
        links.setdefault(who, (g.links0.copy(), [u.copy() for u in g.upper_links]))
        del g
    (a0, au), (b0, bu) = links["kernels"], links["host_loop"]
    same = bool(np.array_equal(a0, b0)) and len(au) == len(bu) and all(np.array_equal(x, y) for x, y in zip(au, bu))
    out = {who: {"seconds": v, "median_s": float(np.median(v))} for who, v in t.items()}
    out["same_links"] = same
    out["ratio"] = out["kernels"]["median_s"] / out["host_loop"]["median_s"]
    print(f"[{label}] build in turns: the search kernels {t['kernels'][0]:.3f} / {t['kernels'][1]:.3f} s, the host loop "
          f"{t['host_loop'][0]:.3f} / {t['host_loop'][1]:.3f} s (kernels / host loop {out['ratio']:.3f}); the same links: "
          f"{same} ({card})", flush=True)
    return out


def _shapes(by_shape: dict) -> dict:
    return {f"{b}x{k}": n for (b, k), n in sorted(by_shape.items())}


def fenced_spans(device, data, label: str, **opts) -> dict:
    """The same build once more with every span fenced by
    ``torch.cuda.synchronize()`` → ms per span name (the fences remove the
    overlap of host and device, so this build is slower than the timed one)."""
    _, _, wall, spans = timed_build(device, data, fence=lambda: _sync(device), **opts)
    print(f"[{label}] fenced build (for the span times): {wall:.3f} s", flush=True)
    table: dict[str, list] = {}
    for s in spans:
        key = s.name if s.name != "insert_wave" else f"insert_wave level {s.fields['level']} width {s.fields['width']}"
        table.setdefault(key, [0, 0.0])
        table[key][0] += 1
        table[key][1] += s.ms
    for key, (count, ms) in table.items():
        print(f"[{label}]   span {key}: {count} x, {ms:.2f} ms", flush=True)
    return {"build_s": wall, "spans": {k: {"count": c, "ms": ms} for k, (c, ms) in table.items()}}


def profiled(fn, label: str, what: str) -> dict:
    """``fn`` (which returns its wall seconds, ended by a synchronize) under
    ``torch.profiler`` → its wall seconds, the device's busy time (the sum
    of the device events: one stream, so they do not overlap) and idle
    share, and the kernels with the most device time. Only the device's
    activity is recorded (the host's operators would cost the profiler
    most of its time to parse); its own host cost is in the wall time all
    the same, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = fn()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    out = {"wall_s": wall, "device_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3) if busy else None,
           "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    idle = f"{out['idle_share']:.4f}" if busy else "not measured (the profiler saw no device events)"
    print(f"[{label}] profiled {what}: {wall:.3f} s wall, device busy {busy:.2f} ms, idle share {idle}", flush=True)
    for kname, ms in out["top"]:
        print(f"[{label}]   device {ms:.2f} ms: {kname[:110]}", flush=True)
    return out


#: the watched search entry points (``watch_searches``): per call, whether
#: its graph is in the search kernels' scope, whether it had a cancel, and
#: the launches of the search kernels and of the gather kernel inside it
SEARCH_CALLS: dict[str, list] = {"hnsw_search": [], "descend_for_slots": []}
#: set while ``host_loops`` runs a comparison's host loop (its calls are not the main path's)
HOST_LOOPS = [False]
#: phase 13's timed cases, one per kernel launch (greedy descent, layer-1
#: and layer-0 beams) of each checked search
SEARCH_CASES: list[dict] = []


def watch_searches() -> None:
    """Wrap ``beam.hnsw_search`` (every ``Reader.by_vecs`` without
    candidates and every shard's search call it; an unfiltered
    ``by_items`` runs one beam, checked in phase 9) and
    ``beam.descend_for_slots`` (the insertion seeds of appends and of the
    lockstep waves) so that each call records what it launched into
    ``SEARCH_CALLS``; ``check_search_calls`` holds them to the rule."""
    from hannoy_tpu_torch.ops import beam, beam_cuda, search_cuda

    for name in SEARCH_CALLS:
        fn = getattr(beam, name)

        def watched(g, *args, _fn=fn, _name=name, **kw):
            if HOST_LOOPS[0]:  # a comparison's run of the host loop
                return _fn(g, *args, **kw)
            gathers, searches = beam_cuda.KERNEL.launches, sum(search_cuda.KERNELS.launches.values())
            out = _fn(g, *args, **kw)
            SEARCH_CALLS[_name].append({
                "in_scope": beam._on_kernel(g), "cancel": kw.get("cancel") is not None,
                "search": sum(search_cuda.KERNELS.launches.values()) - searches,
                "gather": beam_cuda.KERNEL.launches - gathers})
            return out

        setattr(beam, name, watched)


def check_search_calls() -> dict:
    """Every watched call in the search kernels' scope (dense rows, and
    packed rows of the pair design, on the card) went through them: no
    launch of the gather kernel inside it, and
    an ``hnsw_search`` without a cancel at most 3 launches (the greedy
    descent, the layer-1 and the layer-0 beam); one out of scope launched
    none of them. → a summary per entry point."""
    out = {}
    for name, calls in SEARCH_CALLS.items():
        bad = [c for c in calls if (c["in_scope"] and (c["gather"] or not c["search"]
                                                       or (name == "hnsw_search" and not c["cancel"] and c["search"] > 3)))
               or (not c["in_scope"] and c["search"])]
        if bad:
            raise AssertionError(f"{name}: {len(bad)} calls broke the search kernels' rule, e.g. {bad[:3]}")
        kern = [c for c in calls if c["in_scope"]]
        out[name] = {"calls": len(calls), "through_the_kernels": len(kern), "host_loop": len(calls) - len(kern),
                     "launches_per_call_max": max((c["search"] for c in kern if not c["cancel"]), default=0),
                     "with_cancel": sum(c["cancel"] for c in kern)}
    if not out["hnsw_search"]["through_the_kernels"] or not out["descend_for_slots"]["through_the_kernels"]:
        raise AssertionError(f"the main path's searches or insertion seeds never took the search kernels: {out}")
    print(f"search entry points: {json.dumps(out)}", flush=True)
    return out


def host_loops(fn):
    """``fn()`` with the searches' loops on the host (``beam_search_loop``,
    ``greedy_descend_loop``): the host loop, called directly, for the
    comparisons and the turns of phase 13."""
    from hannoy_tpu_torch.ops import beam

    saved = beam.beam_search, beam.greedy_descend
    beam.beam_search, beam.greedy_descend = beam.beam_search_loop, beam.greedy_descend_loop
    HOST_LOOPS[0] = True
    try:
        return fn()
    finally:
        beam.beam_search, beam.greedy_descend = saved
        HOST_LOOPS[0] = False


def _same_bits(label: str, what: str, got, want, rows: int | None = None) -> None:
    """Two beam results equal bit for bit (slots, distance bits, and over
    the whole batch the iteration count and the active rows)."""
    import torch

    a, b = (got.slots, got.dists.view(torch.int32)), (want.slots, want.dists.view(torch.int32))
    if rows is not None:
        a = tuple(t[:rows] for t in a)
    same = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    if rows is None:
        same = same and int(got.iters) == int(want.iters) and bool(torch.equal(got.active, want.active))
    if not same:
        diff = int((a[0] != b[0]).sum())
        raise AssertionError(f"[{label}] the search kernels differ from {what}: {diff} slots, iters "
                             f"{int(got.iters)} / {int(want.iters)}")


def _events_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` CUDA-event pairs of one call of ``fn`` (after a
    warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _search_bound(kernel: str, dev, last: dict, seen: dict) -> tuple[float, str, dict]:
    """The least time (ms) of the kernel's last call (``KERNELS.last``,
    ``seen``: ``search_cuda.seen_counts`` of the same call, marked): the
    larger of its bytes — each distinct store row it computed a distance
    to (and its header where the form reads one), each distinct link row
    and slot-row entry its hops read, the queries, seeds and outputs, each
    read or written once — over the HBM rate, and its operations (per
    element 2 for a dot, 3 for a difference, for every distance computed)
    over the f32 rate → (ms, "bytes" or "operations", the counts, with the
    per-pair floor: the bytes if every distance read its row and every hop
    its link row anew, as the kernel does, over the HBM rate)."""
    metric = dev.metric
    n_dist, hops = int(last["n_dist"].sum()), int(last["hops"].sum())
    b, d = last["batch"], last["dim"]
    int8_scale = dev.vectors.dtype.itemsize == 1 and metric.name != "cosine"
    row = last["row_bytes"] + (4 if metric.name == "cosine" or int8_scale else 0)
    if kernel == "beam_search":
        link = last["width"] * 4 + (4 if last["level"] else 0)
        io = b * (d * 4 + 4 + last["n_start"] * 4 + last["ef"] * 12 + 12)
    else:
        link = last["width"] * 4 + 4
        io = b * (d * 4 + 4 + 16) + last["n_entry"] * 4
    nbytes = (seen["rows"] * row + seen["links0"] * dev.links0.shape[1] * 4 + seen["upper"] * dev.upper_links.shape[-1] * 4
              + seen["slot_rows"] * 4 + io)
    pair_bytes = n_dist * row + hops * link + io
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_dist * d * (2 if metric.name == "cosine" else 3) / F32_FLOPS * 1e3
    counts = {"distances": n_dist, "hops": hops, "max_row_hops": int(last["hops"].max()),
              "mean_row_hops": hops / max(1, b), "bytes": nbytes, "distinct": seen,
              "pair_bytes": pair_bytes, "pair_floor_ms": pair_bytes / HBM_BYTES_PER_S * 1e3}
    return (bytes_ms, "bytes", counts) if bytes_ms >= ops_ms else (ops_ms, "operations", counts)


#: the forms whose plain versions phase 13 has timed (once per form; f32
#: cosine at phase 12's size)
PLAIN_TIMED: set = {"f32/dot"}
#: phase 13: the ef of the checked searches, rows the plain versions run
#: in the bit-for-bit comparisons, the wide pool, the slack columns
SEARCH_EF = 100
#: launches of a search kernel in the CUDA graph that phase 13 times
SEARCH_LAUNCHES = 4
#: by_vecs calls a profiled window of ``search_turns`` holds
PROFILED_CALLS = 5
ROWWISE_ROWS = 16
WIDE_EF = 512
SEARCH_SLACK = 8
#: ``--against PATH``: a search library built from another ``search.cu``
#: (with the ``*.cuh`` beside it) of the same C entries and the first
#: design's layout of shared memory (``_baseline_shared``), timed in turns
#: with the package's in phase 13; empty without it
AGAINST: list = []
#: ``--search-only``: the staging budgets (``search_cuda.BLOCK_BUDGET``) at
#: which it times the 1M layer-0 beam and a [4096, 32] layer-1 beam (an
#: append's seeds): two, three and four blocks an SM
BUDGET_SWEEP = (113 * 1024, 75 * 1024, 56 * 1024)
#: ``--search-only``: the batch of the seeds-like layer-1 beam
SEED_BATCH = 4096


def hop_split(fn, kernel: str, batch: int, device) -> dict:
    """One more call of ``fn(clocks=...)`` (a search kernel's wrapper): the
    cycles its blocks' thread 0 spent in each stage of a hop
    (``search_cuda.STAGES``), summed over the blocks, per hop (or step) of
    the call and as a share of all → {"cycles_per_hop", "share", "hops"}."""
    from hannoy_tpu_torch.ops import search_cuda

    clocks = search_cuda.clock_buffer(batch, device)
    fn(clocks=clocks)
    _sync(device)
    hops = int(search_cuda.KERNELS.last[kernel]["hops"].sum())
    total = [float(v) for v in clocks.sum(0).tolist()]
    per = {name: total[i] / max(1, hops) for i, name in enumerate(search_cuda.STAGES)}
    whole = sum(per.values()) or 1.0
    return {"cycles_per_hop": per, "share": {k: v / whole for k, v in per.items()}, "hops": hops}


def _split_text(split: dict) -> str:
    return ", ".join(f"{k} {v:.0f} ({split['share'][k]:.2f})" for k, v in split["cycles_per_hop"].items())


def _baseline_shared(dim: int, row_bytes: int, ef: int, width: int) -> tuple[int, int, int]:
    """The first design's shared memory of a beam block (the query, two
    pools, five candidate arrays, the warps' minima), with the clocks at
    its end: the layout of ``--against``'s library."""
    from hannoy_tpu_torch.ops import search_cuda

    cap = (max(width, 1) + 31) // 32 * 32
    return cap, search_cuda.WARPS, 4 * (dim + 6 * ef + 5 * cap + search_cuda.WARPS) + search_cuda.CLOCK_BYTES


def _with_library(lib, rule, fn):
    """``fn()`` with the search kernels launched from ``lib`` and the
    beam's shared memory sized by ``rule``."""
    from hannoy_tpu_torch.ops import search_cuda

    saved = search_cuda.KERNELS.lib, search_cuda.beam_shared
    search_cuda.KERNELS.lib, search_cuda.beam_shared = lib.load(), rule
    try:
        return fn()
    finally:
        search_cuda.KERNELS.lib, search_cuda.beam_shared = saved


def against_baseline(fn, kernel: str, batch: int, device) -> dict:
    """The package's kernel (``fn``) and ``AGAINST``'s (the baseline) on
    the same inputs: the same answers (bit for bit), each kernel's ms in
    turns (baseline, new, new, baseline; CUDA-graph replay as
    ``per_launch_ms``), the ratio, and the baseline's split of a hop."""
    import torch

    from hannoy_tpu_torch.ops import search_cuda

    old = lambda **kw: _with_library(AGAINST[0], _baseline_shared, lambda: fn(**kw))  # noqa: E731
    a, b = fn(), old()
    a, b = (a, b) if kernel == "greedy_descend" else (a[:2], b[:2])
    same = all(bool(torch.equal(x.view(torch.int32), y.view(torch.int32))) for x, y in
               zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)))
    t = {"baseline": [], "new": []}
    for who in ("baseline", "new", "new", "baseline"):
        t[who].append(per_launch_ms([old if who == "baseline" else fn], SEARCH_LAUNCHES))
    hops = int(search_cuda.KERNELS.last[kernel]["hops"].max())
    out = {"same_answers": same, "baseline_ms": t["baseline"], "new_ms": t["new"],
           "ratio": float(np.mean(t["baseline"]) / np.mean(t["new"])),
           "baseline_split": hop_split(old, kernel, batch, device)}
    out["baseline_us_per_hop"] = float(np.mean(t["baseline"])) * 1e3 / max(1, hops)
    return out


def search_kernel_checks(label: str, reader, queries, card: str, slack: bool = False, plain_timing: bool = False,
                         timing_efs: tuple = (SEARCH_EF,)) -> dict:
    """Phase 13 on the Reader of another phase: the search kernels against
    the host loop and the plain versions on its graph, and each kernel
    timed. (1) ``hnsw_search`` at ef ``SEARCH_EF`` (its pooled descent as
    wide as the Reader's) by the kernels: at most 3 launches, none of the
    gather kernel, equal bit for bit to the host loop on the same batch and
    to the plain versions on its first ``ROWWISE_ROWS`` rows, which must
    also be the batch's rows (rows are searched each on its own); the
    plain versions with the plain twin's distances agree on 99% of the
    slots, distances within 1e-5 relative (``max_abs_err``). (2) Each
    launch of that search (greedy descent, layer-1 beam, layer-0 beam) on
    its own inputs (the layer-0 beam at each ef of ``timing_efs``): ms
    (the device's: ``per_launch_ms``, CUDA-graph replay
    of ``SEARCH_LAUNCHES`` launches) and a call's ms between two CUDA
    events (the wrapper's host work included), the host loop's ms for the
    same call (events), with ``plain_timing`` the plain version's ms on the
    batch's first ``ROWWISE_ROWS`` rows (the greedy descent and the layer-0
    beam at ``SEARCH_EF``), the bound (from one more call that marks what
    it reads: ``_search_bound``), hops per row and µs per hop (a launch
    lasts its slowest row). (3) ef ``WIDE_EF`` and, with ``slack``, the graph
    uploaded with ``SEARCH_SLACK`` empty layer-0 columns: kernels = host
    loop on the batch, = plain versions on 4 rows."""
    import torch

    from hannoy_tpu_torch.models import hnsw
    from hannoy_tpu_torch.ops import beam, beam_cuda, search_cuda

    dev, device = reader._dev, reader._dev.vectors.device
    q, qn = reader._prep_queries(queries)
    n = reader.n_items()
    ef, mi = SEARCH_EF, 2 * SEARCH_EF + 16
    efu = beam.default_ef_upper(n, ef)
    form = "/".join(beam_cuda.form_of(dev.metric, dev.vectors.dtype))
    out: dict = {"form": form, "store_rows": n, "ef": ef, "ef_upper": efu, "cases": []}

    # (1) the search by the kernels, the host loop and the plain versions
    reset_counts()
    got = beam.hnsw_search(dev, q, qn, ef, max_iters=mi, ef_upper=efu)
    _sync(device)
    out["launches"] = dict(search_cuda.KERNELS.launches)
    if beam_cuda.KERNEL.launches or not 1 <= sum(out["launches"].values()) <= 3:
        raise AssertionError(f"[{label}] the search launched {out['launches']} search kernels and "
                             f"{beam_cuda.KERNEL.launches} gather kernels")
    _same_bits(label, "the host loop", got, host_loops(lambda: beam.hnsw_search(dev, q, qn, ef, max_iters=mi, ef_upper=efu)))
    rows = slice(0, ROWWISE_ROWS)
    part = search_cuda.hnsw_search_rowwise(dev, q[rows], qn[rows], ef, mi, ef_upper=efu)
    _same_bits(label, "the plain versions", beam.hnsw_search(dev, q[rows], qn[rows], ef, max_iters=mi, ef_upper=efu), part)
    _same_bits(label, "the plain versions on the batch's rows", got, part, rows=ROWWISE_ROWS)
    plain = search_cuda.hnsw_search_rowwise(dev, q[rows], qn[rows], ef, mi, ef_upper=efu, plain=True)
    match = plain.slots == part.slots
    both = match & (part.slots >= 0)
    err = (part.dists[both] - plain.dists[both]).abs()
    out["plain_twin"] = {"identical_slots": float(match.float().mean()), "max_abs_err": float(err.max()) if err.numel() else 0.0}
    if out["plain_twin"]["identical_slots"] < 0.99 or bool((err > 1e-5 + 1e-5 * plain.dists[both].abs()).any()):
        raise AssertionError(f"[{label}] the search kernels against the plain versions with plain distances: {out['plain_twin']}")

    # (2) each launch of that search, timed on its own inputs
    top = dev.max_level
    steps = []
    bottom = 2 if efu > 1 else 1
    if top >= bottom:
        cur = search_cuda.greedy_descend_kernel(dev, q, qn, top, bottom, 128, dev.valid)
        steps.append(("greedy_descend", top,
                      (lambda seen=None, clocks=None: search_cuda.greedy_descend_kernel(
                          dev, q, qn, top, bottom, 128, dev.valid, seen=seen, clocks=clocks)),
                      (lambda: beam.greedy_descend_loop(dev, q, qn, top, bottom, 128, dev.valid)),
                      (lambda: search_cuda.greedy_descend_rowwise(dev, q[rows], qn[rows], top, bottom)),
                      [q.shape[0], 1, dev.upper_links.shape[-1]]))
        start = cur[:, None]
    else:
        start = dev.entry_slots[None, :].expand(q.shape[0], -1)
    if efu > 1 and top >= 1:
        s1 = start
        steps.append(("beam_search", 1,
                      (lambda seen=None, clocks=None: search_cuda.beam_search_kernel(
                          dev, q, qn, s1, efu, 2 * efu + 16, dev.valid, 1, seen=seen, clocks=clocks)),
                      (lambda: beam.beam_search_loop(dev, q, qn, s1, efu, node_ok=dev.valid, level=1)),
                      (lambda: search_cuda.beam_search_rowwise(dev, q[rows], qn[rows], s1[rows], efu, level=1)),
                      [q.shape[0], efu, dev.upper_links.shape[-1]]))
        start = search_cuda.beam_search_kernel(dev, q, qn, s1, efu, 2 * efu + 16, dev.valid, 1)[1]
    s0 = start
    # the layer-0 beam at each ef of timing_efs (the descent before it is
    # the same at each: its width default_ef_upper(n, ef) is, at these ef)
    for e in timing_efs:
        m = 2 * e + 16
        steps.append(("beam_search", 0,
                      (lambda seen=None, clocks=None, e=e, m=m: search_cuda.beam_search_kernel(
                          dev, q, qn, s0, e, m, dev.valid, 0, seen=seen, clocks=clocks)),
                      (lambda e=e, m=m: beam.beam_search_loop(dev, q, qn, s0, e, m, dev.valid, 0)),
                      (lambda e=e, m=m: search_cuda.beam_search_rowwise(dev, q[rows], qn[rows], s0[rows], e, m)),
                      [q.shape[0], e, dev.links0.shape[1]]))
    for kernel, level, fn, host_fn, plain_fn, shape in steps:
        # the launch's device time: replays of a CUDA graph of SEARCH_LAUNCHES
        # calls (no host work in the time); beside it one call between two
        # events, the wrapper's host work included
        ms = per_launch_ms([fn], SEARCH_LAUNCHES)
        call_ms = _events_ms(fn)
        seen = search_cuda.seen_buffer(dev)
        fn(seen=seen)  # the same call once more, marking what it reads
        last = search_cuda.KERNELS.last[kernel]
        bound_ms, bound_by, counts = _search_bound(kernel, dev, last, search_cuda.seen_counts(dev, seen))
        del seen
        case = {"kernel": kernel, "form": form, "level": level, "store_rows": n, "shape": shape + [dev.vectors.shape[1]],
                "search_ef": shape[1] if level == 0 else ef,
                "ms": ms, "call_ms": call_ms, "host_loop_ms": _events_ms(host_fn, reps=3), "bound_ms": bound_ms,
                "bound_by": bound_by,
                "roofline_share": bound_ms / ms, **counts, "pair_floor_share": counts["pair_floor_ms"] / ms,
                "us_per_hop": ms * 1e3 / max(1, counts["max_row_hops"]),
                "dependent_loads": (2 if level == 0 else 3) * counts["max_row_hops"],
                "max_abs_err": out["plain_twin"]["max_abs_err"], "plain_ms": None, "plain_rows": None, "library_ms": None,
                "card": card, "split": hop_split(fn, kernel, q.shape[0], device)}
        if AGAINST:
            case["against_baseline"] = against_baseline(fn, kernel, q.shape[0], device)
        if plain_timing and (kernel == "greedy_descend" or (level == 0 and shape[1] == ef)):  # the headlines
            _sync(device)
            t0 = time.perf_counter()
            plain_fn()
            _sync(device)
            case["plain_ms"], case["plain_rows"] = (time.perf_counter() - t0) * 1e3, ROWWISE_ROWS
        out["cases"].append(case)
        SEARCH_CASES.append(case)
        plain_ms = (f"{case['plain_ms']:.3f} ms on {ROWWISE_ROWS} rows" if case["plain_ms"] is not None
                    else "not timed")
        print(f"[{label}] {kernel} level {level} {shape} {form} on {n} items: {ms:.4f} ms ({case['us_per_hop']:.2f} us per "
              f"hop of the slowest row, {counts['mean_row_hops']:.1f} hops a row, max {counts['max_row_hops']}; "
              f"{call_ms:.4f} ms a call with the wrapper's host work; "
              f"{counts['distances']} distances), host loop {case['host_loop_ms']:.3f} ms, plain {plain_ms}, bound "
              f"{bound_ms:.4f} ms ({bound_by}, share {case['roofline_share']:.3f}; distinct {json.dumps(counts['distinct'])}); "
              f"per-pair floor {counts['pair_floor_ms']:.4f} ms (share {case['pair_floor_share']:.3f}); "
              f"{case['dependent_loads']} dependent loads in the slowest row ({card})", flush=True)
        print(f"[{label}] {kernel} level {level} {shape}: the split of a hop, cycles of thread 0 per hop (share): "
              f"{_split_text(case['split'])}", flush=True)
        if AGAINST:
            ab = case["against_baseline"]
            print(f"[{label}] {kernel} level {level} {shape} against the baseline kernel, in turns (baseline, new, new, "
                  f"baseline): baseline {ab['baseline_ms']} ms, new {ab['new_ms']} ms, ratio {ab['ratio']:.3f}, the same "
                  f"answers {ab['same_answers']}; baseline {ab['baseline_us_per_hop']:.2f} us a hop, its split: "
                  f"{_split_text(ab['baseline_split'])} ({card})", flush=True)

    # (3) a wide pool, and rows wider than m0
    wide = beam.hnsw_search(dev, q, qn, WIDE_EF, ef_upper=efu)
    _same_bits(label, f"the host loop at ef {WIDE_EF}", wide, host_loops(lambda: beam.hnsw_search(dev, q, qn, WIDE_EF, ef_upper=efu)))
    _same_bits(label, f"the plain versions at ef {WIDE_EF}", wide,
               search_cuda.hnsw_search_rowwise(dev, q[:4], qn[:4], WIDE_EF, ef_upper=efu), rows=4)
    checked = [f"ef {WIDE_EF}"]
    if slack:
        wide_rows = hnsw.to_device(reader._graph, device, serve_only=True, link_slack=SEARCH_SLACK)
        if wide_rows.links0.shape[1] != dev.links0.shape[1] + SEARCH_SLACK:
            raise AssertionError(f"[{label}] the slack upload has {wide_rows.links0.shape[1]} layer-0 columns")
        res = beam.hnsw_search(wide_rows, q, qn, ef, max_iters=mi, ef_upper=efu)
        _same_bits(label, "the host loop on slack rows", res,
                   host_loops(lambda: beam.hnsw_search(wide_rows, q, qn, ef, max_iters=mi, ef_upper=efu)))
        _same_bits(label, "the plain versions on slack rows", res,
                   search_cuda.hnsw_search_rowwise(wide_rows, q[:4], qn[:4], ef, mi, ef_upper=efu), rows=4)
        _same_bits(label, "the search without slack", res, got, rows=q.shape[0])
        checked.append(f"{SEARCH_SLACK} slack columns")
        del wide_rows
        torch.cuda.empty_cache()
    reset_counts()
    print(f"[{label}] the search kernels equal the host loop and the plain versions bit for bit at ef {ef} (ef_upper "
          f"{efu}) and at {', '.join(checked)}; against the plain twin's distances {out['plain_twin']['identical_slots']:.4f} "
          f"of the slots, max abs err {out['plain_twin']['max_abs_err']:.3e} ({card})", flush=True)
    return out


def _nan_walk_rows(dev) -> list[int]:
    """Slots to fill with NaN so that searches meet them: each entry point's
    first link at the highest level it has one, and every 37th slot."""
    top = dev.max_level
    entries = [int(e) for e in dev.entry_slots if e >= 0]
    rows = [dev.upper_links[lv - 1][int(dev.slot_rows[lv - 1][e])] for e in entries for lv in range(top, 0, -1)]
    return sorted({int(r[r >= 0][0]) for r in rows if bool((r >= 0).any())}) + list(range(0, dev.capacity, 37))


def search_edge_cases(device, card: str) -> dict:
    """Phase 13's cases that no other phase's database holds, at 768 wide
    f32 rows built on the card: a one-row store (ef 10) and a store of 40
    items searched at ef 64 (a pool that never fills), cosine; and a store
    of 3,000 under euclidean and one under cosine (a NaN row is at distance
    NaN there too) whose rows hold NaN on the walks (each entry point's
    first link at the highest level it has one, every 37th slot; ef 48) and
    then at an entry point, where every walk must end; 256 queries each: the
    search kernels equal the host loop and the plain versions (on the
    first ``ROWWISE_ROWS`` queries of the 3,000-item store) bit for bit."""
    import torch

    from hannoy_tpu_torch.build import builder
    from hannoy_tpu_torch.models import hnsw
    from hannoy_tpu_torch.ops import beam, distances, search_cuda

    label = "phase 13: small stores"
    rng = np.random.default_rng(50)
    qs = rng.standard_normal((N_QUERIES, DIM)).astype(np.float32)
    q = torch.from_numpy(qs).to(device)
    out = {}
    for name, n, ef, efu, metric in (("one_row", 1, 10, 1, distances.COSINE),
                                     ("ef_past_the_items", 40, 64, 8, distances.COSINE),
                                     ("nan_rows", 3000, 48, 8, distances.EUCLIDEAN),
                                     ("nan_rows_cosine", 3000, 48, 8, distances.COSINE)):
        qn = torch.from_numpy(distances.np_norms(metric, qs)).to(device)
        data = rng.standard_normal((n, DIM)).astype(np.float32)
        g = hnsw.HostGraph.empty(metric, DIM, M, M0, capacity=hnsw.slot_capacity(n))
        for i in range(n):
            g.alloc_slot(i)
        g.vectors[:n] = data
        g.norms[:n] = distances.np_norms(metric, data)
        builder.build_graph(g, np.arange(n), np.empty(0, np.int64), builder.BuildOptions(bulk=False), device=device)
        dev = hnsw.to_device(g, device, serve_only=True)
        if name.startswith("nan_rows"):
            dev.vectors[torch.tensor(_nan_walk_rows(dev), device=device)] = float("nan")
        reset_counts()
        got = beam.hnsw_search(dev, q, qn, ef, ef_upper=efu)
        launches = dict(search_cuda.KERNELS.launches)
        _same_bits(label, f"the host loop ({name})", got, host_loops(lambda: beam.hnsw_search(dev, q, qn, ef, ef_upper=efu)))
        rows = N_QUERIES if n < 100 else ROWWISE_ROWS  # the plain versions on the batch's first rows
        _same_bits(label, f"the plain versions ({name})", got,
                   search_cuda.hnsw_search_rowwise(dev, q[:rows], qn[:rows], ef, ef_upper=efu),
                   rows=None if rows == N_QUERIES else rows)
        filled = (got.slots >= 0).sum(1)
        if int(filled.max()) > n or not bool(torch.equal(got.slots >= 0, torch.isfinite(got.dists))):
            raise AssertionError(f"[{label}] {name}: rows hold {int(filled.max())} items of {n}, or an id without a distance")
        out[name] = {"items": n, "ef": ef, "ef_upper": efu, "launches": launches, "iters": int(got.iters)}
        out[name]["rows_hold"] = [int(filled.min()), int(filled.max())]
        if name.startswith("nan_rows"):
            # a NaN entry point: torch.argmin takes the first NaN one, and
            # no step improves on NaN, so every walk ends there
            dev.vectors[int(dev.entry_slots[dev.entry_slots >= 0][-1])] = float("nan")
            entry = next(int(e) for e in dev.entry_slots if e >= 0 and bool(torch.isnan(dev.vectors[e]).any()))
            cur = beam.greedy_descend(dev, q, qn, dev.max_level, 1)
            host = host_loops(lambda: beam.greedy_descend(dev, q, qn, dev.max_level, 1))
            plain = search_cuda.greedy_descend_rowwise(dev, q, qn, dev.max_level, 1)
            if not (torch.equal(cur, host) and torch.equal(cur, plain) and bool((cur == entry).all())):
                raise AssertionError(f"[{label}] a NaN entry point {entry}: the kernel ends on {cur[:6].tolist()}, the "
                                     f"host loop on {host[:6].tolist()}, the plain version on {plain[:6].tolist()}")
            out[name]["nan_entry_walks_end_there"] = True
        print(f"[{label}] {name}: {n} items at ef {ef}: rows hold {int(filled.min())}-{int(filled.max())} of them; the "
              f"search kernels ({launches}) equal the host loop and the plain versions bit for bit ({card})", flush=True)
    reset_counts()
    return out


def search_entries() -> list[dict]:
    """The kernel line's entries of the search kernels: one per kernel and
    form that the main path (phases 5-12) launched, with its launches there
    and, as its headline, phase 13's case of that kernel and form on the
    largest store (the layer-0 beam for ``beam_search``) whose plain
    version was timed."""
    replaces = {"beam_search": "hannoy_tpu/ops/beam.py:244", "greedy_descend": "hannoy_tpu/ops/beam.py:100"}
    entries = []
    for (kernel, row, family), launches in sorted(MAIN_SEARCH.items()):
        form = f"{row}/{family}"
        own = [c for c in SEARCH_CASES if c["kernel"] == kernel and c["form"] == form and c["search_ef"] == SEARCH_EF
               and c["plain_ms"] is not None and (kernel != "beam_search" or c["level"] == 0)]
        if not own:
            raise AssertionError(f"the main path launched {kernel} in {form}: phase 13 timed no such case")
        head = max(own, key=lambda c: c["store_rows"])
        levels = {str(level): n for (k, level), n in sorted(MAIN_SEARCH_LEVELS.items()) if k == kernel}
        print(f"{kernel}[{form}]: {launches} launches on the main path ({kernel} in all forms by level walked: "
              f"{json.dumps(levels)}); headline "
              f"{head['shape']} on {head['store_rows']} items: {head['ms']:.4f} ms, bound {head['bound_ms']:.4f} ms, host "
              f"loop {head['host_loop_ms']:.3f} ms, plain {head['plain_ms']:.3f} ms on {head['plain_rows']} rows", flush=True)
        entries.append({
            "name": f"{kernel}[{form}]", "route": "cuda", "source": "hannoy_tpu_torch/csrc/search.cu",
            # dense rows: a hop's rows staged at once, rank and merge by counts,
            # three barriers (one a step); packed rows: straight into registers
            "design": "register hop" if row == "packed" else "staged hop",
            "replaces": replaces[kernel], "launches": launches,
            "shape": head["shape"], "store_rows": head["store_rows"], "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "plain_rows": head["plain_rows"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "pair_floor_ms": head["pair_floor_ms"],
            "library_ms": None,  # no single PyTorch call runs a beam search or a greedy descent
            "call_ms": head["call_ms"], "host_loop_ms": head["host_loop_ms"], "us_per_hop": head["us_per_hop"],
            "max_row_hops": head["max_row_hops"], "dependent_loads": head["dependent_loads"],
            "baseline_ms": float(np.mean(head["against_baseline"]["baseline_ms"])) if "against_baseline" in head else None,
        })
    return entries


def search_turns(label: str, reader, queries, ef: int, card: str, profile: bool = False) -> dict:
    """``Reader.by_vecs`` by the search kernels and by the host loop (called
    directly), the same answers, then timed in turns (kernels, host, host,
    kernels; single calls, each ended by a synchronize); with ``profile``
    one call of each under the profiler for the device's idle share."""
    want = reader.by_vecs(queries, n=K, ef_search=ef)
    if host_loops(lambda: reader.by_vecs(queries, n=K, ef_search=ef)) != want:
        raise AssertionError(f"[{label}] by_vecs at ef {ef}: the host loop answers otherwise than the search kernels")
    device = reader._dev.vectors.device
    t = {"kernels": [], "host_loop": []}
    for who in ("kernels", "host_loop", "host_loop", "kernels"):
        call = lambda: reader.by_vecs(queries, n=K, ef_search=ef)  # noqa: E731
        t[who].append(one_call(device, call if who == "kernels" else lambda: host_loops(call)))
    out = {who: {"qps": N_QUERIES / float(np.median(v)), "seconds": v} for who, v in t.items()}
    if profile:
        # PROFILED_CALLS calls in a row under the profiler: a single call of
        # a few ms may end before the profiler has collected its events
        for who in ("kernels", "host_loop"):
            call = lambda: reader.by_vecs(queries, n=K, ef_search=ef)  # noqa: E731
            fn = call if who == "kernels" else lambda: host_loops(call)
            out[who]["profiled"] = profiled(lambda: sum(one_call(device, fn) for _ in range(PROFILED_CALLS)), label,
                                            f"{PROFILED_CALLS} calls of by_vecs ef={ef} by the {who}")
    print(f"[{label}] by_vecs ef={ef}, in turns: the search kernels {out['kernels']['qps']:.1f} QPS, the host loop "
          f"{out['host_loop']['qps']:.1f} QPS (same answers) ({card})", flush=True)
    return out


#: launches of the main path (phases 5-12) per form "row/family" → {"launches", "by_shape"}
MAIN_PATH: dict[str, dict] = {}
#: launches of the main path per (row type, kernel design)
MAIN_DESIGNS: dict[tuple[str, str], int] = {}
#: launches of phase 12 (f32 cosine rows, a store of N_SCALE items) per "BxK"
SCALE_LAUNCHES: dict[str, int] = {}
#: the search kernels' launches on the main path (phases 5-12) per (kernel, row type, family)
MAIN_SEARCH: dict[tuple[str, str, str], int] = {}
#: the search kernels' launches on the main path per (kernel, level walked)
MAIN_SEARCH_LEVELS: dict[tuple[str, int], int] = {}
#: per main-path step (``count_main_path``'s label): the gather kernel's
#: launches and the search kernels' per kernel
STEP_LAUNCHES: dict[str, dict] = {}


def reset_counts() -> None:
    """Every kernel's launch counts to 0: the gather kernel's and the
    search kernels'."""
    from hannoy_tpu_torch.ops import beam_cuda, search_cuda

    beam_cuda.KERNEL.reset_counts()
    search_cuda.KERNELS.reset_counts()


def all_launches() -> int:
    """Launches of the gather kernel and the search kernels since their
    last reset (the spans' probe)."""
    from hannoy_tpu_torch.ops import beam_cuda, search_cuda

    return beam_cuda.KERNEL.launches + sum(search_cuda.KERNELS.launches.values())


def count_main_path(step: str) -> dict:
    """Add the kernels' counts since their last reset (one step of the main
    path, counted from 0) to ``MAIN_PATH`` (the gather kernel) and
    ``MAIN_SEARCH`` (the search kernels) → that step's gather launches per
    form; ``STEP_LAUNCHES[step]`` keeps both kernels' launches of the step.
    A step that ran one form gives that form its launches per [B, K]."""
    from hannoy_tpu_torch.ops import beam_cuda, search_cuda

    kernel = beam_cuda.KERNEL
    for key, n in search_cuda.KERNELS.by_form.items():
        MAIN_SEARCH[key] = MAIN_SEARCH.get(key, 0) + n
    for key, n in search_cuda.KERNELS.by_level.items():
        MAIN_SEARCH_LEVELS[key] = MAIN_SEARCH_LEVELS.get(key, 0) + n
    STEP_LAUNCHES[step] = {"gather": kernel.launches, "search": dict(search_cuda.KERNELS.launches)}
    forms = {f"{row}/{family}": n for (row, family), n in kernel.by_form.items()}
    if sum(forms.values()) != kernel.launches or sum(kernel.by_design.values()) != kernel.launches:
        raise AssertionError(f"[{step}] launches per form {forms} or per design {kernel.by_design} do not add up "
                             f"to {kernel.launches}")
    for key, n in kernel.by_design.items():
        MAIN_DESIGNS[key] = MAIN_DESIGNS.get(key, 0) + n
    for form, n in forms.items():
        entry = MAIN_PATH.setdefault(form, {"launches": 0, "by_shape": {}})
        entry["launches"] += n
        if len(forms) == 1:
            for shape, m in _shapes(kernel.by_shape).items():
                entry["by_shape"][shape] = entry["by_shape"].get(shape, 0) + m
    return forms


def drive(device, data, queries, label: str, main_path: bool = False, **opts) -> dict:
    """Stage → build → validate → upload → search, with recall; the kernel
    launches counted around the build and around the search."""
    import torch

    from hannoy_tpu_torch import default_ef_upper, flat_topk, hnsw_search
    from hannoy_tpu_torch.models.hnsw import to_device
    from hannoy_tpu_torch.ops import beam_cuda, distances, search_cuda

    metric = distances.COSINE
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    g, stats, build_s, spans = timed_build(device, data, **opts)
    build_launches, build_shapes = beam_cuda.KERNEL.launches, _shapes(beam_cuda.KERNEL.by_shape)
    build_search = dict(search_cuda.KERNELS.launches)
    if main_path:
        count_main_path(f"{label}: build")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    print(f"[{label}] build: {N} x {DIM} cosine in {build_s:.3f} s ({N / build_s:.1f} vec/s), waves {stats.waves}, "
          f"beam iters {stats.beam_iters}, max_level {g.max_level}, kernel launches {build_launches} {build_shapes}, "
          f"search kernel launches {build_search}, "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
    t0 = time.perf_counter()
    g.check_validity()
    print(f"[{label}] check_validity passed in {time.perf_counter() - t0:.3f} s", flush=True)

    dev = to_device(g, device, serve_only=True)
    q = torch.from_numpy(queries).to(device)
    qn = torch.from_numpy(distances.np_norms(metric, queries)).to(device)
    exact_d, _ = flat_topk(metric.name, q, qn, dev.vectors, dev.norms, dev.valid, K)
    # the oracle itself against numpy on a few queries
    few = distances.np_pairwise(metric, queries[:8], distances.np_norms(metric, queries[:8]), data, g.norms[:N])
    np.testing.assert_allclose(exact_d[:8].cpu().numpy(), np.sort(few, axis=1)[:, :K], rtol=0, atol=1e-5)
    thresh = exact_d[:, K - 1 : K] + 1e-6

    reset_counts()
    results = {}
    for ef in EF_SWEEP:
        efu = default_ef_upper(N, ef)
        res = hnsw_search(dev, q, qn, ef, ef_upper=efu)  # warm-up
        _sync(device)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            res = hnsw_search(dev, q, qn, ef, ef_upper=efu)
        _sync(device)
        dt = (time.perf_counter() - t0) / reps
        if res.dists.shape != (N_QUERIES, ef) or not torch.isfinite(res.dists[:, :K]).all():
            raise AssertionError(f"[{label}] search at ef={ef} returned non-finite or mis-shaped results")
        if not ((res.slots[:, :K] >= 0) & (res.slots[:, :K] < N)).all():
            raise AssertionError(f"[{label}] search at ef={ef} returned slots outside the index")
        recall = float((res.dists[:, :K] <= thresh).float().mean())
        results[ef] = {"recall_at_10": recall, "qps": N_QUERIES / dt, "ef_upper": efu, "iters": int(res.iters)}
        print(f"[{label}] search ef={ef} ef_upper={efu}: recall@10 {recall:.4f}, {N_QUERIES / dt:.1f} QPS "
              f"({dt * 1e3:.3f} ms per {N_QUERIES}-query batch), beam iters {int(res.iters)}", flush=True)
    search_launches, search_shapes = beam_cuda.KERNEL.launches, _shapes(beam_cuda.KERNEL.by_shape)
    search_kernels = dict(search_cuda.KERNELS.launches)
    if main_path:
        count_main_path(f"{label}: search")
    calls = 6 * len(EF_SWEEP)
    print(f"[{label}] search: gather kernel launches {search_launches} {search_shapes}, search kernel launches "
          f"{search_kernels} in {calls} calls", flush=True)
    if results[EF_SWEEP[-1]]["recall_at_10"] < RECALL_BAR:
        raise AssertionError(f"[{label}] recall@10 at ef={EF_SWEEP[-1]} below {RECALL_BAR}: {results}")
    if build_launches + sum(build_search.values()) == 0:
        raise AssertionError(f"[{label}] no kernel ran in the build")
    if search_launches or not calls <= sum(search_kernels.values()) <= 3 * calls:
        raise AssertionError(f"[{label}] the searches did not go through the search kernels alone: gather "
                             f"{search_launches}, search kernels {search_kernels} in {calls} calls")
    return {
        "build_s": build_s, "build_launches": build_launches, "search_launches": search_launches,
        "build_search_kernel_launches": build_search, "search_kernel_launches": search_kernels,
        "build_launches_by_shape": build_shapes, "search_launches_by_shape": search_shapes,
        "peak_bytes": peak, "span_names": sorted({s.name for s in spans}), "search": results,
    }


def _print_spans(label: str, spans, skip=("insert_wave",)) -> dict:
    """Print the fenced spans of one API step (summed by name, with the
    kernel launches made inside each) → {name: {count, ms, launches}}."""
    table: dict[str, list] = {}
    for s in spans:
        row = table.setdefault(s.name, [0, 0.0, 0])
        row[0] += 1
        row[1] += s.ms
        row[2] += s.probed or 0
    for name, (count, ms, launches) in table.items():
        if name not in skip:
            print(f"[{label}]   span {name}: {count} x, {ms:.2f} ms, kernel launches {launches}", flush=True)
    return {k: {"count": c, "ms": ms, "launches": n} for k, (c, ms, n) in table.items()}


def api_path(device, path: str, data, queries, card: str) -> dict:
    """Phase 6: add → build → commit → search → close → reopen → search →
    append → build → commit → search, through Database / Writer / Reader,
    in the empty directory ``path`` (phase 9 reopens it). Every span is
    fenced; nothing is caught."""
    import torch

    from hannoy_tpu_torch import Database, Metric, default_ef_upper, flat_topk, hnsw_search
    from hannoy_tpu_torch.ops import beam_cuda, distances
    from hannoy_tpu_torch.utils import tracing

    label = "phase 6: API path"
    kernel = beam_cuda.KERNEL
    ef = EF_SWEEP[-1]

    def recorded():
        return tracing.record(fence=lambda: _sync(device), probe=all_launches)

    def timed(what: str, fn):
        return _timed(label, card, device, what, fn)

    out: dict = {"seconds": {}, "spans": {}, "launches_by_shape": {}}
    reset_counts()
    # ---- step 1: add → build (bulk) → commit → search ----
    db = Database(path, Metric.COSINE, map_size=API_MAP_SIZE)
    if db.device.type != device.type:
        raise AssertionError(f"[{label}] the Database's default device is {db.device}, not {device}")
    writer = db.writer(dimensions=DIM, m=M, ef=EFC)
    _, out["seconds"]["add_items"] = timed(f"add_items of {N} x {DIM}", lambda: writer.add_items(range(N), data))
    with recorded() as spans:
        stats, out["seconds"]["build"] = timed("build (fenced spans)", lambda: writer.builder(seed=42).build())
    out["spans"]["build"] = _print_spans(label, spans)
    if "bulk_build" not in out["spans"]["build"]:
        raise AssertionError(f"[{label}] the Writer's default build did not take the bulk path")
    print(f"[{label}] build touched {len(stats.touched)} rows, kernel launches {kernel.launches} "
          f"{_shapes(kernel.by_shape)}", flush=True)
    _, out["seconds"]["commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    with recorded() as spans:
        reader, out["seconds"]["reader_cached"] = timed("Reader.open (graph cached by the build)", db.reader)
    out["spans"]["reader_cached"] = _print_spans(label, spans)
    before, _ = timed(f"Reader.by_vecs, first call, ef={ef}", lambda: reader.by_vecs(queries, n=K, ef_search=ef))
    out["launches_by_shape"]["build_and_search"] = _shapes(kernel.by_shape)
    step1 = all_launches()
    count_main_path(f"{label}: build and search")
    db.close()

    # ---- step 2: reopen → the same answers, recall, validity ----
    reset_counts()
    db, out["seconds"]["reopen"] = timed("Database reopen (native store)", lambda: Database(path, Metric.COSINE, map_size=API_MAP_SIZE))
    with recorded() as spans:
        reader, out["seconds"]["reader_open"] = timed("Reader.open (load from the store + upload)", db.reader)
    out["spans"]["reader_open"] = _print_spans(label, spans)
    if reader.n_items() != N:
        raise AssertionError(f"[{label}] reopened index has {reader.n_items()} items, expected {N}")
    after = reader.by_vecs(queries, n=K, ef_search=ef)
    if after != before:
        diff = sum(a != b for a, b in zip(after, before))
        raise AssertionError(f"[{label}] {diff} of {N_QUERIES} answers changed across close and reopen")
    print(f"[{label}] the {N_QUERIES} answers are the same before the close and after the reopen", flush=True)
    metric = distances.COSINE
    q, qn = reader._prep_queries(queries)
    exact_d, _ = flat_topk(metric.name, q, qn, reader._dev.vectors, reader._dev.norms, reader._dev.valid, K)
    thresh = (exact_d[:, K - 1] + 1e-6).cpu().numpy()
    if not all(len(row) == K for row in after):
        raise AssertionError(f"[{label}] a query came back with fewer than {K} results")
    recall = float(np.mean([[d <= thresh[b] for _, d in row] for b, row in enumerate(after)]))
    # by id too, as phase 8 reads euclidean: the exact top-10 of the data itself (slot == item id)
    valid = torch.ones(N, dtype=torch.bool, device=device)
    exact_ids = flat_topk(metric.name, q, qn, torch.from_numpy(data).to(device),
                          torch.from_numpy(distances.np_norms(metric, data)).to(device), valid, K)[1].cpu().numpy()
    out["recall_at_10_by_id"] = float(np.mean([len({i for i, _ in row} & set(exact_ids[b].tolist()))
                                               for b, row in enumerate(after)])) / K
    print(f"[{label}] recall@10 at ef={ef} through Reader.by_vecs: {recall:.4f} (by id {out['recall_at_10_by_id']:.4f})",
          flush=True)
    if recall < RECALL_BAR:
        raise AssertionError(f"[{label}] recall@10 {recall} below {RECALL_BAR}")
    _, out["seconds"]["assert_validity"] = timed(f"Reader.assert_validity on the {N}-item index", reader.assert_validity)

    # the API's host cost: by_vecs against the engine on the same graph,
    # in turns after a warm-up of each, medians of the single calls.
    # A by_vecs call's own "reader_search" span (hnsw_search and the one
    # transfer of its result) says how much of it is the search: the
    # rest is the API's host work, whatever the card did between turns.
    efu = default_ef_upper(N, ef)

    def engine():
        hnsw_search(reader._dev, q, qn, ef, max_iters=2 * ef + 16, ef_upper=efu)

    for _ in range(2):
        reader.by_vecs(queries, n=K, ef_search=ef)
        engine()
    reps = 7
    times: dict[str, list] = {"by_vecs": [], "of which reader_search": [], "hnsw_search": []}
    for _ in range(reps):
        with tracing.record() as spans:
            times["by_vecs"].append(one_call(device, lambda: reader.by_vecs(queries, n=K, ef_search=ef)))
        times["of which reader_search"].append(sum(s.ms for s in spans if s.name == "reader_search") / 1e3)
        times["hnsw_search"].append(one_call(device, engine))
    med = {name: float(np.median(t)) for name, t in times.items()}
    out["qps"] = {name: N_QUERIES / med[name] for name in ("by_vecs", "hnsw_search")}
    out["api_host_ms_per_batch"] = (med["by_vecs"] - med["of which reader_search"]) * 1e3
    print(f"[{label}] ef={ef}, medians of {reps} calls in turns: Reader.by_vecs {out['qps']['by_vecs']:.1f} QPS "
          f"({med['by_vecs'] * 1e3:.3f} ms per {N_QUERIES}-query batch, of which its search and transfer "
          f"{med['of which reader_search'] * 1e3:.3f} ms: the API's host cost is "
          f"{out['api_host_ms_per_batch']:.3f} ms per batch); hnsw_search alone on the same graph "
          f"{out['qps']['hnsw_search']:.1f} QPS ({med['hnsw_search'] * 1e3:.3f} ms) ({card})", flush=True)
    out["launches_by_shape"]["reopen_and_search"] = _shapes(kernel.by_shape)
    step2 = all_launches()
    count_main_path(f"{label}: reopen and search")
    # phase 13 on this database: the search kernels against the host loop
    # and their plain versions, each kernel timed; by_vecs in turns
    out["search_kernels"] = search_kernel_checks("phase 13 on phase 6's database", reader, queries, card, slack=True,
                                                 timing_efs=SCALE_EF)
    out["search_turns"] = search_turns(label, reader, queries, ef, card, profile=True)

    # ---- step 3: append after the reopen → incremental build ----
    reset_counts()
    extra = bench_append(N_APPEND)
    writer = db.writer(dimensions=DIM, m=M, ef=EFC)
    _, out["seconds"]["append_add_items"] = timed(f"add_items of {N_APPEND} more", lambda: writer.add_items(range(N, N + N_APPEND), extra))
    with recorded() as spans:
        stats, out["seconds"]["append_build"] = timed("append build (fenced spans)", lambda: writer.builder(seed=42).build())
    out["spans"]["append_build"] = sp = _print_spans(label, spans)
    for need in ("fork_graph", "fill_link_dists"):  # the Reader's loaded graph, forked; its distances filled
        if need not in sp:
            raise AssertionError(f"[{label}] the append did not go through {need}")
    if sp["fill_link_dists"]["launches"] == 0:
        raise AssertionError(f"[{label}] fill_link_dists launched no kernel")
    print(f"[{label}] append touched {len(stats.touched)} rows in {stats.waves} waves; "
          f"fill_link_dists launched the kernel {sp['fill_link_dists']['launches']} times", flush=True)
    _, out["seconds"]["append_commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    reader = db.reader()
    if reader.n_items() != N + N_APPEND:
        raise AssertionError(f"[{label}] index has {reader.n_items()} items after the append")
    # each appended vector as a query; the ones that miss themselves
    # are those whose insertion found few, far candidates (their
    # layer-0 out-degree says so)
    g = reader._graph
    firsts = reader.by_vecs(extra, n=1, ef_search=ef)
    found = np.asarray([bool(row) and row[0][0] == N + i for i, row in enumerate(firsts)])
    self_hit = float(found.mean())
    outdeg = (g.links0[[g.id_to_slot[N + i] for i in range(N_APPEND)]] >= 0).sum(1)
    print(f"[{label}] {N_APPEND} appended items find themselves first in {self_hit:.4f} of rows at ef={ef} "
          f"(index now {reader.n_items()} items); layer-0 out-degree: median {int(np.median(outdeg))} of those "
          f"found, {sorted(outdeg[~found].tolist())} of the {int((~found).sum())} missed", flush=True)
    if self_hit < SELF_HIT_BAR:
        raise AssertionError(f"[{label}] self-hit {self_hit} below {SELF_HIT_BAR}")
    g.check_validity()
    out["launches_by_shape"]["append"] = _shapes(kernel.by_shape)
    step3 = all_launches()
    count_main_path(f"{label}: append")
    db.close()
    out.update(recall_at_10=recall, self_hit=self_hit, launches=step1 + step2 + step3,
               launches_by_step={"build_and_search": step1, "reopen_and_search": step2, "append": step3})
    print(f"[{label}] kernel launches by [B, K]: {json.dumps(out['launches_by_shape'])}", flush=True)
    if min(step1, step2, step3) == 0:
        raise AssertionError(f"[{label}] a step launched no kernel: {out['launches_by_step']}")
    return out


def _timed(label: str, card: str, device, what: str, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"[{label}] {what}: {dt:.3f} s ({card})", flush=True)
    return out, dt


def _tie_aware_recall(label: str, reader, queries, answers, metric) -> float:
    """recall@K of ``answers`` (``by_vecs`` rows) against ``flat_topk`` on
    the Reader's own device rows: the share of returned distances within
    the exact K-th distance + 1e-6 (packed distances tie heavily)."""
    from hannoy_tpu_torch import flat_topk

    q, qn = reader._prep_queries(queries)
    exact_d, _ = flat_topk(metric.name, q, qn, reader._dev.vectors, reader._dev.norms, reader._dev.valid, K)
    thresh = (exact_d[:, K - 1] + 1e-6).cpu().numpy()
    if not all(len(row) == K for row in answers):
        raise AssertionError(f"[{label}] a query came back with fewer than {K} results")
    return float(np.mean([[d <= thresh[b] for _, d in row] for b, row in enumerate(answers)]))


def _n_links_records(db) -> int:
    """Links records of index 0 as the shared write transaction sees them."""
    from hannoy_tpu_torch.store.schema import Prefix

    return sum(1 for _ in db._db.prefix_iter(db._wtxn(), Prefix.links(0)))


def packed_path(device, data, queries, card: str) -> dict:
    """Phase 7: the packed metrics through Database / Writer / Reader."""
    from hannoy_tpu_torch import Database, Metric
    from hannoy_tpu_torch.ops import beam_cuda, codecs, distances, search_cuda
    from hannoy_tpu_torch.utils import tracing

    label = "phase 7: packed API path"
    kernel = beam_cuda.KERNEL
    ef = EF_SWEEP[-1]
    out: dict = {"seconds": {}, "spans": {}, "recall_at_10": {}, "launches": {}}

    def recorded():
        return tracing.record(fence=lambda: _sync(device), probe=all_launches)

    def timed(what, fn):
        return _timed(label, card, device, what, fn)

    def need_form(step: str, forms: dict, form: str = "packed/popcount") -> None:
        # the gather kernel's launches and the search kernels' (packed rows of
        # the pair design search on the kernels, the builds gather)
        searched = {f"{row}/{family}" for _, row, family in search_cuda.KERNELS.by_form}
        if set(forms) | searched != {form}:
            raise AssertionError(f"[{label}] {step} launched {forms} (gather) and {searched} (search), expected only {form}")
        out["launches"][step] = forms.get(form, 0)

    # ---- (a) BQ cosine, 100k: add → bulk build → commit → search → reopen ----
    metric = distances.BQ_COSINE
    with tempfile.TemporaryDirectory() as path:
        reset_counts()
        db = Database(path, Metric.BQ_COSINE, map_size=API_MAP_SIZE)
        writer = db.writer(dimensions=DIM, m=M, ef=EFC)
        _, out["seconds"]["bq_add_items"] = timed(f"BQ cosine add_items of {N} x {DIM}", lambda: writer.add_items(range(N), data))
        with recorded() as spans:
            stats, out["seconds"]["bq_build"] = timed("BQ cosine build (fenced spans)", lambda: writer.builder(seed=42).build())
        out["spans"]["bq_build"] = _print_spans(label, spans, skip=())
        if "bulk_build" not in out["spans"]["bq_build"]:
            raise AssertionError(f"[{label}] the BQ cosine build of {N} items did not take the bulk path")
        _, out["seconds"]["bq_commit"] = timed("commit_rw_txn", db.commit_rw_txn)
        reader = db.reader()
        if reader._dev.vectors.dtype != distances.device_dtype(metric) or reader._dev.vectors.shape[1] != DIM // 32:
            raise AssertionError(f"[{label}] BQ rows on the device are {reader._dev.vectors.dtype} {tuple(reader._dev.vectors.shape)}")
        before, out["seconds"]["bq_first_by_vecs"] = timed(f"Reader.by_vecs, first call, ef={ef}", lambda: reader.by_vecs(queries, n=K, ef_search=ef))
        print(f"[{label}] BQ cosine build touched {len(stats.touched)} rows; kernel launches {kernel.launches} "
              f"{_shapes(kernel.by_shape)}", flush=True)
        need_form("bq_build_and_search", count_main_path(f"{label}: BQ build and search"))
        db.close()

        reset_counts()
        db, out["seconds"]["bq_reopen"] = timed("Database reopen", lambda: Database(path, Metric.BQ_COSINE, map_size=API_MAP_SIZE))
        reader, out["seconds"]["bq_reader_open"] = timed("Reader.open (load + upload)", db.reader)
        after = reader.by_vecs(queries, n=K, ef_search=ef)
        # Packed distances tie (integers out of 768): a reloaded graph's
        # link rows come back in id order, the built one's are in distance
        # order, and ties in the beam's pool then fall to other items. The
        # answers must be the same up to that: the same distances, row for row.
        changed = sum([d for _, d in a] != [d for _, d in b] for a, b in zip(after, before))
        out["bq_rows_with_other_tied_ids"] = sum(a != b for a, b in zip(after, before))
        if changed or reader.n_items() != N:
            raise AssertionError(f"[{label}] {changed} of {N_QUERIES} BQ answers changed their distances across close "
                                 f"and reopen, or {reader.n_items()} items")
        _, out["seconds"]["bq_assert_validity"] = timed("Reader.assert_validity", reader.assert_validity)
        recall = _tie_aware_recall(label, reader, queries, after, metric)
        # the oracle itself against numpy on a few queries
        lanes = codecs.pack(queries[:4], metric.codec)
        few = distances.np_pairwise(metric, lanes, distances.np_norms(metric, lanes),
                                    reader._graph.vectors[:N], reader._graph.norms[:N])
        best = np.sort(few, axis=1)[:, 0]
        got = np.asarray([row[0][1] for row in after[:4]])
        if not (got >= best - 1e-6).all():
            raise AssertionError(f"[{label}] a BQ answer lies below numpy's least distance: {got} < {best}")
        t = [one_call(device, lambda: reader.by_vecs(queries, n=K, ef_search=ef)) for _ in range(5)]
        out["recall_at_10"]["bq_cosine"] = recall
        out["bq_qps"] = N_QUERIES / float(np.median(t))
        print(f"[{label}] BQ cosine {N} x {DIM}: the {N_QUERIES} answers hold the same distances after the reopen "
              f"({out['bq_rows_with_other_tied_ids']} rows name other items among ties); recall@10 at ef={ef} "
              f"{recall:.4f}; Reader.by_vecs {out['bq_qps']:.1f} QPS (median of 5 calls) ({card})", flush=True)
        if recall < RECALL_BAR:
            raise AssertionError(f"[{label}] BQ cosine recall@10 {recall} below {RECALL_BAR}")
        need_form("bq_reopen_and_search", count_main_path(f"{label}: BQ reopen and search"))
        # phase 13 on this database: the search kernels' packed form at 768
        # bits (its plain versions are timed on (d)'s shape)
        out["search_kernels"] = search_kernel_checks("phase 13 on phase 7's BQ cosine database", reader, queries, card)
        db.close()

    # ---- (b) HAMMING, 20k, insertion waves: the packed wave hop and flat candidates ----
    metric = distances.HAMMING
    with tempfile.TemporaryDirectory() as path:
        reset_counts()
        db = Database(path, Metric.HAMMING, map_size=API_MAP_SIZE)
        writer = db.writer(dimensions=DIM, m=M, ef=EFC)
        writer.add_items(range(N_HAMMING), data[:N_HAMMING])
        with recorded() as spans:
            stats, out["seconds"]["hamming_build"] = timed(
                f"HAMMING wave build of {N_HAMMING} x {DIM}", lambda: writer.builder(seed=42).bulk(False).wave_size(WAVE).build())
        sp = out["spans"]["hamming_build"] = _print_spans(label, spans, skip=())
        if "bulk_build" in sp or "insert_wave" not in sp:
            raise AssertionError(f"[{label}] the HAMMING build did not go by waves: {sorted(sp)}")
        db.commit_rw_txn()
        reader = db.reader()
        reader.assert_validity()
        answers = reader.by_vecs(queries, n=K, ef_search=ef)
        recall = out["recall_at_10"]["hamming"] = _tie_aware_recall(label, reader, queries, answers, metric)
        print(f"[{label}] HAMMING {N_HAMMING} x {DIM} by {stats.waves} waves: recall@10 at ef={ef} {recall:.4f}; "
              f"kernel launches {kernel.launches} {_shapes(kernel.by_shape)}", flush=True)
        if recall < RECALL_BAR:
            raise AssertionError(f"[{label}] HAMMING recall@10 {recall} below {RECALL_BAR}")
        need_form("hamming_build_and_search", count_main_path(f"{label}: HAMMING wave build and search"))
        db.close()

    # ---- (c) the migration: cosine → BQ cosine, links kept ----
    with tempfile.TemporaryDirectory() as path:
        reset_counts()
        db = Database(path, Metric.COSINE, map_size=API_MAP_SIZE)
        writer = db.writer(dimensions=DIM, m=M, ef=EFC)
        writer.add_items(range(N), data)
        _, out["seconds"]["migration_cosine_build"] = timed("cosine build before the migration", lambda: writer.builder(seed=42).build())
        db.commit_rw_txn()
        need_form("migration_cosine_build", count_main_path(f"{label}: cosine build before the migration"), "f32/dot")
        reset_counts()
        links_before = _n_links_records(db)
        writer2, out["seconds"]["prepare_changing_distance"] = timed(
            "prepare_changing_distance(Metric.BQ_COSINE)", lambda: writer.prepare_changing_distance(Metric.BQ_COSINE))
        links_after = _n_links_records(db)
        if links_after != links_before or links_before < N:
            raise AssertionError(f"[{label}] the fast path kept {links_after} of {links_before} links records")
        with recorded() as spans:
            stats, out["seconds"]["migration_build"] = timed("build after the prepare (fenced spans)", lambda: writer2.builder(seed=42).build())
        sp = out["spans"]["migration_build"] = _print_spans(label, spans, skip=())
        for need in ("load_graph", "fill_link_dists"):
            if need not in sp:
                raise AssertionError(f"[{label}] the migration build did not go through {need}")
        writer2._database.commit_rw_txn()
        db.close()
        db = Database(path, Metric.BQ_COSINE, map_size=API_MAP_SIZE)
        reader = db.reader()
        reader.assert_validity()
        answers = reader.by_vecs(queries, n=K, ef_search=ef)
        recall = out["recall_at_10"]["migrated_bq_cosine"] = _tie_aware_recall(label, reader, queries, answers, distances.BQ_COSINE)
        print(f"[{label}] cosine -> BQ cosine: {links_before} links records before the prepare, {links_after} after; "
              f"{reader.n_items()} items; recall@10 at ef={ef} {recall:.4f}; kernel launches {kernel.launches} "
              f"{_shapes(kernel.by_shape)}", flush=True)
        if recall < RECALL_BAR or reader.n_items() != N:
            raise AssertionError(f"[{label}] migrated recall@10 {recall} below {RECALL_BAR}, or {reader.n_items()} items")
        need_form("migration_build_and_search", count_main_path(f"{label}: migration build and search"))
        db.close()

    # ---- (d) HAMMING at 1,536 bits, M 16, efc 64: the benchmark's hamming cell's shape ----
    metric = distances.HAMMING
    wide, wide_queries = bench_data(np.random.default_rng(44), dim=HAMMING_DIM)
    with tempfile.TemporaryDirectory() as path:
        reset_counts()
        db = Database(path, Metric.HAMMING, map_size=API_MAP_SIZE)
        writer = db.writer(dimensions=HAMMING_DIM, m=M, ef=HAMMING_EFC)
        writer.add_items(range(N), wide)
        del wide
        _, out["seconds"]["hamming_1536_build"] = timed(
            f"HAMMING build of {N} x {HAMMING_DIM} (M {M}, efc {HAMMING_EFC})", lambda: writer.builder(seed=42).build())
        db.commit_rw_txn()
        reader = db.reader()
        if reader._dev.vectors.shape[1] != HAMMING_DIM // 32:
            raise AssertionError(f"[{label}] HAMMING rows on the device are {tuple(reader._dev.vectors.shape)}")
        answers = reader.by_vecs(wide_queries, n=K, ef_search=ef)
        recall = out["recall_at_10"]["hamming_1536"] = _tie_aware_recall(label, reader, wide_queries, answers, metric)
        print(f"[{label}] HAMMING {N} x {HAMMING_DIM}: recall@10 at ef={ef} {recall:.4f}; search launches "
              f"{dict(search_cuda.KERNELS.launches)}", flush=True)
        if recall < RECALL_BAR:
            raise AssertionError(f"[{label}] HAMMING recall@10 at {HAMMING_DIM} bits {recall} below {RECALL_BAR}")
        need_form("hamming_1536_build_and_search", count_main_path(f"{label}: HAMMING build and search at 1,536 bits"))
        # phase 13 on this database: the packed form at [256, 100, 32, 48],
        # its plain versions timed (the packed entries' headline)
        out["search_kernels_hamming_1536"] = search_kernel_checks(
            f"phase 13 on phase 7's {HAMMING_DIM}-bit HAMMING database", reader, wide_queries, card, plain_timing=True)
        PLAIN_TIMED.add("packed/popcount")
        db.close()
    return out


def one_call(device, fn) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def tier_path(device, data, queries, card: str) -> dict:
    """Phase 8: the storage tiers through Database(tier=) / Writer / Reader."""
    import torch

    from hannoy_tpu_torch import Database, Metric, flat_topk
    from hannoy_tpu_torch.ops import beam_cuda, distances, search_cuda

    label = "phase 8: storage tiers"
    kernel = beam_cuda.KERNEL
    ef = EF_SWEEP[-1]
    out: dict = {}
    rows_f32 = torch.from_numpy(data).to(device)
    valid = torch.ones(N, dtype=torch.bool, device=device)
    q = torch.from_numpy(queries).to(device)
    exact = {}
    for name in sorted({name for name, _, _ in TIER_CELLS}):
        metric = distances.by_name(name)
        nrm = torch.from_numpy(distances.np_norms(metric, data)).to(device)
        qn = torch.from_numpy(distances.np_norms(metric, queries)).to(device)
        exact[name] = flat_topk(name, q, qn, rows_f32, nrm, valid, K)[1].cpu().numpy()  # slot == item id
    del rows_f32, valid, q
    for name, tier, build in TIER_CELLS:
        key = f"{name}/{tier}" + ("/waves" if build == "waves" else "")
        cell = out[key] = {}
        metric = distances.by_name(name)
        with tempfile.TemporaryDirectory() as path:
            reset_counts()
            db = Database(path, Metric(name), map_size=API_MAP_SIZE, tier=tier)
            writer = db.writer(dimensions=DIM, m=M, ef=EFC)
            writer.add_items(range(N), data)

            def builder():
                hb = writer.builder(seed=42)
                return hb.bulk(False).wave_size(WAVE) if build == "waves" else hb

            with_spans, cell["build_s"] = _timed(label, card, device, f"{key} build of {N} x {DIM}",
                                                 lambda: _spans_of(lambda: builder().build()))
            if ("bulk_build" in with_spans) != (build == "default"):
                raise AssertionError(f"[{label}] the {key} build took the wrong path: {sorted(with_spans)}")
            db.commit_rw_txn()
            cuda = device.type == "cuda"
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device) if cuda else 0
            reader = db.reader()
            _sync(device)
            cell["reader_bytes"] = torch.cuda.memory_allocated(device) - base if cuda else 0
            cell["reader_peak_bytes"] = torch.cuda.max_memory_allocated(device) - base if cuda else 0
            cell["row_bytes"] = reader._dev.vectors.element_size() * reader._dev.vectors.shape[1]
            want_dtype = {"raw": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[tier]
            if reader._dev.vectors.dtype != want_dtype:
                raise AssertionError(f"[{label}] {name} {tier}: device rows are {reader._dev.vectors.dtype}")
            answers = reader.by_vecs(queries, n=K, ef_search=ef)
            found = [{i for i, _ in row} for row in answers]
            # the tier's own exact top-10 (an exact scan of the rows the
            # Reader holds): what the encoding keeps of the f32 answer, and
            # what the graph search keeps of the tier's
            tq, tqn = reader._prep_queries(queries)
            own = flat_topk(name, tq, tqn, reader._dev.vectors, reader._dev.norms, reader._dev.valid, K)[1].cpu().numpy()

            def overlap(a, b) -> float:
                return float(np.mean([len(set(a[r]) & set(b[r])) for r in range(N_QUERIES)])) / K

            cell["recall_at_10"] = overlap(found, exact[name].tolist())
            cell["recall_at_10_own_rows"] = overlap(found, own.tolist())
            cell["exact_scan_recall_at_10"] = overlap(own.tolist(), exact[name].tolist())
            if tier == "raw":
                # the triage: recall by id (as phase 6 also reads cosine) at ef and at TRIAGE_EF
                wide = reader.by_vecs(queries, n=K, ef_search=TRIAGE_EF)
                cell["recall_at_10_by_ef"] = {
                    ef: cell["recall_at_10"], TRIAGE_EF: overlap([{i for i, _ in row} for row in wide], exact[name].tolist())}
                print(f"[{label}] {key} triage: recall@10 by id at ef {ef} / {TRIAGE_EF}: "
                      f"{cell['recall_at_10_by_ef'][ef]:.4f} / {cell['recall_at_10_by_ef'][TRIAGE_EF]:.4f}", flush=True)
            t = [one_call(device, lambda: reader.by_vecs(queries, n=K, ef_search=ef)) for _ in range(5)]
            cell["qps"] = N_QUERIES / float(np.median(t))
            reader.assert_validity()
            forms = count_main_path(f"{label}: {key}")
            form = "/".join(beam_cuda.form_of(metric, want_dtype))
            searched = {f"{row}/{family}" for _, row, family in search_cuda.KERNELS.by_form}
            if not set(forms) <= {form} or searched != {form}:
                raise AssertionError(f"[{label}] {name} {tier} launched {forms} (gather) and {searched} (search), "
                                     f"expected only {form}")
            cell["launches"] = forms.get(form, 0)
            cell["search_kernel_launches"] = dict(search_cuda.KERNELS.launches)
            print(f"[{label}] {key}: recall@10 at ef={ef} against the exact f32 top-10 {cell['recall_at_10']:.4f} "
                  f"(an exact scan of the tier's rows reaches {cell['exact_scan_recall_at_10']:.4f}), against the exact "
                  f"top-10 of the tier's rows {cell['recall_at_10_own_rows']:.4f}; "
                  f"Reader.by_vecs {cell['qps']:.1f} QPS (median of 5); a row takes {cell['row_bytes']} bytes, the Reader's "
                  f"whole upload holds {cell['reader_bytes'] / N:.1f} bytes per item ({cell['reader_bytes'] / 2**20:.1f} MiB, peak "
                  f"{cell['reader_peak_bytes'] / 2**20:.1f} MiB); kernel launches {kernel.launches} ({form}), search kernel "
                  f"launches {cell['search_kernel_launches']} ({card})", flush=True)
            # the graph search must reach the bar on the rows it serves, and
            # against f32 the bar's share of what the tier's encoding itself
            # keeps of the f32 answer (an exact scan of its rows)
            floor = RECALL_BAR * cell["exact_scan_recall_at_10"]
            if cell["recall_at_10_own_rows"] < RECALL_BAR or cell["recall_at_10"] < floor:
                raise AssertionError(f"[{label}] {name} {tier}: recall@10 {cell['recall_at_10_own_rows']} on its own rows "
                                     f"(bar {RECALL_BAR}), {cell['recall_at_10']} against f32 (floor {floor})")
            # phase 13 on this database; the plain versions timed once per form
            cell["search_kernels"] = search_kernel_checks(f"phase 13 on phase 8's {key}", reader, queries, card,
                                                          plain_timing=form not in PLAIN_TIMED)
            PLAIN_TIMED.add(form)
            del reader
            db.close()
    return out


def delete_filter_path(device, path: str, queries, card: str) -> dict:
    """Phase 9, on the phase-6 database (102,000 items after its append):
    (a) delete 2,000 items, every entry point among them, and add 2,000
    new ones → ``build()`` (repair, waves, re-check) → commit →
    validity, no deleted id in any answer, recall@10 against ``flat_topk``
    over the survivors, self-hit of the new items → close → reopen → the
    same answers; (b) ``by_vecs`` with candidate sets of 0.5%, 1%, 10% and
    50% of the items, each holding 100 deleted ids too: which side each
    took, QPS, recall@10 against the masked ``flat_topk``; (c)
    ``Reader.by_items`` of 256 present and 2 absent items. Every span is
    fenced and carries its kernel launches."""
    import torch

    from hannoy_tpu_torch import Database, Metric, flat_topk
    from hannoy_tpu_torch.ops import beam_cuda, distances
    from hannoy_tpu_torch.store import schema
    from hannoy_tpu_torch.utils import tracing

    label = "phase 9: deletions and filtered search"
    kernel = beam_cuda.KERNEL
    ef = EF_SWEEP[-1]
    metric = distances.COSINE
    out: dict = {"seconds": {}, "spans": {}, "filtered": {}, "launches": {}}

    def recorded():
        return tracing.record(fence=lambda: _sync(device), probe=all_launches)

    def timed(what: str, fn):
        return _timed(label, card, device, what, fn)

    def recall_by_dist(answers, q, qn, mask, want_rows) -> float:
        """Share of returned distances within the exact K-th (+1e-6) over
        ``mask``; each row must hold ``want_rows`` entries."""
        exact_d, _ = flat_topk(metric.name, q, qn, reader._dev.vectors, reader._dev.norms, mask, K)
        kth = (exact_d[:, want_rows - 1] + 1e-6).cpu().numpy()
        if any(len(row) != want_rows for row in answers):
            raise AssertionError(f"[{label}] a row came back with other than {want_rows} entries")
        return float(np.mean([[d <= kth[b] for _, d in row] for b, row in enumerate(answers)]))

    # ---- (a) delete 2,000 (every entry point among them), add 2,000 ----
    reset_counts()
    db = Database(path, Metric.COSINE, map_size=API_MAP_SIZE)
    txn = db._env.read_txn()
    md = schema.Metadata.from_bytes(db._db.get(txn, schema.Key.metadata(0).to_bytes()))
    items = md.items.to_array().astype(np.int64)
    n_before = len(items)
    eps = sorted(int(e) for e in md.entry_points)
    rng = np.random.default_rng(44)
    rest = np.setdiff1d(items, eps)
    doomed = np.sort(np.concatenate([eps, rng.choice(rest, N_DELETE - len(eps), replace=False)])).astype(np.int64)
    new_ids = np.arange(N + N_APPEND, N + N_APPEND + N_DELETE)
    extra = bench_append(N_DELETE, seed=45)
    writer = db.writer(dimensions=DIM, m=M, ef=EFC)

    def churn():
        for i in doomed.tolist():
            if not writer.del_item(i):
                raise AssertionError(f"[{label}] item {i} was not there to delete")
        writer.add_items(new_ids, extra)

    _, out["seconds"]["del_and_add_items"] = timed(f"del_item x {N_DELETE} ({len(eps)} entry points) + add_items of {N_DELETE}", churn)
    with recorded() as spans:
        stats, out["seconds"]["build"] = timed("delete + add build (fenced spans)", lambda: writer.builder(seed=42).build())
    out["spans"]["build"] = sp = _print_spans(label, spans, skip=("insert_wave", "repair_level"))
    waves = [s for s in spans if s.name == "insert_wave"]
    print(f"[{label}]   span insert_wave: {len(waves)} x, {sum(s.ms for s in waves):.2f} ms, kernel launches "
          f"{sum(s.probed for s in waves)}", flush=True)
    out["repair_levels"] = []
    for s in spans:
        if s.name == "repair_level":
            out["repair_levels"].append({**s.fields, "ms": s.ms, "launches": s.probed})
            print(f"[{label}]   span repair_level {s.fields['level']}: {s.fields['owners']} owners in "
                  f"{s.fields['blocks']} blocks of {REPAIR_SHAPE[0]}, {s.ms:.2f} ms, kernel launches {s.probed}", flush=True)
    for need in ("repair_deletions", "inbound_recheck", "insert_wave", "load_graph"):
        if need not in sp:
            raise AssertionError(f"[{label}] the build did not go through {need}: {sorted(sp)}")
    repair_launches = kernel.by_shape.get(REPAIR_SHAPE, 0)
    if sp["repair_deletions"]["launches"] == 0 or repair_launches == 0:
        raise AssertionError(f"[{label}] the repair launched no kernel at {REPAIR_SHAPE}")
    out["repair_launches_at_shape"] = repair_launches
    print(f"[{label}] build touched {len(stats.touched)} rows in {stats.waves} waves; the repair's kernel launches "
          f"at {list(REPAIR_SHAPE)}: {repair_launches}; all launches {_shapes(kernel.by_shape)}", flush=True)
    _, out["seconds"]["commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    reader = db.reader()
    n_after = n_before  # 2,000 out, 2,000 in
    if reader.n_items() != n_after or set(doomed.tolist()) & set(reader.item_ids().to_array().tolist()):
        raise AssertionError(f"[{label}] {reader.n_items()} items after the build, or deleted items still indexed")
    if set(eps) & set(reader._metadata.entry_points):
        raise AssertionError(f"[{label}] a deleted entry point is still an entry point")
    _, out["seconds"]["assert_validity"] = timed(f"Reader.assert_validity on the {n_after}-item index", reader.assert_validity)
    reader._graph.check_validity()
    before = reader.by_vecs(queries, n=K, ef_search=ef)
    dset = set(doomed.tolist())
    if any(i in dset for row in before for i, _ in row):
        raise AssertionError(f"[{label}] a deleted item came back in an answer")
    q, qn = reader._prep_queries(queries)
    out["recall_at_10"] = recall_by_dist(before, q, qn, reader._dev.valid, K)
    firsts = reader.by_vecs(extra, n=1, ef_search=ef)
    out["self_hit"] = float(np.mean([bool(row) and row[0][0] == int(new_ids[i]) for i, row in enumerate(firsts)]))
    print(f"[{label}] {N_DELETE} deleted ({len(eps)} entry points, replaced by {reader._metadata.entry_points}), "
          f"{N_DELETE} added: recall@10 at ef={ef} over the survivors {out['recall_at_10']:.4f}, no deleted id in "
          f"{N_QUERIES} answers, the new items find themselves first in {out['self_hit']:.4f} of rows ({card})", flush=True)
    if out["recall_at_10"] < RECALL_BAR or out["self_hit"] < SELF_HIT_BAR:
        raise AssertionError(f"[{label}] recall@10 {out['recall_at_10']} (bar {RECALL_BAR}) or self-hit "
                             f"{out['self_hit']} (bar {SELF_HIT_BAR})")
    out["launches"]["delete_build_and_search"] = count_main_path(f"{label}: delete + add build and search")
    db.close()

    reset_counts()
    db, out["seconds"]["reopen"] = timed("Database reopen", lambda: Database(path, Metric.COSINE, map_size=API_MAP_SIZE))
    reader, out["seconds"]["reader_open"] = timed("Reader.open (load + upload)", db.reader)
    if reader.by_vecs(queries, n=K, ef_search=ef) != before:
        raise AssertionError(f"[{label}] answers changed across close and reopen")
    print(f"[{label}] the {N_QUERIES} answers are the same after the close and reopen", flush=True)

    # ---- (b) filtered by_vecs: 0.5%, 1%, 10%, 50% of the items + 100 deleted ids ----
    live = reader.item_ids().to_array().astype(np.int64)
    q, qn = reader._prep_queries(queries)
    cand_sets = {}
    for share in FILTER_SHARES:
        sel = np.random.default_rng(int(share * 1000) + 46).choice(live, int(round(share * len(live))), replace=False)
        cands = cand_sets[share] = np.concatenate([sel, doomed[:100]])
        qb = reader.nns(K).ef_search(ef).candidates(cands)
        side = "linear scan" if reader._should_linear_scan(qb) else "filtered beam"
        with tracing.record() as spans:  # the warm-up; its spans say which side ran
            answers = [s.nns for s in qb.by_vectors(queries)]
        launches0 = kernel.launches
        t = [one_call(device, lambda: qb.by_vectors(queries)) for _ in range(3)]
        if ("reader_search" in {s.name for s in spans}) != (side == "filtered beam"):
            raise AssertionError(f"[{label}] {share:.1%} took the other side than {side}")
        allowed = set(sel.tolist())
        if any(i not in allowed for row in answers for i, _ in row):
            raise AssertionError(f"[{label}] {share:.1%}: an answer outside the live candidates")
        mask = torch.from_numpy(reader._candidate_mask(qb._candidates)).to(device)
        recall = recall_by_dist(answers, q, qn, mask, min(K, len(allowed)))
        cell = out["filtered"][f"{share:.3f}"] = {
            "candidates": len(cands), "live_candidates": len(allowed), "side": side, "recall_at_10": recall,
            "qps": N_QUERIES / float(np.median(t)), "launches_per_call": (kernel.launches - launches0) / 3}
        print(f"[{label}] by_vecs with {len(cands)} candidates ({share:.1%} of the items + 100 deleted): {side}, "
              f"{cell['qps']:.1f} QPS (median of 3), recall@10 at ef={ef} against the masked flat_topk {recall:.4f}, "
              f"kernel launches per call {cell['launches_per_call']:.0f} ({card})", flush=True)
        if side == "linear scan" and recall != 1.0:
            raise AssertionError(f"[{label}] the linear scan is not exact: recall {recall}")
        if share == FILTER_SHARES[-1] and recall < RECALL_BAR:
            raise AssertionError(f"[{label}] recall@10 {recall} at {share:.0%} below {RECALL_BAR}")

    # ---- (c) by_items: 256 present items and 2 absent ----
    asked = np.random.default_rng(47).choice(live, N_QUERIES, replace=False)
    ask = asked.tolist() + doomed[:2].tolist()
    from hannoy_tpu_torch.ops import search_cuda

    before = kernel.launches, dict(search_cuda.KERNELS.launches)
    rows, out["seconds"]["by_items"] = timed(f"Reader.by_items of {len(ask)} items", lambda: reader.by_items(ask, n=K, ef_search=ef))
    # an unfiltered by_items is one launch of the beam kernel, and no hop of the gather kernel
    out["by_items_launches"] = {"gather": kernel.launches - before[0], **{
        k: n - before[1].get(k, 0) for k, n in search_cuda.KERNELS.launches.items() if n != before[1].get(k, 0)}}
    if out["by_items_launches"] != {"gather": 0, "beam_search": 1}:
        raise AssertionError(f"[{label}] by_items did not take the beam kernel alone: {out['by_items_launches']}")
    if rows[-2:] != [None, None] or any(r is None for r in rows[:-2]):
        raise AssertionError(f"[{label}] by_items gave None where an item is, or an answer for an absent one")
    if any(item in [i for i, _ in row] for item, row in zip(asked.tolist(), rows)):
        raise AssertionError(f"[{label}] by_items returned an item for itself")
    slots = torch.tensor([reader._graph.id_to_slot[int(i)] for i in asked], device=device)
    own = reader._dev.valid[None, :].repeat(len(asked), 1)
    own[torch.arange(len(asked), device=device), slots] = False
    out["by_items_recall_at_10"] = recall_by_dist(rows[:-2], reader._dev.vectors[slots], reader._dev.norms[slots], own, K)
    print(f"[{label}] by_items of {len(asked)} present and 2 absent items: recall@10 at ef={ef} against flat_topk "
          f"without the item itself {out['by_items_recall_at_10']:.4f}, in {out['seconds']['by_items']:.3f} s ({card})", flush=True)
    if out["by_items_recall_at_10"] < RECALL_BAR:
        raise AssertionError(f"[{label}] by_items recall@10 {out['by_items_recall_at_10']} below {RECALL_BAR}")
    out["launches"]["filtered_and_by_items"] = count_main_path(f"{label}: reopen, filtered search and by_items")

    # ---- (d) cancellation of searches and of a build ----
    reset_counts()
    t0 = time.perf_counter()
    out["cancel"] = cancel_checks(label, reader, queries, asked, cand_sets[CANCEL_FILTER_SHARE], set(doomed.tolist()), card)
    out["launches"]["cancelled_searches"] = count_main_path(f"{label}: cancelled searches")
    reset_counts()
    out["cancel"]["build"] = cancelled_build(label, db, reader, queries, live, card)
    out["launches"]["cancelled_build"] = count_main_path(f"{label}: cancelled build")
    out["seconds"]["cancellation"] = time.perf_counter() - t0
    print(f"[{label}] cancellation checks took {out['seconds']['cancellation']:.3f} s", flush=True)
    db.close()
    return out


class FireAt:
    """A cancel closure that returns True at its ``n``-th call only (0:
    never), and notes when that call came."""

    def __init__(self, n: int):
        self.n, self.calls, self.fired_at = n, 0, None

    def __call__(self) -> bool:
        self.calls += 1
        if self.calls == self.n:
            self.fired_at = time.perf_counter()
            return True
        return False


def cancel_checks(label: str, reader, queries, items, cands, doomed: set, card: str) -> dict:
    """Phase 9 (d), searches: ``by_vectors``, ``by_items`` and a filtered
    ``by_vectors`` (``cands``) of the 256 queries / items, each with a
    cancel that never fires — the uncancelled answers id for id and
    distance for distance — and with one that fires at its 1st, 2nd and
    4th check: ``did_cancel`` on every row, live ids only (candidates
    only, never the item itself), sorted, each distance within
    ``CANCEL_ATOL`` of ``flat_topk``'s distance for that id."""
    import torch

    from hannoy_tpu_torch import flat_topk
    from hannoy_tpu_torch.ops import distances

    metric = distances.COSINE
    device = reader._dev.vectors.device
    g = reader._graph
    live = set(reader.item_ids().to_array().tolist())
    slots = torch.tensor([g.id_to_slot[int(i)] for i in items], device=device).long()
    q, qn = reader._prep_queries(queries)
    allowed = set(int(i) for i in cands) & live
    calls = {
        "by_vectors": (lambda c: reader.nns(K).ef_search(EF_SWEEP[-1]).by_vectors_with_cancellation(queries, c),
                       lambda: reader.nns(K).ef_search(EF_SWEEP[-1]).by_vectors(queries), (q, qn), live),
        "by_items": (lambda c: reader.nns(K).ef_search(EF_SWEEP[-1]).by_items_with_cancellation(items, c),
                     lambda: reader.nns(K).ef_search(EF_SWEEP[-1]).by_items(items),
                     (reader._dev.vectors[slots], reader._dev.norms[slots]), live),
        "filtered": (lambda c: reader.nns(K).ef_search(EF_SWEEP[-1]).candidates(cands).by_vectors_with_cancellation(queries, c),
                     lambda: reader.nns(K).ef_search(EF_SWEEP[-1]).candidates(cands).by_vectors(queries), (q, qn), allowed),
    }
    out = {}
    for name, (cancelled, plain, (cq, cqn), ok_ids) in calls.items():
        never = FireAt(0)
        if [s.nns for s in cancelled(never)] != [s.nns for s in plain()]:
            raise AssertionError(f"[{label}] {name}: a cancel that never fires changed the answers")
        cell = out[name] = {"checks_when_never_fired": never.calls}
        for k in CANCEL_AT:
            rows = cancelled(FireAt(k))
            # the exact distance of every returned id: flat_topk over a
            # per-row mask of just those ids
            mask = torch.zeros((len(rows), reader._dev.vectors.shape[0]), dtype=torch.bool, device=device)
            for b, s in enumerate(rows):
                if s.nns:
                    mask[b, torch.tensor([g.id_to_slot[i] for i, _ in s.nns], device=device).long()] = True
            ed, es = flat_topk(metric.name, cq, cqn, reader._dev.vectors, reader._dev.norms, mask, K)
            ed, es = ed.cpu().numpy(), es.cpu().numpy()
            err = 0.0
            for b, s in enumerate(rows):
                ids = [i for i, _ in s.nns]
                ds = [d for _, d in s.nns]
                exact = {int(g.ids[sl]): float(d) for sl, d in zip(es[b], ed[b]) if sl >= 0}
                if not s.did_cancel or not set(ids) <= ok_ids or set(ids) & doomed or ds != sorted(ds):
                    raise AssertionError(f"[{label}] {name}, cancel at check {k}: row {b} is not a valid partial row")
                if name == "by_items" and items[b] in ids:
                    raise AssertionError(f"[{label}] by_items, cancel at check {k}: an item came back for itself")
                err = max([err] + [abs(d - exact[i]) for i, d in s.nns])
            if err > CANCEL_ATOL:
                raise AssertionError(f"[{label}] {name}, cancel at check {k}: a distance {err} off the exact one")
            cell[f"at_{k}"] = {"rows_with_items": sum(bool(s.nns) for s in rows),
                               "items": sum(len(s.nns) for s in rows), "max_abs_err": err}
        print(f"[{label}] cancelled {name}: never-firing = uncancelled ({never.calls} checks); fired at check "
              + ", ".join(f"{k}: {cell[f'at_{k}']['items']} items in {cell[f'at_{k}']['rows_with_items']} rows, "
                          f"max err {cell[f'at_{k}']['max_abs_err']:.2e}" for k in CANCEL_AT) + f" ({card})", flush=True)
    return out


def cancelled_build(label: str, db, reader, queries, live, card: str) -> dict:
    """Phase 9 (d), a build: add 500 items and delete 100, then a build
    whose cancel fires at its 3rd check must raise ``BuildCancelled``;
    after ``abort_rw_txn`` a new Reader gives the answers of before."""
    from hannoy_tpu_torch.errors import BuildCancelled

    before = reader.by_vecs(queries, n=K, ef_search=EF_SWEEP[-1])
    writer = db.writer(dimensions=DIM, m=M, ef=EFC)
    new_ids = np.arange(N + N_APPEND + N_DELETE, N + N_APPEND + N_DELETE + CANCEL_ADD)
    writer.add_items(new_ids, bench_append(CANCEL_ADD, seed=48))
    for i in np.random.default_rng(49).choice(live, CANCEL_DELETE, replace=False).tolist():
        if not writer.del_item(int(i)):
            raise AssertionError(f"[{label}] item {i} was not there to delete")
    fire = FireAt(3)
    t0 = time.perf_counter()
    try:
        writer.builder(seed=42).cancel(fire).build()
    except BuildCancelled:
        raised = time.perf_counter()
    else:
        raise AssertionError(f"[{label}] the build whose cancel fired did not raise BuildCancelled")
    if fire.fired_at is None or not db.abort_rw_txn():
        raise AssertionError(f"[{label}] the cancel never fired, or there was no transaction to abort")
    after = db.reader().by_vecs(queries, n=K, ef_search=EF_SWEEP[-1])
    if after != before:
        raise AssertionError(f"[{label}] after the cancelled build and the abort, the answers changed")
    out = {"seconds_to_the_firing_check": fire.fired_at - t0, "seconds_firing_check_to_raise": raised - fire.fired_at}
    print(f"[{label}] build of +{CANCEL_ADD} / -{CANCEL_DELETE} cancelled at its 3rd check, "
          f"{out['seconds_to_the_firing_check']:.3f} s after it began: BuildCancelled "
          f"{out['seconds_firing_check_to_raise'] * 1e3:.3f} ms after the firing check; aborted, and a new Reader "
          f"gives the {N_QUERIES} answers of before ({card})", flush=True)
    return out


def _graph_bytes(dev) -> int:
    """Device bytes of one ``DeviceGraph``'s tensors."""
    return sum(t.numel() * t.element_size() for t in vars(dev).values() if hasattr(t, "element_size"))


def sharded_path(device, path: str, card: str) -> dict:
    """Phase 10: ``N_SHARDED`` x 768 cosine (``bench_data``, seed 42, n/256
    centres) in ``N_SHARDS`` shards, every shard on ``device``, through
    ``ShardedWriter`` / ``ShardedReader`` in the empty directory ``path``
    (phase 11 reopens it; the record's "deleted" lists the items deleted):
    (1) add → sequential build (``spmd=False``: each shard by the bulk
    path) → commit; (2) ``ShardedReader`` → ``assert_validity`` → search of
    the 256 queries at ef 100, recall@10 against ``flat_topk`` over every
    item, QPS beside one shard's ``Reader.by_vecs``; (3) append 2,000
    (seed 43) and delete 400, every shard's entry points among them →
    lockstep build → commit; (4) a new ``ShardedReader``: no deleted id in
    any answer, self-hit of the appended items, recall; (5) a lockstep
    build whose cancel fires at its 2nd check raises ``BuildCancelled``,
    and after the abort a new ``ShardedReader`` gives the answers of (4).
    Every span is fenced and carries its kernel launches."""
    import torch

    from hannoy_tpu_torch import BuildOptions, Database, Metric, flat_topk
    from hannoy_tpu_torch.errors import BuildCancelled
    from hannoy_tpu_torch.ops import beam_cuda, distances
    from hannoy_tpu_torch.parallel import ShardedReader, ShardedWriter
    from hannoy_tpu_torch.utils import tracing

    label = "phase 10: sharded build and serving"
    kernel = beam_cuda.KERNEL
    ef, S, n = EF_SWEEP[-1], N_SHARDS, N_SHARDED
    devices = [device] * S
    metric = distances.COSINE
    out: dict = {"seconds": {}, "spans": {}, "launches": {}, "device_bytes": {}}

    def recorded():
        return tracing.record(fence=lambda: _sync(device), probe=all_launches)

    def timed(what: str, fn):
        return _timed(label, card, device, what, fn)

    def recall(vectors, answers) -> float:
        """recall@10 of ``answers`` against ``flat_topk`` over ``vectors``."""
        q = torch.from_numpy(queries).to(device)
        qn = torch.from_numpy(distances.np_norms(metric, queries)).to(device)
        x = torch.from_numpy(vectors).to(device)
        xn = torch.from_numpy(distances.np_norms(metric, vectors)).to(device)
        exact_d, _ = flat_topk(metric.name, q, qn, x, xn, torch.ones(len(vectors), dtype=torch.bool, device=device), K)
        kth = (exact_d[:, K - 1] + 1e-6).cpu().numpy()
        del x, xn
        if any(len(row) != K for row in answers):
            raise AssertionError(f"[{label}] a query came back with fewer than {K} results")
        return float(np.mean([[d <= kth[b] for _, d in row] for b, row in enumerate(answers)]))

    data, queries = bench_data(np.random.default_rng(42), n)
    # ---- (1) add → sequential build (bulk per shard) → commit ----
    reset_counts()
    db = Database(path, Metric.COSINE, map_size=SHARDED_MAP_SIZE)
    writer = ShardedWriter(db, DIM, n_shards=S, m=M, ef=EFC, devices=devices)
    _, out["seconds"]["add_items"] = timed(f"add_items of {n} x {DIM} into {S} shards",
                                           lambda: writer.add_items(range(n), data))
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    with recorded() as spans:
        _, out["seconds"]["build"] = timed("sequential build, spmd=False (fenced spans)", lambda: writer.build(spmd=False))
    out["device_bytes"]["build_peak"] = torch.cuda.max_memory_allocated(device) - base
    out["spans"]["build"] = _print_spans(label, spans)
    per_shard = [s.ms / 1e3 for s in spans if s.name == "build_graph"]
    if len(per_shard) != S or sum(s.name == "bulk_build" for s in spans) != S:
        raise AssertionError(f"[{label}] not every shard took the bulk path: {sorted({s.name for s in spans})}")
    out["seconds"]["build_graph_per_shard"] = per_shard
    print(f"[{label}] build_graph per shard {', '.join(f'{t:.3f}' for t in per_shard)} s, "
          f"{out['seconds']['build']:.3f} s in all; device memory peak above the start "
          f"{out['device_bytes']['build_peak'] / 2**30:.3f} GiB ({card})", flush=True)
    _, out["seconds"]["commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    out["launches"]["sequential_build"] = count_main_path(f"{label}: sequential build")

    # ---- (2) ShardedReader → validity → search, recall, QPS ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    reader, out["seconds"]["reader_open"] = timed("ShardedReader open", lambda: ShardedReader(db, S, devices=devices))
    out["device_bytes"]["reader"] = torch.cuda.memory_allocated(device) - base
    out["device_bytes"]["reader_peak"] = torch.cuda.max_memory_allocated(device) - base
    out["device_bytes"]["per_shard_index"] = [_graph_bytes(g) for g in reader._index.graphs]
    out["device_bytes"]["per_shard_reader"] = [_graph_bytes(r._dev) for r in reader._readers]
    print(f"[{label}] device bytes: ShardedReader {out['device_bytes']['reader'] / 2**20:.1f} MiB in all "
          f"(peak {out['device_bytes']['reader_peak'] / 2**20:.1f}); per shard, its graph in the sharded index "
          f"{', '.join(f'{b / 2**20:.1f}' for b in out['device_bytes']['per_shard_index'])} MiB and in its own "
          f"Reader {', '.join(f'{b / 2**20:.1f}' for b in out['device_bytes']['per_shard_reader'])} MiB ({card})",
          flush=True)
    if reader.n_items() != n:
        raise AssertionError(f"[{label}] {reader.n_items()} items, expected {n}")
    _, out["seconds"]["assert_validity"] = timed("ShardedReader.assert_validity", reader.assert_validity)
    answers = reader.search(queries, n=K, ef_search=ef)
    out["recall_at_10"] = recall(data, answers)
    one = reader._readers[0]
    for _ in range(2):
        reader.search(queries, n=K, ef_search=ef)
        one.by_vecs(queries, n=K, ef_search=ef)
    t_sh = [one_call(device, lambda: reader.search(queries, n=K, ef_search=ef)) for _ in range(5)]
    t_one = [one_call(device, lambda: one.by_vecs(queries, n=K, ef_search=ef)) for _ in range(5)]
    out["qps"] = {"sharded_search": N_QUERIES / float(np.median(t_sh)), "one_shard_by_vecs": N_QUERIES / float(np.median(t_one))}
    print(f"[{label}] search of {N_QUERIES} queries at ef={ef} over {S} shards: recall@10 {out['recall_at_10']:.4f} "
          f"against flat_topk over all {n}; {out['qps']['sharded_search']:.1f} QPS (median of 5), one shard's "
          f"Reader.by_vecs {out['qps']['one_shard_by_vecs']:.1f} QPS ({card})", flush=True)
    if out["recall_at_10"] < RECALL_BAR:
        raise AssertionError(f"[{label}] recall@10 {out['recall_at_10']} below {RECALL_BAR}")
    out["launches"]["open_and_search"] = count_main_path(f"{label}: open and search")

    # ---- (3) append 2,000 and delete 400 (every entry point) → lockstep build ----
    reset_counts()
    eps = sorted({int(e) for r in reader._readers for e in r._metadata.entry_points})
    rest = np.setdiff1d(np.arange(n), eps)
    doomed = np.sort(np.concatenate([eps, np.random.default_rng(44).choice(rest, SHARDED_DELETE - len(eps), replace=False)]))
    extra = bench_append(N_APPEND, seed=43, n_data=n)
    new_ids = np.arange(n, n + N_APPEND)
    del reader, one
    writer = ShardedWriter(db, DIM, n_shards=S, m=M, ef=EFC, devices=devices)

    def churn():
        writer.add_items(new_ids, extra)
        for i in doomed.tolist():
            if not writer.del_item(i):
                raise AssertionError(f"[{label}] item {i} was not there to delete")

    _, out["seconds"]["add_and_del"] = timed(f"add_items of {N_APPEND} + del_item x {SHARDED_DELETE} "
                                             f"({len(eps)} entry points)", churn)
    with recorded() as spans:
        _, out["seconds"]["lockstep_build"] = timed("lockstep build (fenced spans)", writer.build)
    out["spans"]["lockstep_build"] = sp = _print_spans(label, spans, skip=("insert_wave", "spmd_wave", "repair_level"))
    waves = [s for s in spans if s.name == "spmd_wave"]
    out["lockstep_waves"] = len(waves)
    print(f"[{label}]   span spmd_wave: {len(waves)} lockstep waves of {S} shards, {sum(s.ms for s in waves):.2f} ms, "
          f"kernel launches {sum(s.probed for s in waves)}", flush=True)
    for need in ("spmd_waves", "repair_deletions", "load_graph"):
        if need not in sp:
            raise AssertionError(f"[{label}] the lockstep build did not go through {need}: {sorted(sp)}")
    _, out["seconds"]["lockstep_commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    out["launches"]["lockstep_build"] = count_main_path(f"{label}: lockstep build")

    # ---- (4) a new ShardedReader: no deleted id, self-hit, recall ----
    reset_counts()
    reader, out["seconds"]["reader_reopen"] = timed("ShardedReader open after the lockstep build",
                                                    lambda: ShardedReader(db, S, devices=devices))
    if reader.n_items() != n + N_APPEND - SHARDED_DELETE:
        raise AssertionError(f"[{label}] {reader.n_items()} items after the lockstep build")
    reader.assert_validity()
    after = reader.search(queries, n=K, ef_search=ef)
    dset = set(doomed.tolist())
    out["deleted"] = sorted(dset)
    if any(i in dset for row in after for i, _ in row):
        raise AssertionError(f"[{label}] a deleted item came back in an answer")
    survivors = np.concatenate([np.delete(data, doomed, axis=0), extra])
    out["recall_at_10_after"] = recall(survivors, after)
    firsts = reader.search(extra, n=1, ef_search=ef)
    out["self_hit"] = float(np.mean([bool(row) and row[0][0] == int(new_ids[i]) for i, row in enumerate(firsts)]))
    print(f"[{label}] after +{N_APPEND} / -{SHARDED_DELETE}: recall@10 {out['recall_at_10_after']:.4f}, no deleted "
          f"id in {N_QUERIES} answers, the appended items find themselves first in {out['self_hit']:.4f} of rows "
          f"({card})", flush=True)
    if out["recall_at_10_after"] < RECALL_BAR or out["self_hit"] < SELF_HIT_BAR:
        raise AssertionError(f"[{label}] recall@10 {out['recall_at_10_after']} or self-hit {out['self_hit']}")
    out["launches"]["reopen_and_search"] = count_main_path(f"{label}: reopen and search")

    # ---- (5) a lockstep build cancelled at its 2nd check ----
    reset_counts()
    writer = ShardedWriter(db, DIM, n_shards=S, m=M, ef=EFC, devices=devices)
    writer.add_items(np.arange(n + N_APPEND, n + N_APPEND + 400), bench_append(400, seed=50, n_data=n))
    for i in np.random.default_rng(51).choice(np.setdiff1d(np.arange(n), doomed), 100, replace=False).tolist():
        writer.del_item(int(i))
    fire = FireAt(2)
    t0 = time.perf_counter()
    try:
        writer.build(opts=BuildOptions(ef_construction=EFC, cancel=fire))
    except BuildCancelled:
        raised = time.perf_counter()
    else:
        raise AssertionError(f"[{label}] the lockstep build whose cancel fired did not raise BuildCancelled")
    if fire.fired_at is None or not db.abort_rw_txn():
        raise AssertionError(f"[{label}] the cancel never fired, or there was no transaction to abort")
    if ShardedReader(db, S, devices=devices).search(queries, n=K, ef_search=ef) != after:
        raise AssertionError(f"[{label}] after the cancelled lockstep build and the abort, the answers changed")
    out["cancel"] = {"seconds_to_the_firing_check": fire.fired_at - t0, "seconds_firing_check_to_raise": raised - fire.fired_at}
    print(f"[{label}] lockstep build cancelled at its 2nd check {out['cancel']['seconds_to_the_firing_check']:.3f} s "
          f"after it began: BuildCancelled {out['cancel']['seconds_firing_check_to_raise'] * 1e3:.3f} ms later; "
          f"aborted, and a new ShardedReader gives the answers of before ({card})", flush=True)
    out["launches"]["cancelled_build"] = count_main_path(f"{label}: cancelled lockstep build")
    db.close()
    total = sum(sum(step.values()) for step in out["launches"].values())
    out["search_kernel_launches"] = {name: STEP_LAUNCHES[f"{label}: {name.replace('_', ' ')}"]["search"]
                                     for name in out["launches"] if name != "cancelled_build"}
    print(f"[{label}] gather kernel launches {total}: {json.dumps(out['launches'])}; search kernel launches "
          f"{json.dumps(out['search_kernel_launches'])}", flush=True)
    if min(sum(step.values()) + sum(out["search_kernel_launches"][name].values())
           for name, step in out["launches"].items() if name != "cancelled_build") == 0:
        raise AssertionError(f"[{label}] a step launched no kernel: {out['launches']} {out['search_kernel_launches']}")
    return out


def _exact_top(device, data, queries):
    """(queries, norms, flat_topk's K-th distance + 1e-6) for ``data`` on
    the device: the tie-aware recall threshold of every query."""
    import torch

    from hannoy_tpu_torch import flat_topk
    from hannoy_tpu_torch.ops import distances

    metric = distances.COSINE
    q = torch.from_numpy(queries).to(device)
    qn = torch.from_numpy(distances.np_norms(metric, queries)).to(device)
    x = torch.from_numpy(data).to(device)
    xn = torch.from_numpy(distances.np_norms(metric, data)).to(device)
    exact_d, _ = flat_topk(metric.name, q, qn, x, xn, torch.ones(len(data), dtype=torch.bool, device=device), K)
    return q, qn, exact_d[:, K - 1 : K] + 1e-6


def option_build(device, data, top, label: str, name: str, card: str, **opts):
    """One phase-11 build: timed unfenced (ended by one synchronize) with
    its kernel launches, waves, chained waves and beam iterations,
    ``check_validity``, then the 256 queries at ef 100 on its serve-only
    upload: recall@10 against ``top`` (``_exact_top``). Build and search
    are main-path steps. → (record, graph, device graph, search result)"""
    from hannoy_tpu_torch import default_ef_upper, hnsw_search
    from hannoy_tpu_torch.models.hnsw import to_device
    from hannoy_tpu_torch.ops import beam_cuda

    q, qn, thresh = top
    ef = EF_SWEEP[-1]
    reset_counts()
    g, stats, build_s, spans = timed_build(device, data, **opts)
    rec = {"build_s": build_s, "waves": stats.waves, "beam_iters": stats.beam_iters,
           "chained_waves": sum(1 for sp in spans if sp.name == "insert_wave" and sp.fields.get("chained")),
           "build_launches": beam_cuda.KERNEL.launches, "build_launches_by_shape": _shapes(beam_cuda.KERNEL.by_shape),
           "spans": sorted({sp.name for sp in spans})}
    count_main_path(f"{label}: {name} build")
    g.check_validity()
    dev = to_device(g, device, serve_only=True)
    reset_counts()
    res = hnsw_search(dev, q, qn, ef, ef_upper=default_ef_upper(len(data), ef))
    count_main_path(f"{label}: {name} search")
    if res.dists.shape != (N_QUERIES, ef) or not bool(res.dists[:, :K].isfinite().all()):
        raise AssertionError(f"[{label}] {name}: search returned non-finite or mis-shaped results")
    rec["recall_at_10"] = float((res.dists[:, :K] <= thresh).float().mean())
    print(f"[{label}] {name}: {len(data)} x {DIM} built in {build_s:.3f} s, waves {stats.waves} (chained "
          f"{rec['chained_waves']}), beam iters {stats.beam_iters}, kernel launches {rec['build_launches']} "
          f"{rec['build_launches_by_shape']}; check_validity passed; recall@10 at ef={ef} {rec['recall_at_10']:.4f} "
          f"({card})", flush=True)
    return rec, g, dev, res


def options_path(device, sharded_dir: str, sharded: dict, card: str) -> dict:
    """Phase 11: the build options on phase 4/5's data (``bench_data``, seed
    42). (a) The wave path on the first ``N_OPTION_WAVE`` items: the
    default build, then ``beam_expand=2``, ``traverse=24``,
    ``link_slack=16`` and ``chain_seeding`` (which must chain waves), then
    the default again. (b) The bulk path on the first ``N_OPTION_BULK``
    items: the default build, then
    ``bulk_renumber`` (the answers equal the default's by item id and
    distance; QPS of the two graphs in turns), ``bulk_backbone=False,
    bulk_upper=1``, ``backbone_flat=False`` and ``bulk_init="random"``,
    then the default again. Every build valid,
    recall@10 >= RECALL_BAR but where UNBARRED. (c) Phase 10's database
    (``sharded_dir``, its deleted items in ``sharded``): +2,000 (seed 46)
    / -400 (seed 47, every shard's entry points among them) through the
    lockstep ``ShardedWriter.build(opts=)`` with ``link_slack=8`` → a new
    ``ShardedReader``: validity, no deleted id, recall, self-hit."""
    import torch

    from hannoy_tpu_torch import BuildOptions, Database, Metric, default_ef_upper, hnsw_search
    from hannoy_tpu_torch.ops import beam_cuda
    from hannoy_tpu_torch.parallel import ShardedReader, ShardedWriter
    from hannoy_tpu_torch.utils import tracing

    label = "phase 11: build options"
    ef = EF_SWEEP[-1]
    data, queries = bench_data(np.random.default_rng(42))
    out: dict = {"wave": {}, "bulk": {}}

    def check(path: str, name: str, rec: dict, need: str) -> None:
        if need not in rec["spans"]:
            raise AssertionError(f"[{label}] {path} {name}: the build did not go through {need}: {rec['spans']}")
        if name not in UNBARRED and rec["recall_at_10"] < RECALL_BAR:
            raise AssertionError(f"[{label}] {path} {name}: recall@10 {rec['recall_at_10']} below {RECALL_BAR}")

    # ---- (a) the wave path ----
    wdata = data[:N_OPTION_WAVE]
    top = _exact_top(device, wdata, queries)
    for name, opts in WAVE_OPTIONS:
        rec, g, dev, _ = option_build(device, wdata, top, label, f"waves {name}", card, bulk=False, **opts)
        need = {"link_slack=16": "prune_slack_rows"}.get(name, "insert_wave")
        check("waves", name, rec, need)
        out["wave"][name] = rec
        del g, dev
    if out["wave"]["chain_seeding"]["chained_waves"] == 0:
        raise AssertionError(f"[{label}] chain_seeding chained no wave")
    base = out["wave"]["default"]
    base_s = (base["build_s"] + out["wave"]["default again"]["build_s"]) / 2
    for name, rec in out["wave"].items():
        print(f"[{label}] waves {name}: {rec['build_s'] / base_s:.3f}x the defaults' mean build seconds, "
              f"{rec['beam_iters'] / max(1, base['beam_iters']):.3f}x their beam iterations, "
              f"{rec['build_launches'] / max(1, base['build_launches']):.3f}x their kernel launches", flush=True)
    torch.cuda.empty_cache()

    # ---- (b) the bulk path ----
    bdata = data[:N_OPTION_BULK]
    top = _exact_top(device, bdata, queries)
    graphs = {}
    for name, opts in BULK_OPTIONS:
        rec, g, dev, res = option_build(device, bdata, top, label, f"bulk {name}", card, **opts)
        check("bulk", name, rec, {"bulk_renumber": "bulk_renumber", "bulk_init=random": "bulk_kmeans",
                                  "bulk_backbone=False,bulk_upper=1": "bulk_upper_tri"}.get(name, "bulk_build"))
        if name == "bulk_init=random" and "bulk_maxmin" in rec["spans"]:
            raise AssertionError(f"[{label}] bulk_init=random ran the maxmin init")
        out["bulk"][name] = rec
        if name in ("default", "bulk_renumber"):
            graphs[name] = (g, dev, res)
        del g, dev
    (pg, pdev, pres), (rg, rdev, rres) = graphs["default"], graphs["bulk_renumber"]
    if np.array_equal(rg.ids, pg.ids):
        raise AssertionError(f"[{label}] bulk_renumber left the slots as they were")
    p_ids, r_ids = pg.ids[pres.slots.clamp(min=0).cpu().numpy()], rg.ids[rres.slots.clamp(min=0).cpu().numpy()]
    same_ids = bool(np.array_equal(p_ids, r_ids))
    same_d = bool(torch.equal(pres.dists, rres.dists))
    q, qn, _ = top
    efu = default_ef_upper(N_OPTION_BULK, ef)
    times: dict[str, list] = {"default": [], "bulk_renumber": []}
    for name in ("default", "bulk_renumber", "bulk_renumber", "default") * ((QPS_TURNS + 1) // 2):
        if len(times[name]) < QPS_TURNS:
            d = pdev if name == "default" else rdev
            times[name].append(one_call(device, lambda d=d: hnsw_search(d, q, qn, ef, ef_upper=efu)))
    qps = {k: N_QUERIES / float(np.median(v)) for k, v in times.items()}
    out["renumber"] = {"same_ids": same_ids, "same_dists": same_d, "qps": qps,
                       "qps_ratio": qps["bulk_renumber"] / qps["default"], "seconds": times}
    print(f"[{label}] bulk_renumber: answers {'equal' if same_ids and same_d else 'NOT equal'} to the default "
          f"build's by item id and distance; hnsw_search at ef={ef} {qps['default']:.1f} QPS plain, "
          f"{qps['bulk_renumber']:.1f} QPS renumbered (median of {QPS_TURNS} each, in turns; ratio "
          f"{out['renumber']['qps_ratio']:.3f}) ({card})", flush=True)
    if not (same_ids and same_d):
        raise AssertionError(f"[{label}] the renumbered build's answers differ from the plain build's by item id")
    base_s = (out["bulk"]["default"]["build_s"] + out["bulk"]["default again"]["build_s"]) / 2
    for name, rec in out["bulk"].items():
        print(f"[{label}] bulk {name}: {rec['build_s'] / base_s:.3f}x the defaults' mean build seconds, "
              f"recall@10 {rec['recall_at_10']:.4f}{' (printed, not barred)' if name in UNBARRED else ''}", flush=True)
    del graphs, pg, pdev, rg, rdev, pres, rres
    torch.cuda.empty_cache()

    # ---- (c) the sharded churn with slack, on phase 10's database ----
    S, n = N_SHARDS, N_SHARDED
    devices = [device] * S
    kernel = beam_cuda.KERNEL
    reset_counts()
    sdata, squeries = bench_data(np.random.default_rng(42), n)
    # the items phase 10 left: its data but the deleted, and its appended
    live = np.setdiff1d(np.arange(n), sharded["deleted"])
    ids = np.concatenate([live, np.arange(n, n + N_APPEND)])
    vecs = np.concatenate([sdata[live], bench_append(N_APPEND, seed=43, n_data=n)])
    del sdata
    db = Database(sharded_dir, Metric.COSINE, map_size=SHARDED_MAP_SIZE)
    reader = ShardedReader(db, S, devices=devices)
    eps = sorted({int(e) for r in reader._readers for e in r._metadata.entry_points})
    del reader
    rest = np.setdiff1d(ids, eps)
    doomed = np.sort(np.concatenate([eps, np.random.default_rng(47).choice(rest, SHARDED_DELETE - len(eps), replace=False)]))
    extra = bench_append(N_APPEND, seed=46, n_data=n)
    new_ids = np.arange(n + N_APPEND, n + 2 * N_APPEND)
    writer = ShardedWriter(db, DIM, n_shards=S, m=M, ef=EFC, devices=devices)
    writer.add_items(new_ids, extra)
    for i in doomed.tolist():
        if not writer.del_item(int(i)):
            raise AssertionError(f"[{label}] item {i} was not there to delete")
    opts = BuildOptions(ef_construction=EFC, link_slack=SHARDED_SLACK)
    with tracing.record(fence=lambda: _sync(device), probe=all_launches) as spans:
        _, build_s = _timed(label, card, device, f"sharded lockstep build with link_slack={SHARDED_SLACK} "
                            f"(+{N_APPEND} / -{SHARDED_DELETE}, {len(eps)} entry points; fenced spans)",
                            lambda: writer.build(opts=opts))
    sp = _print_spans(label, spans, skip=("insert_wave", "spmd_wave", "repair_level"))
    for need in ("spmd_waves", "prune_slack_rows", "repair_deletions", "inbound_recheck"):
        if need not in sp:
            raise AssertionError(f"[{label}] the lockstep build did not go through {need}: {sorted(sp)}")
    db.commit_rw_txn()
    out["sharded"] = {"build_s": build_s, "spans": sp}
    out["sharded"]["launches"] = count_main_path(f"{label}: sharded lockstep build with slack")
    reset_counts()
    reader = ShardedReader(db, S, devices=devices)
    if reader.n_items() != len(ids) - SHARDED_DELETE + N_APPEND:
        raise AssertionError(f"[{label}] {reader.n_items()} items after the churn")
    reader.assert_validity()
    answers = reader.search(squeries, n=K, ef_search=ef)
    gone = set(doomed.tolist()) | set(sharded["deleted"])
    if any(i in gone for row in answers for i, _ in row):
        raise AssertionError(f"[{label}] a deleted item came back in an answer")
    survivors = np.concatenate([vecs[~np.isin(ids, doomed)], extra])
    _, _, thresh = _exact_top(device, survivors, squeries)
    thresh = thresh[:, 0].cpu().numpy()
    if any(len(row) != K for row in answers):
        raise AssertionError(f"[{label}] a query came back with fewer than {K} results")
    out["sharded"]["recall_at_10"] = float(np.mean([[d <= thresh[b] for _, d in row] for b, row in enumerate(answers)]))
    firsts = reader.search(extra, n=1, ef_search=ef)
    out["sharded"]["self_hit"] = float(np.mean([bool(row) and row[0][0] == int(new_ids[i]) for i, row in enumerate(firsts)]))
    out["sharded"]["search_launches"] = count_main_path(f"{label}: sharded search after the churn")
    print(f"[{label}] sharded, link_slack={SHARDED_SLACK}: {reader.n_items()} items valid, no deleted id in "
          f"{N_QUERIES} answers, recall@10 {out['sharded']['recall_at_10']:.4f}, self-hit of the {N_APPEND} "
          f"appended items {out['sharded']['self_hit']:.4f} ({card})", flush=True)
    db.close()
    if out["sharded"]["recall_at_10"] < RECALL_BAR or out["sharded"]["self_hit"] < SELF_HIT_BAR:
        raise AssertionError(f"[{label}] sharded recall@10 {out['sharded']['recall_at_10']} or self-hit "
                             f"{out['sharded']['self_hit']}")
    return out


def scale_path(device, path: str, card: str) -> dict:
    """Phase 12: the main path at the size its users run — ``N_SCALE`` x
    768 cosine (``bench_data``, seed 42, n/256 centres), m 16,
    ef_construction ``EFC_SCALE``, through Database / Writer / Reader in
    the empty directory ``path``: (a) ``add_items``; (b) ``build()``, which
    must take the bulk path with the flat backbone (``insert_wave``'s
    ``flat``), with its k-means clusters, backbone waves and peak device
    memory above the start; (c) commit; (d) ``by_vecs`` of the queries at
    each ef of ``SCALE_EF``: QPS (the median of ``SCALE_QPS_CALLS`` single
    calls after a first one) and tie-aware recall@10 against ``flat_topk``
    over every item (>= RECALL_BAR at ef 100); (e) close → reopen →
    ``Reader.open``, its load and upload apart, device bytes per item →
    the same answers at ef 100, ``assert_validity``; (f) append
    ``N_APPEND`` (seed 43) → ``build()`` (``fork_graph`` of the graph the
    Reader loaded, ``fill_link_dists``, waves) → commit → self-hit >= SELF_HIT_BAR and
    ``assert_validity`` on every item. The search's pooled-descent width
    (span ``reader_search``) and the append's level-0 seed width (span
    ``insert_seeds``) must be ``SCALE_EF_UPPER``. Every span is fenced and
    carries its kernel launches; every launch must take the staged design.
    Nothing is caught."""
    import torch

    from hannoy_tpu_torch import Database, Metric
    from hannoy_tpu_torch.ops import beam_cuda, distances
    from hannoy_tpu_torch.utils import tracing

    label = "phase 12: the main path at 1M"
    kernel = beam_cuda.KERNEL
    n, ef = N_SCALE, EF_SWEEP[-1]
    out: dict = {"seconds": {}, "spans": {}, "launches": {}, "search": {}}

    def recorded():
        return tracing.record(fence=lambda: _sync(device), probe=all_launches)

    def timed(what: str, fn):
        return _timed(label, card, device, what, fn)

    def step_done(step: str) -> None:
        """The step's launches into the main path's counts; each one staged."""
        off = {f"{row}/{design}": c for (row, design), c in kernel.by_design.items() if design != "staged"}
        if off:
            raise AssertionError(f"[{label}] {step}: launches outside the staged design: {off}")
        for shape, c in _shapes(kernel.by_shape).items():
            SCALE_LAUNCHES[shape] = SCALE_LAUNCHES.get(shape, 0) + c
        out["launches"][step] = {"by_form": count_main_path(f"{label}: {step}"), "by_shape": _shapes(kernel.by_shape)}
        print(f"[{label}] {step}: kernel launches {kernel.launches} {_shapes(kernel.by_shape)}", flush=True)
        reset_counts()

    (data, queries), out["seconds"]["data"] = timed(f"bench_data of {n} x {DIM}",
                                                   lambda: bench_data(np.random.default_rng(42), n))

    # ---- (a) add → (b) build → (c) commit ----
    reset_counts()
    db = Database(path, Metric.COSINE, map_size=SCALE_MAP_SIZE)
    writer = db.writer(dimensions=DIM, m=M, ef=EFC_SCALE)
    _, out["seconds"]["add_items"] = timed(f"add_items of {n} x {DIM}", lambda: writer.add_items(range(n), data))
    del data
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    with recorded() as spans:
        stats, out["seconds"]["build"] = timed("build (fenced spans)", lambda: writer.builder(seed=42).build())
    out["build_peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    out["spans"]["build"] = sp = _print_spans(label, spans)
    waves = [s for s in spans if s.name == "insert_wave"]
    if "bulk_build" not in sp or not waves or not all(s.fields["flat"] for s in waves):
        raise AssertionError(f"[{label}] the build did not take the bulk path with the flat backbone: "
                             f"{sorted(sp)}, backbone waves {[s.fields for s in waves]}")
    by_level: dict[int, int] = {}
    for s in waves:
        by_level[s.fields["level"]] = by_level.get(s.fields["level"], 0) + 1
    out["backbone_waves"] = {"in_all": len(waves), "by_level": by_level,
                             "widths": sorted({s.fields["width"] for s in waves})}
    out["kmeans_clusters"] = [s.fields["clusters"] for s in spans if s.name == "bulk_kmeans"]
    print(f"[{label}] build: bulk path, flat backbone of {len(waves)} waves (by level {by_level}, widths "
          f"{out['backbone_waves']['widths']}), k-means clusters {out['kmeans_clusters']}, touched {len(stats.touched)} "
          f"rows; peak device memory {out['build_peak_bytes'] / 2**30:.3f} GiB above the start ({card})", flush=True)
    _, out["seconds"]["commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    step_done("add, build and commit")

    # ---- (d) search at each ef ----
    reader, out["seconds"]["reader_cached"] = timed("Reader.open (graph cached by the build)", db.reader)
    if reader.n_items() != n:
        raise AssertionError(f"[{label}] the index has {reader.n_items()} items, expected {n}")
    answers = {}
    for e in SCALE_EF:
        with tracing.record() as spans:
            answers[e] = reader.by_vecs(queries, n=K, ef_search=e)
        widths = sorted({s.fields["ef_upper"] for s in spans if s.name == "reader_search"})
        t = [one_call(device, lambda e=e: reader.by_vecs(queries, n=K, ef_search=e)) for _ in range(SCALE_QPS_CALLS)]
        rec = _tie_aware_recall(label, reader, queries, answers[e], distances.COSINE)
        out["search"][e] = {"recall_at_10": rec, "qps": N_QUERIES / float(np.median(t)), "ef_upper": widths,
                            "seconds": t}
        print(f"[{label}] by_vecs ef={e}: recall@10 {rec:.4f}, {out['search'][e]['qps']:.1f} QPS (median of "
              f"{SCALE_QPS_CALLS} calls of {N_QUERIES} queries), pooled descent {widths} wide ({card})", flush=True)
        if widths != [SCALE_EF_UPPER]:
            raise AssertionError(f"[{label}] the search's pooled descent was {widths} wide, not {SCALE_EF_UPPER}")
    step_done("search")
    # the host loop's answers (the same) and QPS in turns, and phase 13 on this database
    for e in SCALE_EF:
        out["search"][e]["turns"] = search_turns(label, reader, queries, e, card, profile=e == ef)
    out["search"][ef]["profiled"] = out["search"][ef]["turns"]["kernels"]["profiled"]
    out["search_kernels"] = search_kernel_checks("phase 13 on phase 12's database", reader, queries, card, slack=True,
                                                 plain_timing=True, timing_efs=SCALE_EF)
    if out["search"][ef]["recall_at_10"] < RECALL_BAR:
        raise AssertionError(f"[{label}] recall@10 at ef={ef} {out['search'][ef]['recall_at_10']} below {RECALL_BAR}")

    # ---- (e) close → reopen → the same answers, validity ----
    db.close()
    del reader, writer
    torch.cuda.empty_cache()
    db, out["seconds"]["reopen"] = timed("Database reopen (native store)",
                                         lambda: Database(path, Metric.COSINE, map_size=SCALE_MAP_SIZE))
    base = torch.cuda.memory_allocated(device)
    with recorded() as spans:
        reader, out["seconds"]["reader_open"] = timed("Reader.open (load from the store + upload)", db.reader)
    out["spans"]["reader_open"] = sp = _print_spans(label, spans)
    out["device_bytes_per_item"] = (torch.cuda.memory_allocated(device) - base) / n
    out["seconds"]["reader_load"] = sp["reader_load_graph"]["ms"] / 1e3
    out["seconds"]["reader_upload"] = sp["reader_to_device"]["ms"] / 1e3
    print(f"[{label}] Reader.open: load {out['seconds']['reader_load']:.3f} s, upload "
          f"{out['seconds']['reader_upload']:.3f} s; the Reader holds {out['device_bytes_per_item']:.1f} device bytes "
          f"per item ({card})", flush=True)
    if reader.n_items() != n or reader.by_vecs(queries, n=K, ef_search=ef) != answers[ef]:
        raise AssertionError(f"[{label}] the reopened index ({reader.n_items()} items) answers otherwise at ef={ef}")
    print(f"[{label}] the {N_QUERIES} answers at ef={ef} are the same before the close and after the reopen", flush=True)
    _, out["seconds"]["assert_validity"] = timed(f"Reader.assert_validity on {n} items", reader.assert_validity)
    step_done("reopen and search")
    del reader
    torch.cuda.empty_cache()

    # ---- (f) append → build → commit → self-hit, validity ----
    extra = bench_append(N_APPEND, seed=43, n_data=n)
    writer = db.writer(dimensions=DIM, m=M, ef=EFC_SCALE)
    _, out["seconds"]["append_add_items"] = timed(f"add_items of {N_APPEND} more",
                                                  lambda: writer.add_items(range(n, n + N_APPEND), extra))
    with recorded() as spans:
        stats, out["seconds"]["append_build"] = timed("append build (fenced spans)", lambda: writer.builder(seed=42).build())
    out["spans"]["append_build"] = sp = _print_spans(label, spans, skip=("insert_wave", "insert_seeds"))
    for need in ("fork_graph", "fill_link_dists", "insert_wave"):  # the Reader's loaded graph, forked
        if need not in sp:
            raise AssertionError(f"[{label}] the append did not go through {need}: {sorted(sp)}")
    if sp["fill_link_dists"]["launches"] == 0:
        raise AssertionError(f"[{label}] fill_link_dists launched no kernel")
    seeds: dict[int, set] = {}
    for s in spans:
        if s.name == "insert_seeds":
            seeds.setdefault(s.fields["level"], set()).add(s.fields["ef_upper"])
    out["append_seed_widths"] = {lv: sorted(w) for lv, w in sorted(seeds.items())}
    print(f"[{label}] append: {stats.waves} waves, touched {len(stats.touched)} rows; insertion seeds by level "
          f"{out['append_seed_widths']} wide; fill_link_dists launched the kernel {sp['fill_link_dists']['launches']} "
          f"times", flush=True)
    if seeds.get(0) != {SCALE_EF_UPPER}:
        raise AssertionError(f"[{label}] the append's level-0 items were seeded {seeds.get(0)} wide, not {SCALE_EF_UPPER}")
    _, out["seconds"]["append_commit"] = timed("commit_rw_txn", db.commit_rw_txn)
    reader = db.reader()
    if reader.n_items() != n + N_APPEND:
        raise AssertionError(f"[{label}] the index has {reader.n_items()} items after the append")
    firsts = reader.by_vecs(extra, n=1, ef_search=ef)
    out["self_hit"] = float(np.mean([bool(row) and row[0][0] == n + i for i, row in enumerate(firsts)]))
    print(f"[{label}] the {N_APPEND} appended items find themselves first in {out['self_hit']:.4f} of rows at "
          f"ef={ef} ({card})", flush=True)
    _, out["seconds"]["assert_validity_after_append"] = timed(f"Reader.assert_validity on {n + N_APPEND} items",
                                                              reader.assert_validity)
    step_done("append and self-hit")
    del reader, writer
    db.close()
    if out["self_hit"] < SELF_HIT_BAR:
        raise AssertionError(f"[{label}] self-hit {out['self_hit']} below {SELF_HIT_BAR}")
    print(f"[{label}] seconds by step: {json.dumps({k: round(v, 3) for k, v in out['seconds'].items()})}", flush=True)
    return out


def budget_sweep(label: str, reader, queries, card: str) -> list[dict]:
    """The 1M layer-0 beam ([256, 100, 32]) and a layer-1 beam of
    ``SEED_BATCH`` store rows ([4096, 32, 16], an append's seeds) at each
    staging budget of ``BUDGET_SWEEP`` (``search_cuda.BLOCK_BUDGET``), in
    turns (the list, then again reversed): ms (``per_launch_ms``) and the
    staging rows the rule gave, the answers the same at every budget."""
    import torch

    from hannoy_tpu_torch.ops import search_cuda

    dev = reader._dev
    q, qn = reader._prep_queries(queries)
    top, ef, efu = dev.max_level, SEARCH_EF, SCALE_EF_UPPER
    s1 = search_cuda.greedy_descend_kernel(dev, q, qn, top, 2, 128, dev.valid)[:, None]
    s0 = search_cuda.beam_search_kernel(dev, q, qn, s1, efu, 2 * efu + 16, dev.valid, 1)[1]
    slots = torch.arange(0, SEED_BATCH * 97, 97, dtype=torch.int64, device=dev.vectors.device) % reader.n_items()
    sq, sqn = dev.vectors[slots].float(), dev.norms[slots]
    seeds = search_cuda.greedy_descend_kernel(dev, sq, sqn, top, 2, 128, dev.valid)[:, None]
    cases = {"layer 0 [256, 100, 32]": (lambda: search_cuda.beam_search_kernel(dev, q, qn, s0, ef, 2 * ef + 16, dev.valid, 0),
                                        dev.links0.shape[1], ef),
             f"layer 1 [{SEED_BATCH}, {efu}, {dev.upper_links.shape[-1]}]": (
                 lambda: search_cuda.beam_search_kernel(dev, sq, sqn, seeds, efu, 2 * efu + 16, dev.valid, 1),
                 dev.upper_links.shape[-1], efu)}
    saved = search_cuda.BLOCK_BUDGET
    out = []
    try:
        for name, (fn, width, e) in cases.items():
            times: dict = {}
            answers = {}
            for budget in (*BUDGET_SWEEP, *reversed(BUDGET_SWEEP)):
                search_cuda.BLOCK_BUDGET = budget
                times.setdefault(budget, []).append(per_launch_ms([fn], SEARCH_LAUNCHES))
                answers.setdefault(budget, fn()[1])
            same = all(bool(torch.equal(a, answers[BUDGET_SWEEP[0]])) for a in answers.values())
            for budget in BUDGET_SWEEP:
                search_cuda.BLOCK_BUDGET = budget
                _, rows, smem = search_cuda.beam_shared(DIM, DIM * dev.vectors.element_size(), e, width)
                out.append({"case": name, "budget": budget, "rows": rows, "smem": smem, "ms": times[budget],
                            "same_answers": same})
                print(f"[{label}] staging budget {budget} B ({rows} rows, {smem} B a block): {name} "
                      f"{times[budget]} ms, the same answers {same} ({card})", flush=True)
    finally:
        search_cuda.BLOCK_BUDGET = saved
    return out


def search_only(device, path: str, card: str) -> dict:
    """``--search-only``: phase 13 alone, after a change to the search
    kernels: its small stores, then the checks, timings, split and (with
    ``--against``) the A/B of ``search_kernel_checks`` on a 100k and an
    ``N_SCALE`` f32 cosine Reader (``bench_data``, seed 42) built through
    the API in ``path``, and at 1M the staging budgets of
    ``budget_sweep``."""
    import torch

    from hannoy_tpu_torch import Database, Metric

    out = {"edge_cases": search_edge_cases(device, card)}
    for n, efc in ((N, EFC), (N_SCALE, EFC_SCALE)):
        label = f"phase 13 alone at {n}"
        data, queries = bench_data(np.random.default_rng(42), n if n != N else 0)
        db = Database(os.path.join(path, str(n)), Metric.COSINE, map_size=SCALE_MAP_SIZE)
        writer = db.writer(dimensions=DIM, m=M, ef=efc)
        t0 = time.perf_counter()
        writer.add_items(range(n), data)
        del data
        writer.builder(seed=42).build()
        db.commit_rw_txn()
        reader = db.reader()
        print(f"[{label}] built and opened in {time.perf_counter() - t0:.1f} s", flush=True)
        out[n] = search_kernel_checks(label, reader, queries, card, slack=True, timing_efs=SCALE_EF)
        if n == N_SCALE:
            out["budget_sweep"] = budget_sweep(label, reader, queries, card)
        db.close()
        del reader, writer
        torch.cuda.empty_cache()
    return out


def _spans_of(fn) -> set:
    """Run ``fn`` → the names of the spans it opened."""
    from hannoy_tpu_torch.utils import tracing

    with tracing.record() as spans:
        fn()
    return {s.name for s in spans}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one", file=sys.stderr)
        return 1
    from hannoy_tpu_torch.ops import beam_cuda

    # phase 1: the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matrix products must run in full f32 (TF32 off)")
    device = torch.device("cuda", 0)

    # phase 2: build the kernels, one nvcc a source, all started together
    import re

    from hannoy_tpu_torch.ops import search_cuda

    args = sys.argv[1:]
    if "--against" in args:  # phase 13's A/B: another search.cu, built beside the package's
        from pathlib import Path

        AGAINST.append(beam_cuda.CudaLibrary(Path(args[args.index("--against") + 1]).resolve(), search_cuda._bind))
    t0 = time.perf_counter()
    beam_cuda.build_all(beam_cuda.KERNEL, search_cuda.KERNELS, *AGAINST)
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in (beam_cuda.KERNEL, search_cuda.KERNELS, *AGAINST):
        log = lib.build_log
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        print(f"  {os.path.relpath(lib.library_path())} (nvcc {lib.build_seconds:.2f} s)"
              + (f": {len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, "
                 f"{max(spills, default=0)} bytes of spills at most" if regs else ""), flush=True)
    from hannoy_tpu_torch.store import native_env

    t0 = time.perf_counter()
    native_env.load_library()
    print(f"store library built: {os.path.relpath(native_env.library_path())} in {time.perf_counter() - t0:.2f} s", flush=True)

    if "--search-only" in args:  # phase 13 alone, for a change to the search kernels
        with tempfile.TemporaryDirectory() as search_dir:
            only = search_only(device, search_dir, card)
        print("detail " + json.dumps({"search_only": only}, default=str))
        print(f"chip_smoke --search-only: phase 13's checks passed; phases 3-12 not run ({card})", flush=True)
        return 0
    cases, floors = check_kernel(device)  # phase 3
    phase_s: dict[str, float] = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """Wall seconds since the last lap (or since phase 3 ended)."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"{name} took {phase_s[name]:.1f} s", flush=True)

    if "--kernel-only" in args:  # a short first run of new kernel code: build, check, time, stop
        print(f"chip_smoke --kernel-only: {len(cases)} cases agree with their twins; phases 4-12 not run", flush=True)
        return 0
    torch.cuda.empty_cache()
    edge = search_edge_cases(device, card)  # phase 13, the cases no other phase's database holds
    lap("phase 13 (small cases)")
    watch_searches()
    data, queries = bench_data(np.random.default_rng(42))
    waves = drive(device, data, queries, "phase 4: wave build", bulk=False)  # phase 4
    waves["turns"] = build_turns(device, data, "phase 4: wave build", card, bulk=False)
    lap("phase 4")
    torch.cuda.empty_cache()
    default = drive(device, data, queries, "phase 5: default build", main_path=True)  # phase 5
    if "bulk_build" not in default["span_names"]:
        raise AssertionError("phase 5: the default build did not take the bulk path")
    default["fenced"] = fenced_spans(device, data, "phase 5: default build")
    default["profiled"] = profiled(lambda: timed_build(device, data)[2], "phase 5: default build", "build")
    lap("phase 5")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as api_dir:
        api = api_path(device, api_dir, data, queries, card)  # phase 6
        lap("phase 6")
        torch.cuda.empty_cache()
        packed = packed_path(device, data, queries, card)  # phase 7
        lap("phase 7")
        torch.cuda.empty_cache()
        tiers = tier_path(device, data, queries, card)  # phase 8
        lap("phase 8")
        torch.cuda.empty_cache()
        deletes = delete_filter_path(device, api_dir, queries, card)  # phase 9
        lap("phase 9")
    del data
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as sharded_dir:
        sharded = sharded_path(device, sharded_dir, card)  # phase 10
        lap("phase 10")
        torch.cuda.empty_cache()
        options = options_path(device, sharded_dir, sharded, card)  # phase 11
        lap("phase 11")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as scale_dir:
        scale = scale_path(device, scale_dir, card)  # phase 12
        lap("phase 12")

    # the f32 cases beside their launches on the earlier paths
    for c in cases:
        if c["form"].startswith("f32/"):
            key = f"{c['shape'][0]}x{c['shape'][1]}"
            for path, res in (("wave_build", waves), ("default_build", default)):
                c[f"launches_{path}"] = res["build_launches_by_shape"].get(key, 0) + res["search_launches_by_shape"].get(key, 0)
            c["launches_api_path"] = sum(step.get(key, 0) for step in api["launches_by_shape"].values())

    # the shapes phase 12 launched that phase 3 timed on no store of its size
    timed_scale = {f"{c['shape'][0]}x{c['shape'][1]}" for c in cases if c["store_rows"] == N_SCALE}
    untimed = {shape: c for shape, c in SCALE_LAUNCHES.items() if shape not in timed_scale}
    print(f"phase 12 launches per [B, K]: {json.dumps(SCALE_LAUNCHES)}; not timed in phase 3 on a store of "
          f"{N_SCALE} rows: {json.dumps(untimed)}", flush=True)

    # every launch of the main path (all at 768-wide rows, whole 16-byte
    # units) went through the design for such rows: f32, bf16 and int8 the
    # staged design, packed rows the pair design
    designs = {f"{row}/{design}": n for (row, design), n in sorted(MAIN_DESIGNS.items())}
    print(f"main path launches per row type and design: {json.dumps(designs)}", flush=True)
    for row, design, other in (("f32", "staged", "warp"), ("bf16", "staged", "warp"), ("int8", "staged", "warp"),
                               ("packed", "pair", "group")):
        if MAIN_DESIGNS.get((row, other), 0) or not MAIN_DESIGNS.get((row, design), 0):
            raise AssertionError(f"the main path's {row} launches did not all go through the {design} design: {designs}")

    search_calls = check_search_calls()
    # one entry per form; its headline is the timed case of the metric the
    # main path drives in that form, at the shape it launches most
    driven = {"dot": "cosine", "difference": "euclidean", "popcount": "binary quantized cosine"}
    entries = []
    for form in sorted({c["form"] for c in cases}):
        main = MAIN_PATH.get(form, {"launches": 0, "by_shape": {}})
        if main["launches"] == 0:
            raise AssertionError(f"the main path (phases 5-12) never launched the kernel's {form} form: {MAIN_PATH}")
        own = [c for c in cases if c["form"] == form]
        for c in own:  # the main path's stores: N items, and N_SCALE in phase 12 (f32 cosine)
            key = f"{c['shape'][0]}x{c['shape'][1]}"
            at_scale = SCALE_LAUNCHES.get(key, 0) if form == "f32/dot" else 0
            c["launches_main_path"] = {N: main["by_shape"].get(key, 0) - at_scale, N_SCALE: at_scale}.get(c["store_rows"], 0)
        head = max((c for c in own if c["metric"] == driven[form.split("/")[1]]), key=lambda c: c["launches_main_path"])
        print(f"form {form}: {main['launches']} launches on the main path {json.dumps(main['by_shape'])}; headline "
              f"{head['metric']} {head['shape']}: {head['ms']:.5f} ms, bound {head['bound_ms']:.5f} ms", flush=True)
        entries.append({
            "name": f"gather_distances[{form}]",
            "route": "cuda",
            "source": "hannoy_tpu_torch/csrc/gather_distances.cu",
            "design": "/".join(d for (r, d), n in sorted(MAIN_DESIGNS.items()) if r == form.split("/")[0] and n),
            "replaces": "hannoy_tpu/ops/beam_pallas.py:108",
            "launches": main["launches"],
            "launches_by_shape": main["by_shape"],
            "shape": head["shape"],
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,  # no single PyTorch call gathers and reduces
        })
    entries += search_entries()
    # everything measured, on one line of its own ahead of the closing
    # three (which stay short): every timed case and every path's record
    print("detail " + json.dumps({"cases": cases, "launch_floors": floors, "phase_seconds": phase_s, "paths": {
        "wave_build": waves, "default_build": default, "api_path": api, "packed_path": packed, "tier_path": tiers,
        "delete_filter_path": deletes, "sharded_path": sharded, "options_path": options, "scale_path": scale},
        "search_kernels": {"cases": SEARCH_CASES, "edge_cases": edge, "calls": search_calls,
                           "main_path_launches": {"/".join(k): n for k, n in sorted(MAIN_SEARCH.items())},
                           "main_path_launches_by_level": {f"{k}/{level}": n
                                                           for (k, level), n in sorted(MAIN_SEARCH_LEVELS.items())}}}))
    kernels = {"kernels": entries}
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
