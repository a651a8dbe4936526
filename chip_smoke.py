"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the ``nvidia-smi`` name and power limit, TF32 off;
2. build: the gather-distance kernel, compiled with nvcc from
   ``hannoy_tpu_torch/csrc/gather_distances.cu``, and the store library,
   compiled with g++ from ``hannoy_tpu_torch/store/native/kvstore.cpp``;
3. kernel against its plain twin on a random [100000, 768] store, at the
   main path's shapes — build hop [4096, 32], search hop [256, 32], the
   bulk build's random candidates [8192, 8], the upper-layer rows of
   ``fill_link_dists`` [4096, 16] — for cosine (atol 1e-5),
   euclidean and manhattan (rtol 1e-5), and the deletion repair's
   spliced candidates [512, 64] for cosine and euclidean; then the same
   store in the bf16 and int8 tiers (the port's encoders) for the three
   metrics, and a random store of 768-bit packed rows for hamming and the
   three binary quantized metrics, at the first three shapes (and the
   tiers' cosine at [512, 64] too) (tiers: 1e-5 relative,
   summation order only; packed: bit-equal, BQ cosine 1.2e-7 absolute).
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
   recall@10 against ``flat_topk`` (required >= 0.93 at ef=100);
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
   the same centres → ``build()`` (incremental, through ``HostGraph.load``
   and ``fill_link_dists``) → commit → a new Reader (102,000 items, each
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
   commit → search, recall as above;
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
   itself, recall@10 >= 0.93 against ``flat_topk`` without the item);
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
   ``N_OPTION_WAVE`` = 50,000 items) with
   ``beam_expand=2``, ``traverse=24``, ``link_slack=16`` and
   ``chain_seeding`` (at least one chained wave); the bulk path with
   ``bulk_renumber`` (the 256 answers equal the default build's
   by item id and distance, and both graphs searched in turns for QPS),
   ``bulk_backbone=False, bulk_upper=1`` (recall printed only),
   ``backbone_flat=False`` and ``bulk_init="random"``: each build timed
   with its waves, chained waves, beam iterations and kernel launches,
   ``check_validity``, recall@10 at ef 100 >= 0.93 against ``flat_topk``;
   then phase 10's database, reopened: +2,000 / -400 (every shard's entry
   points among them) by the lockstep build with ``link_slack=8``
   (``prune_slack_rows`` and the stranding re-check per shard) →
   validity, no deleted id, recall, self-hit >= 0.99.

The build seconds of phases 4 and 5 are the wall time of an unfenced
``build_graph``, ended by one ``torch.cuda.synchronize()``. The kernel's
launch counts (in all and per [B, K]) are set to 0 just before the build
and before the search and read just after each; both must be > 0.

The last three lines are the card line, a JSON object describing the
kernel, and ``{"ok": true, "device": {...}}``; the line before them
(``detail {...}``) holds every timed case and each phase's record. The
kernel line has one
entry for each form of the kernel — row type (f32, bf16, int8, packed) ×
family (dot: cosine; difference: euclidean, manhattan; popcount: the
packed metrics) — with the launches that phases 5-11 made in that form,
each step counted from 0, the kernel design that served them, and as its
headline the phase-3 case of the shape those phases launch most. The run
fails if a form was never launched, or if an f32, bf16 or int8 launch of
phases 5-11 (all at 768-wide rows) did not take the staged design. Phase 3
also gives each case's per-pair floor (each pair's row read once) beside
its bound. ``--kernel-only`` stops after phase 3. It needs no network
and imports nothing of JAX.
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
#: phase 7: items of the HAMMING wave build
N_HAMMING = 20_000
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
#: the first N_OPTION_WAVE items (cut from 100k: phase 11 took ≈ 120 s
#: there against a budget of 75), the bulk path on all N; the recall of
#: ``bulk_upper=1`` is printed, not barred (the JAX package expects a
#: bulk-built layer 1 to lose recall); QPS_TURNS searches of each of the
#: plain and the renumbered bulk graph, in turns; the sharded churn of
#: phase 10's layout with SHARDED_SLACK slack columns
N_OPTION_WAVE = 50_000
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


def _index_sets(gen, device, make_query, b: int, k: int, tails: bool = False):
    """``INDEX_SETS`` × (q, qn, idx) with 5% of the indices at -1; with
    ``tails``, each row also ends in a run of -1 of random length (a hop
    over truncated rows or inactive expansions)."""
    import torch

    sets = []
    for _ in range(INDEX_SETS):
        q, qn = make_query(b)
        idx = torch.randint(0, N, (b, k), generator=gen, device=device, dtype=torch.int32)
        idx[torch.rand((b, k), generator=gen, device=device) < 0.05] = -1
        if tails:
            cut = torch.randint(1, k + 1, (b, 1), generator=gen, device=device)
            idx[torch.arange(k, device=device)[None, :] >= cut] = -1
        sets.append((q, qn, idx))
    return sets


def kernel_case(metric, row: str, store, norms, sets, tol: str, row_bytes: int, q_bytes: int, ops: int, build_query=None) -> dict:
    """One phase-3 case: the kernel against its twin on ``sets[0]`` (also
    with one index past the store, which must give NaN, and with
    ``build_query`` = (q, qn) gathered from the store), then both timed
    over all the sets. ``tol``: "abs" 1e-5, "rel" 1e-5, "exact", or "ulp"
    (1.2e-7 absolute)."""
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
    past[0, 0] = N
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
    floor_ms = pair_floor(b, k, row_bytes, q_bytes, header)
    case = {
        "form": f"{row}/{family}", "metric": name, "shape": [b, k, store.shape[1]], "tolerance": tol,
        "design": beam_cuda.design_of(store.dtype, metric, store.shape[1], True),
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": per_launch_ms(kernel_fns, launches),
        "plain_ms": per_launch_ms(plain_fns, max(8, launches // 8)),
        "bound_ms": bound_ms, "bound_by": bound_by, "distinct_rows": rows, "pair_floor_ms": floor_ms,
        "launches_per_event_pair": launches,
    }
    case["roofline_share"] = bound_ms / case["ms"]
    case["pair_floor_share"] = floor_ms / case["ms"]
    print(f"kernel {row} {name} [{b},{k},{store.shape[1]}] ({case['design']}): max_abs_err {max_abs:.3e} "
          f"max_rel_err {max_rel:.3e} ({tol}) kernel {case['ms']:.5f} ms plain {case['plain_ms']:.5f} ms "
          f"bound {bound_ms:.5f} ms ({bound_by}, {rows:.0f} distinct rows; share {case['roofline_share']:.3f}); "
          f"per-pair floor {floor_ms:.5f} ms (share {case['pair_floor_share']:.3f}); "
          f"{launches} launches per event pair", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with its twin: {case}")
    return case


def check_kernel(device) -> list[dict]:
    """Phase 3: every form of the kernel against its plain twin at the
    main path's shapes."""
    import torch

    from hannoy_tpu_torch.models import hnsw
    from hannoy_tpu_torch.ops import distances

    gen = torch.Generator(device=device).manual_seed(0)
    store = torch.randn((N, DIM), generator=gen, device=device)
    zeros = torch.zeros(N, device=device)
    cases = []

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

    # packed rows: 768 random bits a row, as int32 lanes
    lanes = DIM // 32
    packed = torch.randint(-(2**31), 2**31, (N, lanes), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    for name in PACKED_METRICS:
        metric = distances.by_name(name)
        fill = float(np.sqrt(np.float32(DIM))) if name == "binary quantized cosine" else 0.0
        norms = torch.full((N,), fill, device=device)

        def packed_query(b, fill=fill):
            q = torch.randint(-(2**31), 2**31, (b, lanes), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
            return q, torch.full((b,), fill, device=device)

        extra = PACKED_SHAPES + (OPTION_SHAPES if name == "binary quantized cosine" else ())
        for b, k in NEW_FORM_SHAPES + extra:
            sets = _index_sets(gen, device, packed_query, b, k, tails=(b, k) in OPTION_SHAPES)
            cases.append(kernel_case(metric, "packed", packed, norms, sets,
                                     "ulp" if name == "binary quantized cosine" else "exact", lanes * 4, lanes * 4, lanes * 3))
    return cases


def bench_data(rng: np.random.Generator, n: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``bench.py``'s clustered synthetic data: ``n`` items (``N`` when 0),
    a Gaussian mixture with n//256 centres, plus queries drawn around the
    same centres."""
    n = n or N
    n_clusters = max(32, n // 256)
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    data = (centers[assign] + rng.standard_normal((n, DIM))).astype(np.float32)
    q_assign = rng.integers(0, n_clusters, size=N_QUERIES)
    queries = (centers[q_assign] + rng.standard_normal((N_QUERIES, DIM))).astype(np.float32)
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


def profiled_build(device, data, label: str, **opts) -> dict:
    """The same build once more, unfenced, under ``torch.profiler`` → its
    wall seconds, the device's busy time (the sum of the device events:
    one stream, so they do not overlap) and idle share, and the kernels
    with the most device time. The profiler's own host cost is in the
    wall time, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = timed_build(device, data, **opts)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    out = {"build_s": wall, "device_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3) if busy else None,
           "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    idle = f"{out['idle_share']:.4f}" if busy else "not measured (the profiler saw no device events)"
    print(f"[{label}] profiled build: {wall:.3f} s wall, device busy {busy:.2f} ms, idle share {idle}", flush=True)
    for kname, ms in out["top"]:
        print(f"[{label}]   device {ms:.2f} ms: {kname[:110]}", flush=True)
    return out


#: launches of the main path (phases 5-11) per form "row/family" → {"launches", "by_shape"}
MAIN_PATH: dict[str, dict] = {}
#: launches of the main path per (row type, kernel design)
MAIN_DESIGNS: dict[tuple[str, str], int] = {}


def count_main_path(step: str) -> dict:
    """Add the kernel's counts since its last reset (one step of the main
    path, counted from 0) to ``MAIN_PATH`` → that step's launches per form.
    A step that ran one form gives that form its launches per [B, K]."""
    from hannoy_tpu_torch.ops import beam_cuda

    kernel = beam_cuda.KERNEL
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
    from hannoy_tpu_torch.ops import beam_cuda, distances

    metric = distances.COSINE
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    beam_cuda.KERNEL.reset_counts()
    g, stats, build_s, spans = timed_build(device, data, **opts)
    build_launches, build_shapes = beam_cuda.KERNEL.launches, _shapes(beam_cuda.KERNEL.by_shape)
    if main_path:
        count_main_path(f"{label}: build")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    print(f"[{label}] build: {N} x {DIM} cosine in {build_s:.3f} s ({N / build_s:.1f} vec/s), waves {stats.waves}, "
          f"beam iters {stats.beam_iters}, max_level {g.max_level}, kernel launches {build_launches} {build_shapes}, "
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

    beam_cuda.KERNEL.reset_counts()
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
    if main_path:
        count_main_path(f"{label}: search")
    print(f"[{label}] search kernel launches {search_launches} {search_shapes}", flush=True)
    if results[EF_SWEEP[-1]]["recall_at_10"] < RECALL_BAR:
        raise AssertionError(f"[{label}] recall@10 at ef={EF_SWEEP[-1]} below {RECALL_BAR}: {results}")
    if build_launches == 0 or search_launches == 0:
        raise AssertionError(f"[{label}] the gather kernel did not run: build {build_launches}, search {search_launches}")
    return {
        "build_s": build_s, "build_launches": build_launches, "search_launches": search_launches,
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
        return tracing.record(fence=lambda: _sync(device), probe=lambda: kernel.launches)

    def timed(what: str, fn):
        return _timed(label, card, device, what, fn)

    out: dict = {"seconds": {}, "spans": {}, "launches_by_shape": {}}
    kernel.reset_counts()
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
    step1 = kernel.launches
    count_main_path(f"{label}: build and search")
    db.close()

    # ---- step 2: reopen → the same answers, recall, validity ----
    kernel.reset_counts()
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
    step2 = kernel.launches
    count_main_path(f"{label}: reopen and search")

    # ---- step 3: append after the reopen → incremental build ----
    kernel.reset_counts()
    extra = bench_append(N_APPEND)
    writer = db.writer(dimensions=DIM, m=M, ef=EFC)
    _, out["seconds"]["append_add_items"] = timed(f"add_items of {N_APPEND} more", lambda: writer.add_items(range(N, N + N_APPEND), extra))
    with recorded() as spans:
        stats, out["seconds"]["append_build"] = timed("append build (fenced spans)", lambda: writer.builder(seed=42).build())
    out["spans"]["append_build"] = sp = _print_spans(label, spans)
    for need in ("load_graph", "fill_link_dists"):
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
    step3 = kernel.launches
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
    from hannoy_tpu_torch.ops import beam_cuda, codecs, distances
    from hannoy_tpu_torch.utils import tracing

    label = "phase 7: packed API path"
    kernel = beam_cuda.KERNEL
    ef = EF_SWEEP[-1]
    out: dict = {"seconds": {}, "spans": {}, "recall_at_10": {}, "launches": {}}

    def recorded():
        return tracing.record(fence=lambda: _sync(device), probe=lambda: kernel.launches)

    def timed(what, fn):
        return _timed(label, card, device, what, fn)

    def need_form(step: str, forms: dict, form: str = "packed/popcount") -> None:
        if set(forms) != {form}:
            raise AssertionError(f"[{label}] {step} launched {forms}, expected only {form}")
        out["launches"][step] = forms[form]

    # ---- (a) BQ cosine, 100k: add → bulk build → commit → search → reopen ----
    metric = distances.BQ_COSINE
    with tempfile.TemporaryDirectory() as path:
        kernel.reset_counts()
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

        kernel.reset_counts()
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
        db.close()

    # ---- (b) HAMMING, 20k, insertion waves: the packed wave hop and flat candidates ----
    metric = distances.HAMMING
    with tempfile.TemporaryDirectory() as path:
        kernel.reset_counts()
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
        kernel.reset_counts()
        db = Database(path, Metric.COSINE, map_size=API_MAP_SIZE)
        writer = db.writer(dimensions=DIM, m=M, ef=EFC)
        writer.add_items(range(N), data)
        _, out["seconds"]["migration_cosine_build"] = timed("cosine build before the migration", lambda: writer.builder(seed=42).build())
        db.commit_rw_txn()
        need_form("migration_cosine_build", count_main_path(f"{label}: cosine build before the migration"), "f32/dot")
        kernel.reset_counts()
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
    from hannoy_tpu_torch.ops import beam_cuda, distances

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
            kernel.reset_counts()
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
            if set(forms) != {form}:
                raise AssertionError(f"[{label}] {name} {tier} launched {forms}, expected only {form}")
            cell["launches"] = forms[form]
            print(f"[{label}] {key}: recall@10 at ef={ef} against the exact f32 top-10 {cell['recall_at_10']:.4f} "
                  f"(an exact scan of the tier's rows reaches {cell['exact_scan_recall_at_10']:.4f}), against the exact "
                  f"top-10 of the tier's rows {cell['recall_at_10_own_rows']:.4f}; "
                  f"Reader.by_vecs {cell['qps']:.1f} QPS (median of 5); a row takes {cell['row_bytes']} bytes, the Reader's "
                  f"whole upload holds {cell['reader_bytes'] / N:.1f} bytes per item ({cell['reader_bytes'] / 2**20:.1f} MiB, peak "
                  f"{cell['reader_peak_bytes'] / 2**20:.1f} MiB); kernel launches {kernel.launches} ({form}) ({card})", flush=True)
            # the graph search must reach the bar on the rows it serves, and
            # against f32 the bar's share of what the tier's encoding itself
            # keeps of the f32 answer (an exact scan of its rows)
            floor = RECALL_BAR * cell["exact_scan_recall_at_10"]
            if cell["recall_at_10_own_rows"] < RECALL_BAR or cell["recall_at_10"] < floor:
                raise AssertionError(f"[{label}] {name} {tier}: recall@10 {cell['recall_at_10_own_rows']} on its own rows "
                                     f"(bar {RECALL_BAR}), {cell['recall_at_10']} against f32 (floor {floor})")
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
        return tracing.record(fence=lambda: _sync(device), probe=lambda: kernel.launches)

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
    kernel.reset_counts()
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

    kernel.reset_counts()
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
    rows, out["seconds"]["by_items"] = timed(f"Reader.by_items of {len(ask)} items", lambda: reader.by_items(ask, n=K, ef_search=ef))
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
    kernel.reset_counts()
    t0 = time.perf_counter()
    out["cancel"] = cancel_checks(label, reader, queries, asked, cand_sets[CANCEL_FILTER_SHARE], set(doomed.tolist()), card)
    out["launches"]["cancelled_searches"] = count_main_path(f"{label}: cancelled searches")
    kernel.reset_counts()
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
        return tracing.record(fence=lambda: _sync(device), probe=lambda: kernel.launches)

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
    kernel.reset_counts()
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
    kernel.reset_counts()
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
    kernel.reset_counts()
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
    kernel.reset_counts()
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
    kernel.reset_counts()
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
    print(f"[{label}] kernel launches {total}: {json.dumps(out['launches'])}", flush=True)
    if min(sum(step.values()) for name, step in out["launches"].items() if name != "cancelled_build") == 0:
        raise AssertionError(f"[{label}] a step launched no kernel: {out['launches']}")
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
    beam_cuda.KERNEL.reset_counts()
    g, stats, build_s, spans = timed_build(device, data, **opts)
    rec = {"build_s": build_s, "waves": stats.waves, "beam_iters": stats.beam_iters,
           "chained_waves": sum(1 for sp in spans if sp.name == "insert_wave" and sp.fields.get("chained")),
           "build_launches": beam_cuda.KERNEL.launches, "build_launches_by_shape": _shapes(beam_cuda.KERNEL.by_shape),
           "spans": sorted({sp.name for sp in spans})}
    count_main_path(f"{label}: {name} build")
    g.check_validity()
    dev = to_device(g, device, serve_only=True)
    beam_cuda.KERNEL.reset_counts()
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
    the default again. (b) The bulk path on all N: the default build, then
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
    top = _exact_top(device, data, queries)
    graphs = {}
    for name, opts in BULK_OPTIONS:
        rec, g, dev, res = option_build(device, data, top, label, f"bulk {name}", card, **opts)
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
    efu = default_ef_upper(N, ef)
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
    kernel.reset_counts()
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
    with tracing.record(fence=lambda: _sync(device), probe=lambda: kernel.launches) as spans:
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
    kernel.reset_counts()
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

    # phase 2: build the kernel
    so = beam_cuda.KERNEL.build()
    print(f"kernel built: {os.path.relpath(so)} in {beam_cuda.KERNEL.build_seconds:.2f} s", flush=True)
    import re

    log = beam_cuda.KERNEL.build_log
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
    if regs:
        print(f"  nvcc: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, "
              f"{max(spills, default=0)} bytes of spills at most", flush=True)
    from hannoy_tpu_torch.store import native_env

    t0 = time.perf_counter()
    native_env.load_library()
    print(f"store library built: {os.path.relpath(native_env.library_path())} in {time.perf_counter() - t0:.2f} s", flush=True)

    cases = check_kernel(device)  # phase 3
    phase_s: dict[str, float] = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """Wall seconds since the last lap (or since phase 3 ended)."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"{name} took {phase_s[name]:.1f} s", flush=True)

    if "--kernel-only" in sys.argv[1:]:  # a short first run of new kernel code: build, check, time, stop
        print(f"chip_smoke --kernel-only: {len(cases)} cases agree with their twins; phases 4-11 not run", flush=True)
        return 0
    torch.cuda.empty_cache()
    data, queries = bench_data(np.random.default_rng(42))
    waves = drive(device, data, queries, "phase 4: wave build", bulk=False)  # phase 4
    lap("phase 4")
    torch.cuda.empty_cache()
    default = drive(device, data, queries, "phase 5: default build", main_path=True)  # phase 5
    if "bulk_build" not in default["span_names"]:
        raise AssertionError("phase 5: the default build did not take the bulk path")
    default["fenced"] = fenced_spans(device, data, "phase 5: default build")
    default["profiled"] = profiled_build(device, data, "phase 5: default build")
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

    # the f32 cases beside their launches on the earlier paths
    for c in cases:
        if c["form"].startswith("f32/"):
            key = f"{c['shape'][0]}x{c['shape'][1]}"
            for path, res in (("wave_build", waves), ("default_build", default)):
                c[f"launches_{path}"] = res["build_launches_by_shape"].get(key, 0) + res["search_launches_by_shape"].get(key, 0)
            c["launches_api_path"] = sum(step.get(key, 0) for step in api["launches_by_shape"].values())

    # every f32, bf16 and int8 launch of the main path (all at 768-wide
    # rows, whole 16-byte units) went through the staged design
    designs = {f"{row}/{design}": n for (row, design), n in sorted(MAIN_DESIGNS.items())}
    print(f"main path launches per row type and design: {json.dumps(designs)}", flush=True)
    for row in ("f32", "bf16", "int8"):
        if MAIN_DESIGNS.get((row, "warp"), 0) or not MAIN_DESIGNS.get((row, "staged"), 0):
            raise AssertionError(f"the main path's {row} launches did not all go through the staged design: {designs}")

    # one entry per form; its headline is the timed case of the metric the
    # main path drives in that form, at the shape it launches most
    driven = {"dot": "cosine", "difference": "euclidean", "popcount": "binary quantized cosine"}
    entries = []
    for form in sorted({c["form"] for c in cases}):
        main = MAIN_PATH.get(form, {"launches": 0, "by_shape": {}})
        if main["launches"] == 0:
            raise AssertionError(f"the main path (phases 5-11) never launched the kernel's {form} form: {MAIN_PATH}")
        own = [c for c in cases if c["form"] == form]
        for c in own:
            c["launches_main_path"] = main["by_shape"].get(f"{c['shape'][0]}x{c['shape'][1]}", 0)
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
    # everything measured, on one line of its own ahead of the closing
    # three (which stay short): every timed case and every path's record
    print("detail " + json.dumps({"cases": cases, "phase_seconds": phase_s, "paths": {
        "wave_build": waves, "default_build": default, "api_path": api, "packed_path": packed, "tier_path": tiers,
        "delete_filter_path": deletes, "sharded_path": sharded, "options_path": options}}))
    kernels = {"kernels": entries}
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
