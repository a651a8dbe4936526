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
   euclidean and manhattan (rtol 1e-5). Each time is one pair of CUDA
   events around many back-to-back launches, over the count, with the
   candidate rows rotating through 8 index sets so that they come from
   device memory, not the 50 MB L2 cache (median of 5 such pairs); beside
   it the least time the card could take (its bound: the distinct rows
   the indices touch, read once);
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

The build seconds of phases 4 and 5 are the wall time of an unfenced
``build_graph``, ended by one ``torch.cuda.synchronize()``. The kernel's
launch counts (in all and per [B, K]) are set to 0 just before the build
and before the search and read just after each; both must be > 0.

The last three lines are the card line, a JSON object describing the
kernel, and ``{"ok": true, "device": {...}}``. Its headline time is the
phase-3 case (cosine) of the shape the default build, its search and the
API path launch most; its ``launches`` are those of phases 5 and 6, each
counted from 0. It needs no network and imports nothing of JAX.
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
#: phase 6: items appended after the reopen, the store's size limit, and
#: the least share of appended vectors that must find themselves first
N_APPEND = 2000
API_MAP_SIZE = 4 * 2**30
SELF_HIT_BAR = 0.99
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


def bound(name: str, b: int, k: int, rows: float) -> tuple[float, str]:
    """The least time (ms) for the gather-distance function at [b, k, DIM]
    whose indices touch ``rows`` distinct store rows: the larger of its
    bytes over the HBM rate — each distinct row once (rows·D·4; a row
    gathered twice need not be read twice) with its norm for cosine, the
    queries b·D·4 (and their norms), indices and outputs b·k·(4+4) — and
    its f32 operations (2 per element for a dot, 3 for a difference and
    its square or absolute value) over the f32 rate."""
    norm = 4 if name == "cosine" else 0
    nbytes = rows * (DIM * 4 + norm) + b * (DIM * 4 + norm) + b * k * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = b * k * DIM * (2 if name == "cosine" else 3) / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_kernel(device) -> list[dict]:
    """Phase 3: the kernel against its plain twin at the main path's shapes."""
    import torch

    from hannoy_tpu_torch.ops import beam_cuda, distances

    gen = torch.Generator(device=device).manual_seed(0)
    store = torch.randn((N, DIM), generator=gen, device=device)
    cases = []
    for name in ("cosine", "euclidean", "manhattan"):
        metric = distances.by_name(name)
        norms = store.norm(dim=1) if name == "cosine" else torch.zeros(N, device=device)
        for b, k in KERNEL_SHAPES:
            sets = []
            for _ in range(INDEX_SETS):
                q = torch.randn((b, DIM), generator=gen, device=device)
                qn = q.norm(dim=1) if name == "cosine" else torch.zeros(b, device=device)
                idx = torch.randint(0, N, (b, k), generator=gen, device=device, dtype=torch.int32)
                idx[torch.rand((b, k), generator=gen, device=device) < 0.05] = -1
                sets.append((q, qn, idx))
            q, qn, idx = sets[0]
            got = beam_cuda.gathered_distances(metric, store, norms, q, qn, idx)
            want = beam_cuda.gathered_distances_plain(metric, store, norms, q, qn, idx)
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.abs().clamp(min=1e-30)).max())
            ok = max_abs <= 1e-5 if name == "cosine" else max_rel <= 1e-5
            kernel_fns = [lambda s=s: beam_cuda.gathered_distances(metric, store, norms, *s) for s in sets]
            plain_fns = [lambda s=s: beam_cuda.gathered_distances_plain(metric, store, norms, *s) for s in sets]
            launches = max(16, (1 << 22) // (b * k))
            rows = float(np.mean([torch.unique(s[2].clamp(min=0)).numel() for s in sets]))
            bound_ms, bound_by = bound(name, b, k, rows)
            case = {
                "metric": name, "shape": [b, k, DIM], "max_abs_err": max_abs, "max_rel_err": max_rel,
                "ms": per_launch_ms(kernel_fns, launches),
                "plain_ms": per_launch_ms(plain_fns, max(8, launches // 8)),
                "bound_ms": bound_ms, "bound_by": bound_by, "distinct_rows": rows,
                "launches_per_event_pair": launches,
            }
            case["roofline_share"] = bound_ms / case["ms"]
            print(f"kernel {name} [{b},{k},{DIM}]: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
                  f"kernel {case['ms']:.5f} ms plain {case['plain_ms']:.5f} ms "
                  f"bound {bound_ms:.5f} ms "
                  f"({bound_by}, {rows:.0f} distinct rows; share {case['roofline_share']:.3f}; "
                  f"{launches} launches per event pair)", flush=True)
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(f"kernel disagrees with its twin: {case}")
            cases.append(case)
    return cases


def bench_data(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """``bench.py``'s clustered synthetic data: a Gaussian mixture with
    n//256 centres, plus queries drawn around the same centres."""
    n_clusters = max(32, N // 256)
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=N)
    data = (centers[assign] + rng.standard_normal((N, DIM))).astype(np.float32)
    q_assign = rng.integers(0, n_clusters, size=N_QUERIES)
    queries = (centers[q_assign] + rng.standard_normal((N_QUERIES, DIM))).astype(np.float32)
    return data, queries


def bench_append(n: int) -> np.ndarray:
    """``n`` more items around ``bench_data``'s centres (seed 42 draws the
    centres first; the items come from seed 43)."""
    n_clusters = max(32, N // 256)
    centers = np.random.default_rng(42).standard_normal((n_clusters, DIM)).astype(np.float32) * 4.0
    rng = np.random.default_rng(43)
    return (centers[rng.integers(0, n_clusters, size=n)] + rng.standard_normal((n, DIM))).astype(np.float32)


def stage(data):
    """A host graph with ``data`` staged in slots 0..N-1, cosine."""
    from hannoy_tpu_torch import HostGraph
    from hannoy_tpu_torch.models.hnsw import slot_capacity
    from hannoy_tpu_torch.ops import distances

    g = HostGraph.empty(distances.COSINE, DIM, M, M0, capacity=slot_capacity(N))
    for i in range(N):
        g.alloc_slot(i)
    g.vectors[:N] = data
    g.norms[:N] = distances.np_norms(distances.COSINE, data)
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
            g, np.arange(N, dtype=np.int64), np.empty(0, dtype=np.int64),
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


def drive(device, data, queries, label: str, **opts) -> dict:
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


def api_path(device, data, queries, card: str) -> dict:
    """Phase 6: add → build → commit → search → close → reopen → search →
    append → build → commit → search, through Database / Writer / Reader.
    Every span is fenced; nothing is caught."""
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
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"[{label}] {what}: {dt:.3f} s ({card})", flush=True)
        return out, dt

    out: dict = {"seconds": {}, "spans": {}, "launches_by_shape": {}}
    kernel.reset_counts()
    with tempfile.TemporaryDirectory() as path:
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
        print(f"[{label}] recall@10 at ef={ef} through Reader.by_vecs: {recall:.4f}", flush=True)
        if recall < RECALL_BAR:
            raise AssertionError(f"[{label}] recall@10 {recall} below {RECALL_BAR}")
        _, out["seconds"]["assert_validity"] = timed(f"Reader.assert_validity on the {N}-item index", reader.assert_validity)

        # the API's host cost: by_vecs against the engine on the same graph,
        # in turns after a warm-up of each, medians of the single calls.
        # A by_vecs call's own "reader_search" span (hnsw_search and the one
        # transfer of its result) says how much of it is the search: the
        # rest is the API's host work, whatever the card did between turns.
        efu = default_ef_upper(N, ef)

        def one(fn) -> float:
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            return time.perf_counter() - t0

        def engine():
            hnsw_search(reader._dev, q, qn, ef, max_iters=2 * ef + 16, ef_upper=efu)

        for _ in range(2):
            reader.by_vecs(queries, n=K, ef_search=ef)
            engine()
        reps = 7
        times: dict[str, list] = {"by_vecs": [], "of which reader_search": [], "hnsw_search": []}
        for _ in range(reps):
            with tracing.record() as spans:
                times["by_vecs"].append(one(lambda: reader.by_vecs(queries, n=K, ef_search=ef)))
            times["of which reader_search"].append(sum(s.ms for s in spans if s.name == "reader_search") / 1e3)
            times["hnsw_search"].append(one(engine))
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
        db.close()
    out.update(recall_at_10=recall, self_hit=self_hit, launches=step1 + step2 + step3,
               launches_by_step={"build_and_search": step1, "reopen_and_search": step2, "append": step3})
    print(f"[{label}] kernel launches by [B, K]: {json.dumps(out['launches_by_shape'])}", flush=True)
    if min(step1, step2, step3) == 0:
        raise AssertionError(f"[{label}] a step launched no kernel: {out['launches_by_step']}")
    return out


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
    for line in beam_cuda.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}", flush=True)
    from hannoy_tpu_torch.store import native_env

    t0 = time.perf_counter()
    native_env.load_library()
    print(f"store library built: {os.path.relpath(native_env.library_path())} in {time.perf_counter() - t0:.2f} s", flush=True)

    cases = check_kernel(device)  # phase 3
    torch.cuda.empty_cache()
    data, queries = bench_data(np.random.default_rng(42))
    waves = drive(device, data, queries, "phase 4: wave build", bulk=False)  # phase 4
    torch.cuda.empty_cache()
    default = drive(device, data, queries, "phase 5: default build")  # phase 5
    if "bulk_build" not in default["span_names"]:
        raise AssertionError("phase 5: the default build did not take the bulk path")
    default["fenced"] = fenced_spans(device, data, "phase 5: default build")
    default["profiled"] = profiled_build(device, data, "phase 5: default build")
    torch.cuda.empty_cache()
    api = api_path(device, data, queries, card)  # phase 6

    # each timed case beside its launches on both paths; the headline is
    # the case the default build and search launch most
    for c in cases:
        key = f"{c['shape'][0]}x{c['shape'][1]}"
        for path, res in (("wave_build", waves), ("default_build", default)):
            c[f"launches_{path}"] = res["build_launches_by_shape"].get(key, 0) + res["search_launches_by_shape"].get(key, 0)
        c["launches_api_path"] = sum(step.get(key, 0) for step in api["launches_by_shape"].values())
    main_launches = default["build_launches"] + default["search_launches"] + api["launches"]
    head = max((c for c in cases if c["metric"] == "cosine"),
               key=lambda c: c["launches_default_build"] + c["launches_api_path"])
    print(f"headline case: cosine {head['shape']}, {head['launches_default_build'] + head['launches_api_path']} of "
          f"{main_launches} launches of the default build, its search and the API path", flush=True)
    kernels = {"kernels": [{
        "name": "gather_distances",
        "route": "cuda",
        "source": "hannoy_tpu_torch/csrc/gather_distances.cu",
        "replaces": "hannoy_tpu/ops/beam_pallas.py:108",
        "launches": main_launches,
        "shape": head["shape"],
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call gathers and reduces
        "cases": cases,
        "paths": {"wave_build": waves, "default_build": default, "api_path": api},
    }]}
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
