"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the ``nvidia-smi`` name and power limit, TF32 off;
2. build: the gather-distance kernel, compiled with nvcc from
   ``hannoy_tpu_torch/csrc/gather_distances.cu``;
3. kernel against its plain twin on a random [100000, 768] store, at the
   main path's shapes — build hop [4096, 32], search hop [256, 32], the
   bulk build's random candidates [8192, 8] — for cosine (atol 1e-5),
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
   span, once under ``torch.profiler`` for the device's idle share.

The build seconds of phases 4 and 5 are the wall time of an unfenced
``build_graph``, ended by one ``torch.cuda.synchronize()``. The kernel's
launch counts (in all and per [B, K]) are set to 0 just before the build
and before the search and read just after each; both must be > 0.

The last three lines are the card line, a JSON object describing the
kernel, and ``{"ok": true, "device": {...}}``. Its headline time is the
phase-3 case (cosine) of the shape the default build and search launch
most. It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, DIM, N_QUERIES, K = 100_000, 768, 256, 10
M, M0, EFC, WAVE = 16, 32, 48, 4096
EF_SWEEP = (50, 100)
RECALL_BAR = 0.93
#: build hop, search hop, the bulk build's random-candidate step
KERNEL_SHAPES = ((4096, 32), (256, 32), (8192, 8))
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

    # each timed case beside its launches on both paths; the headline is
    # the case the default build and search launch most
    for c in cases:
        key = f"{c['shape'][0]}x{c['shape'][1]}"
        for path, res in (("wave_build", waves), ("default_build", default)):
            c[f"launches_{path}"] = res["build_launches_by_shape"].get(key, 0) + res["search_launches_by_shape"].get(key, 0)
    head = max((c for c in cases if c["metric"] == "cosine"), key=lambda c: c["launches_default_build"])
    print(f"headline case: cosine {head['shape']}, {head['launches_default_build']} of "
          f"{default['build_launches'] + default['search_launches']} launches of the default build and search", flush=True)
    kernels = {"kernels": [{
        "name": "gather_distances",
        "route": "cuda",
        "source": "hannoy_tpu_torch/csrc/gather_distances.cu",
        "replaces": "hannoy_tpu/ops/beam_pallas.py:108",
        "launches": default["build_launches"] + default["search_launches"],
        "shape": head["shape"],
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call gathers and reduces
        "cases": cases,
        "paths": {"wave_build": waves, "default_build": default},
    }]}
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
