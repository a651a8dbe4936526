"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the ``nvidia-smi`` name and power limit, TF32 off;
2. build: the gather-distance kernel, compiled with nvcc from
   ``hannoy_tpu_torch/csrc/gather_distances.cu``;
3. kernel against its plain twin on a random [100000, 768] store, at the
   build hop shape [4096, 32] and the search hop shape [256, 32], for
   cosine (atol 1e-5), euclidean and manhattan (rtol 1e-5), with median
   CUDA-event times of both over 20 runs;
4. the main path at 100k × 768 cosine (``bench.py``'s data, seed 42):
   stage → ``build_graph`` (insertion waves, efc 48, wave 4096) →
   ``check_validity`` → ``to_device`` → ``hnsw_search`` at ef 50 and 100,
   recall@10 against ``flat_topk`` (required >= 0.93 at ef=100), with the
   kernel's launch count read around the build and around the search.

The last three lines are the card line, a JSON object describing the
kernel, and ``{"ok": true, "device": {...}}``. It needs no network and
imports nothing of JAX.
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
KERNEL_SHAPES = ((4096, 32), (256, 32))  # build hop, search hop
TIMED_RUNS = 20


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


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median CUDA-event time of ``fn()`` after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
            q = torch.randn((b, DIM), generator=gen, device=device)
            qn = q.norm(dim=1) if name == "cosine" else torch.zeros(b, device=device)
            idx = torch.randint(0, N, (b, k), generator=gen, device=device, dtype=torch.int32)
            idx[torch.rand((b, k), generator=gen, device=device) < 0.05] = -1
            got = beam_cuda.gathered_distances(metric, store, norms, q, qn, idx)
            want = beam_cuda.gathered_distances_plain(metric, store, norms, q, qn, idx)
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.abs().clamp(min=1e-30)).max())
            ok = max_abs <= 1e-5 if name == "cosine" else max_rel <= 1e-5
            case = {
                "metric": name, "shape": [b, k, DIM], "max_abs_err": max_abs, "max_rel_err": max_rel,
                "ms": median_ms(lambda: beam_cuda.gathered_distances(metric, store, norms, q, qn, idx)),
                "plain_ms": median_ms(lambda: beam_cuda.gathered_distances_plain(metric, store, norms, q, qn, idx)),
            }
            print(f"kernel {name} [{b},{k},{DIM}]: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
                  f"kernel {case['ms']:.4f} ms plain {case['plain_ms']:.4f} ms", flush=True)
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


def main_path(device) -> dict:
    """Phase 4: stage → build → validate → upload → search, with recall."""
    import torch

    from hannoy_tpu_torch import BuildOptions, HostGraph, build_graph, default_ef_upper, flat_topk, hnsw_search
    from hannoy_tpu_torch.models.hnsw import slot_capacity, to_device
    from hannoy_tpu_torch.ops import beam_cuda, distances

    metric = distances.COSINE
    data, queries = bench_data(np.random.default_rng(42))
    g = HostGraph.empty(metric, DIM, M, M0, capacity=slot_capacity(N))
    for i in range(N):
        g.alloc_slot(i)
    g.vectors[:N] = data
    g.norms[:N] = distances.np_norms(metric, data)

    beam_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    stats = build_graph(
        g, np.arange(N, dtype=np.int64), np.empty(0, dtype=np.int64),
        BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False), device=device,
    )
    _sync(device)
    build_s = time.perf_counter() - t0
    build_launches = beam_cuda.KERNEL.launches
    print(f"build: {N} x {DIM} cosine in {build_s:.3f} s ({N / build_s:.1f} vec/s), waves {stats.waves}, "
          f"beam iters {stats.beam_iters}, max_level {g.max_level}, kernel launches {build_launches}", flush=True)
    t0 = time.perf_counter()
    g.check_validity()
    print(f"check_validity passed in {time.perf_counter() - t0:.3f} s", flush=True)

    dev = to_device(g, device, serve_only=True)
    q = torch.from_numpy(queries).to(device)
    qn = torch.from_numpy(distances.np_norms(metric, queries)).to(device)
    exact_d, _ = flat_topk(metric.name, q, qn, dev.vectors, dev.norms, dev.valid, K)
    # the oracle itself against numpy on a few queries
    few = distances.np_pairwise(metric, queries[:8], distances.np_norms(metric, queries[:8]), data, g.norms[:N])
    np.testing.assert_allclose(exact_d[:8].cpu().numpy(), np.sort(few, axis=1)[:, :K], rtol=0, atol=1e-5)
    thresh = exact_d[:, K - 1 : K] + 1e-6

    beam_cuda.KERNEL.launches = 0
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
            raise AssertionError(f"search at ef={ef} returned non-finite or mis-shaped results")
        if not ((res.slots[:, :K] >= 0) & (res.slots[:, :K] < N)).all():
            raise AssertionError(f"search at ef={ef} returned slots outside the index")
        recall = float((res.dists[:, :K] <= thresh).float().mean())
        results[ef] = {"recall_at_10": recall, "qps": N_QUERIES / dt, "ef_upper": efu, "iters": int(res.iters)}
        print(f"search ef={ef} ef_upper={efu}: recall@10 {recall:.4f}, {N_QUERIES / dt:.1f} QPS "
              f"({dt * 1e3:.3f} ms per {N_QUERIES}-query batch), beam iters {int(res.iters)}", flush=True)
    search_launches = beam_cuda.KERNEL.launches
    print(f"search kernel launches {search_launches}", flush=True)
    if results[EF_SWEEP[-1]]["recall_at_10"] < RECALL_BAR:
        raise AssertionError(f"recall@10 at ef={EF_SWEEP[-1]} below {RECALL_BAR}: {results}")
    if build_launches == 0 or search_launches == 0:
        raise AssertionError(f"the gather kernel did not run: build {build_launches}, search {search_launches}")
    return {"build_s": build_s, "build_launches": build_launches, "search_launches": search_launches, "search": results}


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
    path = main_path(device)  # phase 4

    build_case = next(c for c in cases if c["metric"] == "cosine" and c["shape"][0] == KERNEL_SHAPES[0][0])
    kernels = {"kernels": [{
        "name": "gather_distances",
        "route": "cuda",
        "source": "hannoy_tpu_torch/csrc/gather_distances.cu",
        "replaces": "hannoy_tpu/ops/beam_pallas.py:108",
        "launches": path["build_launches"] + path["search_launches"],
        "max_abs_err": build_case["max_abs_err"],
        "ms": build_case["ms"],
        "plain_ms": build_case["plain_ms"],
        "cases": cases,
        "main_path": path,
    }]}
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
