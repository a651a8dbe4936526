"""annbench's general harness: one cell of ``BENCHMARK.json``, run once.

A cell names a configuration and a traffic mix. Everything that belongs to
one configuration, mix, kind of traffic, metric or distance is a file of
its own, found by its name, so that a later change adds files and edits
none:

* ``configs/<config>.json``: the deployment (sizes, metric, tier, build and
  search settings, the data generator and its parameters, its source);
* ``generators/<generator>.py``: makes the items and queries from the seed;
* ``distances/<metric>.py``: the plain reference's formula of the metric;
* ``mixes/<traffic>.json``: the traffic's parameters, with its ``kind``;
* ``drivers/<kind>.py``: the traffic of that kind (warm-up, window, the
  checks that only it can make);
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: the reader of one
  end-to-end or per-layer metric.

A run makes its data on the device from the seed, builds the index through
the program's normal entry points (``Database`` → ``Writer.add_items`` →
``builder().build()`` → ``commit_rw_txn`` → ``Reader.open``) in a store
under ``TMPDIR``, warms the cell's own shapes, runs the traffic for the
window, and then — the window closed, the peak read, the program's state
freed — judges the answers kept for judging against the plain reference
(``reference.py``). The harness itself only loads, traces and judges.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import numpy as np
import torch

from annbench import reference
from annbench.yardstick import layers as ylayers
from annbench.yardstick import recall as yrecall
from annbench.yardstick import trace as ytrace
from annbench.yardstick.peaks import power_limit_w

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def log(*parts) -> None:
    print("[annbench]", *parts, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# The cell's definitions, found by name
# --------------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    #: the benchmark's folder the cell's files were found in
    home: Path = HERE


def _listed(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: Path = ROOT, sizes: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files;
    ``sizes`` replaces numbers of the configuration (the CPU tests' tiny
    sizes)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have: {', '.join(cells)})")
    w = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((root / files[w["config"]]).read_text())
    config.update(sizes or {})
    home = root / HERE.name
    mix = json.loads((home / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((home / "limits" / f"{workload}.json").read_text())
    return Cell(
        workload, config, mix, limits,
        [m for m in bench["end_to_end"] if _listed(m, workload)],
        [m for m in bench["per_layer"] if _listed(m, workload)],
        home,
    )


def chips_of(workload: str, root: Path = ROOT) -> int:
    """The chips that cell ``workload`` asks for."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return next((w["chips"] for w in bench["workloads"] if w["name"] == workload), 1)


_MODULES: dict = {}


def module(home: Path, folder: str, name: str) -> ModuleType:
    """``<home>/<folder>/<name>.py``, loaded once."""
    path = home / folder / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise ValueError(f"{path.relative_to(home.parent)} is missing: the cell names {name!r}")
        spec = importlib.util.spec_from_file_location(f"annbench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def metric_reader(name: str, home: Path = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return module(home, "metrics", name).read


def driver_of(cell: Cell):
    """The ``Driver`` of ``drivers/<kind>.py`` for the cell's mix."""
    return module(cell.home, "drivers", cell.mix["kind"]).Driver(cell)


# --------------------------------------------------------------------------
# Data and index
# --------------------------------------------------------------------------


@dataclass
class Data:
    items: torch.Tensor  # [n_items + supply, d] f32 on the device
    queries: torch.Tensor  # [pool, d] f32 on the device
    items_host: np.ndarray
    #: the pool, with its first ``batch`` rows again at its end: every batch
    #: taken in order is a view
    pool_host: np.ndarray


def make_data(cell: Cell, seed: int, device) -> Data:
    cfg, mix = cell.config, cell.mix
    params = dict(cfg["data"])
    gen = module(cell.home, "generators", params.pop("generator"))
    n = cfg["n_items"] + mix.get("supply_items", 0)
    items, queries = gen.make(n, cfg["dimensions"], cfg["query_pool"], seed, device, **params)
    pool = queries.cpu().numpy()
    wrap = max(mix.get("batch", 1), mix.get("probe_queries", 1))
    return Data(items, queries, items.cpu().numpy(), np.concatenate([pool, pool[:wrap]]))


@dataclass
class Index:
    db: object
    writer: object
    reader: object


def open_database(cell: Cell, store: str, device, tier: str):
    from hannoy_tpu_torch import Database, Metric

    cfg = cell.config
    return Database(store, Metric(cfg["metric"]), device=device, tier=tier,
                    map_size=int(cfg["map_size_gib"] * 2**30))


def build_index(cell: Cell, data: Data, seed: int, store: str, device, tier: str) -> Index:
    from hannoy_tpu_torch import Reader

    cfg = cell.config
    db = open_database(cell, store, device, tier)
    writer = db.writer(cfg["dimensions"], m=cfg["m"], ef=cfg["ef_construction"], m0=cfg["m0"])
    n = cfg["n_items"]
    t = [time.perf_counter()]
    writer.add_items(np.arange(n, dtype=np.int64), data.items_host[:n])
    t.append(time.perf_counter())
    writer.builder(seed=seed).ef_construction(cfg["ef_construction"]).build(cfg["m"], cfg["m0"])
    t.append(time.perf_counter())
    db.commit_rw_txn()
    t.append(time.perf_counter())
    reader = Reader.open(db, 0)
    t.append(time.perf_counter())
    log("index: " + ", ".join(f"{name} {b - a:.3f} s" for name, a, b in
                              zip(("add_items", "build", "commit", "Reader.open"), t, t[1:])))
    return Index(db, writer, reader)


# --------------------------------------------------------------------------
# Windows
# --------------------------------------------------------------------------


@dataclass
class Window:
    """What a window did: host spans on ``perf_counter_ns``, the answers
    kept for judging, and what each must be judged by."""

    offset_ns: int  # time.time_ns() - perf_counter_ns(), for the profiler's clock
    #: the names of the host spans that are one call of the traffic
    call_names: tuple = ()
    spans: list = field(default_factory=list)  # (name, start_ns, end_ns)
    work: int = 0  # queries answered (search) or items appended (append)
    attempted: int = 0
    failed: int = 0
    results: list = field(default_factory=list)  # per kept call / update: list of Searched
    #: per kept call / update: (query sources, live items when answered); a
    #: query source >= 0 is a pool index, < 0 is -(item id) - 1 (an item's own vector)
    sources: list = field(default_factory=list)
    durations: list = field(default_factory=list)  # s, per call / update
    #: per call: the pool index of its first query (search traffic)
    call_starts: list = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0

    def span(self, name: str, t0: int, t1: int) -> None:
        self.spans.append((name, t0, t1))


@dataclass
class Outcome:
    """What an end-to-end metric's reader may read: the window, and the
    judged recall."""

    cell: Cell
    window: Window
    recall: float


def log_io() -> None:
    """The bytes this process has written to storage so far (``/proc/self/io``)."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        log(f"storage: {int(io['write_bytes']) / 1e9:.3f} GB written, {int(io['wchar']) / 1e9:.3f} GB passed to write()")
    except (OSError, KeyError, ValueError):
        pass


def built_files(root: Path = ROOT, skip: str = "") -> set:
    """Every file under the checkout but Python's byte code and ``skip``: a
    file that is new after set-up was built there (a kernel's ``nvcc``
    product, a cache)."""
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".git")
                       and os.path.join(dirpath, d) != skip]
        out.update(os.path.join(dirpath, f) for f in filenames)
    return out


# --------------------------------------------------------------------------
# The program's answers, and the judgement
# --------------------------------------------------------------------------


@dataclass
class Answers:
    ids: np.ndarray  # [R, k] int64, -1 where a row is short
    dists: np.ndarray  # [R, k] float64, NaN where a row is short
    source: np.ndarray  # [R] query source (``Window.sources``)
    live: np.ndarray  # [R] items live when the row was answered


def collect(w: Window, k: int) -> Answers:
    """The kept answers as arrays; a row longer than ``k`` keeps its first ``k``."""
    rows = [s.nns for res in w.results for s in res]
    r = len(rows)
    ids = np.full((r, k), -1, dtype=np.int64)
    dists = np.full((r, k), np.nan, dtype=np.float64)
    lens = np.fromiter((min(len(x), k) for x in rows), dtype=np.int64, count=r)
    if r and (lens == k).all():
        flat = [p for x in rows for p in x[:k]]
        ids[:] = np.fromiter((p[0] for p in flat), dtype=np.int64, count=r * k).reshape(r, k)
        dists[:] = np.fromiter((p[1] for p in flat), dtype=np.float64, count=r * k).reshape(r, k)
    else:
        for i, x in enumerate(rows):
            for j, (item, d) in enumerate(x[:k]):
                ids[i, j], dists[i, j] = item, d
    source = np.concatenate([s for s, _ in w.sources]) if w.sources else np.zeros(0, dtype=np.int64)
    live = np.concatenate([np.full(len(s), n, dtype=np.int64) for s, n in w.sources]) if w.sources else source
    return Answers(ids, dists, source.astype(np.int64), live)


def judge(cell: Cell, data: Data, ans: Answers) -> tuple[dict, float]:
    """The reference's verdict on the kept answers → (numbers compared, recall@k).

    * ``dist_gap``: the widest gap between a returned distance and the
      reference's distance of the returned item, by the configuration's metric;
    * ``bad_rows``: rows that are short, hold an id twice or an id that was
      not live, or whose distances are not ascending;
    * ``miss_share``: 1 - recall@k (tie-aware, by the reference's distances);
    * ``self_miss_share`` (where the traffic sends items' own vectors): the
      share of those queries whose first answer is not the item itself.
    """
    k = cell.config["nns"]
    dist = reference.distance(cell.config["metric"], cell.home)
    dev = data.items.device
    ids = torch.from_numpy(ans.ids).to(dev)
    dprog = torch.from_numpy(ans.dists).to(dev)
    src = torch.from_numpy(ans.source).to(dev)
    live = torch.from_numpy(ans.live).to(dev)
    r = ids.shape[0]
    # each row's query: a pool query, or an item's own vector (appended after the pool in one table)
    own = src < 0
    own_ids = (-src[own] - 1)
    table = torch.cat([data.queries, data.items[own_ids]]) if bool(own.any()) else data.queries
    qrow = src.clone()
    qrow[own] = data.queries.shape[0] + torch.arange(int(own.sum()), device=dev)

    present = ids >= 0
    live_id = present & (ids < live[:, None])
    srt = torch.sort(torch.where(present, ids, -1 - torch.arange(k, device=dev)[None, :]), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    ascending = ~((dprog[:, 1:] < dprog[:, :-1]) & present[:, 1:]).any(dim=1)
    bad = ~live_id.all(dim=1) | dup | ~ascending | (present & dprog.isnan()).any(dim=1)

    # the reference's distance of each returned live item; an id that is not
    # live has none (its row is bad, its place a miss)
    items64 = data.items.double()
    flat = live_id.nonzero()
    dref = torch.full((r, k), float("inf"), dtype=torch.float64, device=dev)
    dref[flat[:, 0], flat[:, 1]] = reference.distances_of(dist, table, items64, qrow[flat[:, 0]],
                                                          ids[flat[:, 0], flat[:, 1]])
    gap = (dref - dprog).abs()[live_id].nan_to_num(nan=float("inf"))
    dist_gap = float(gap.max()) if gap.numel() else float("inf")

    # the exact k-th distance of each row, over the items live when it was answered
    kth = torch.empty(r, dtype=torch.float64, device=dev)
    for n_live in torch.unique(live).tolist():
        rows = (live == n_live).nonzero()[:, 0]
        uq, inv = torch.unique(qrow[rows], return_inverse=True)
        kth[rows] = reference.exact_topk(dist, table[uq], items64[:n_live], k)[:, k - 1][inv]
    rec = yrecall.recall_per_row(dref, kth, k)
    recall = float(rec.mean()) if r else 0.0

    numbers = {"dist_gap": dist_gap, "bad_rows": int(bad.sum()), "miss_share": 1.0 - recall}
    if bool(own.any()):
        numbers["self_miss_share"] = float((ids[own, 0] != own_ids).double().mean())
    return numbers, recall


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------


@dataclass
class TraceContext:
    """What a per-layer metric's reader may read."""

    cell: Cell
    window: Window
    #: the benchmark's host spans on the profiler's clock
    host: list
    #: the device's operations (``yardstick.trace.Interval``)
    device: list
    lo: int
    hi: int
    #: the program's spans closed inside the window (``tracing.record``)
    program_spans: list
    #: the served graph's tables (the Reader's device graph), for the plain
    #: search; None where the Reader holds none under that name
    graph: object
    data: Data
    seed: int

    def calls(self) -> list:
        return [s for s in self.host if s.name in self.window.call_names]


@contextlib.contextmanager
def traced(enabled: bool):
    """The profiler (the device's activity only) and the program's span
    recorder around the window; yields a holder filled on exit."""
    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    from hannoy_tpu_torch.utils import tracing

    with tracing.record() as spans:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield out
    out["spans"] = list(spans)
    out["device"] = ytrace.device_intervals(prof)


def warm_profiler(device) -> None:
    """Start and stop the profiler once: its first start sets up the
    device's tracing, which must not fall in the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


def read_per_layer(cell: Cell, ctx: TraceContext) -> dict:
    """Each per-layer metric of the cell by its reader; one that finds
    nothing to read is left out, and says why on standard error."""
    out = {}
    for m in cell.per_layer:
        try:
            value = metric_reader(m["name"], cell.home)(ctx)
        except ylayers.NothingToRead as e:
            log(f"per-layer metric {m['name']} left out: {e}")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device="cuda",
    process_start_s: Optional[float] = None,
    sizes: Optional[dict] = None,
    tier: Optional[str] = None,
    plant: Optional[Callable] = None,
    root: Path = ROOT,
) -> dict:
    """Run cell ``workload`` once → the result's keys (see ``run.py``).

    ``process_start_s``: the process's start on ``time.time()``'s clock
    (``setup_s`` runs from it). ``sizes``, ``tier`` and ``plant`` serve the
    controls and the CPU tests: other numbers of the configuration, another
    storage tier, and a context manager entered around the window (a fault
    planted under the timed path). ``root``: the checkout whose
    ``BENCHMARK.json`` names the cell."""
    t_begin = time.time()
    cell = load_cell(workload, root=root, sizes=sizes)
    cfg = cell.config
    driver = driver_of(cell)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    store = tempfile.mkdtemp(prefix="annbench-")
    before = built_files(root, store)
    try:
        t0 = time.perf_counter()
        data = make_data(cell, seed, device)
        t1 = time.perf_counter()
        index = build_index(cell, data, seed, store, device, tier or cfg["tier"])
        t2 = time.perf_counter()
        driver.warm(index, data, seed)
        log(f"set-up: data {t1 - t0:.3f} s, index {t2 - t1:.3f} s, warm-up {time.perf_counter() - t2:.3f} s")
        if trace and on_cuda:
            warm_profiler(device)
        built = len(built_files(root, store) - before)
        if built:
            log(f"set-up built {built} files in the checkout: this run's setup_s holds the build")
        watts = power_limit_w() if on_cuda else None
        gc.collect()
        gc.freeze()  # the set-up's objects are not walked again in the window
        with traced(trace and on_cuda) as tr, (plant() if plant else contextlib.nullcontext()):
            w = driver.window(index, data, seconds, trace, seed)
        gc.unfreeze()
        first_call_s = (w.start_ns + w.offset_ns) / 1e9
        setup_s = first_call_s - (process_start_s if process_start_s is not None else t_begin)
        peak = torch.cuda.max_memory_allocated() if on_cuda else 0

        per_layer, dev_info, breakdown = {}, {}, None
        if trace:
            lo, hi = w.start_ns + w.offset_ns, w.end_ns + w.offset_ns
            host = [ytrace.Interval(n, a + w.offset_ns, b + w.offset_ns) for n, a, b in w.spans]
            device_iv = tr.get("device", [])
            ctx = TraceContext(cell, w, host, device_iv, lo, hi, tr.get("spans", []),
                               getattr(index.reader, "_dev", None), data, seed)
            per_layer = read_per_layer(cell, ctx)
            busy = ytrace.busy_ns(device_iv, lo, hi)
            dev_info = {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9}
            breakdown = {"device_ops": ytrace.top_ops(device_iv, lo, hi),
                         "idle_gaps": ytrace.idle_by_host(device_iv, host, lo, hi)}
            log(f"traced window {(hi - lo) / 1e9:.3f} s, device busy {busy / 1e9:.6f} s, "
                f"{len(device_iv)} device operations; power limit {watts} W")

        driver.report(w)
        t_collect = time.perf_counter()
        ans = collect(w, cfg["nns"])
        log(f"collecting {ans.ids.shape[0]} answers took {time.perf_counter() - t_collect:.3f} s")
        extra = driver.after_window(index, data, w, seed)
        del index, w.results
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers, recall = judge(cell, data, ans)
        numbers.update(extra)
        log(f"reference check of {ans.ids.shape[0]} answers took {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
        log_io()

    metrics = {}
    if not trace:
        out = Outcome(cell, w, recall)
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else module(cell.home, "end_to_end", m["name"]).read(out)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = per_layer
    checks = {}
    for name, value in numbers.items():
        checks[name] = {"value": value, "limit": cell.limits[name]["limit"]}
    correct = w.failed == 0 and w.attempted > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": int(w.attempted),
        "failed": int(w.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
            **dev_info,
            "power_limit_w": watts,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    #: files the set-up built in the checkout: a run that built any compiled
    #: its kernels, and its setup_s holds that
    result["setup_built_files"] = built
    result["checks"] = checks
    return result
