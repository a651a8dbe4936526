"""append: a closed loop of updates by one caller.

Each update adds the mix's ``update_items`` new items (ids continue where
the index ends, vectors from the same generator), then ``build()`` →
``commit_rw_txn`` → ``Reader.open`` → one probe ``by_vectors`` of
``probe_queries`` queries: ``probe_self`` of the items just added (each must
find itself) and the rest from the pool, in order. An update ends when its
probe has returned; the one that runs across the window's end counts whole.
Every probe is judged.

After the window it checks the store round trip (``store_mismatch``): the
items that each ``Reader.open`` served against what was committed, the
final id set, and the stored vectors of a sample of the appended items,
bit for bit.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from annbench.harness import Window, log

STAGES = ("add_items", "build", "commit", "reader_open", "probe")


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.k, self.ef = cell.config["nns"], cell.config["ef_search"]
        mix = cell.mix
        self.u, self.n_probe, self.n_self = mix["update_items"], mix["probe_queries"], mix["probe_self"]
        self.pool = cell.config["query_pool"]
        self.next_id = cell.config["n_items"]
        self.pool_at = 0
        #: Reader.n_items() after each update of the window
        self.n_items_read: list = []

    def update(self, index, data, seed: int, w, trace: bool):
        from hannoy_tpu_torch import Reader

        cfg = self.cell.config
        lo = self.next_id
        if lo + self.u > data.items_host.shape[0]:
            raise RuntimeError("the append mix ran out of supply items: raise supply_items")
        ids = np.arange(lo, lo + self.u, dtype=np.int64)
        own = np.linspace(lo, lo + self.u - 1, self.n_self).astype(np.int64)
        n_pool = self.n_probe - self.n_self
        pool_idx = (self.pool_at + np.arange(n_pool)) % self.pool
        probe = np.concatenate([data.items_host[own], data.pool_host[self.pool_at : self.pool_at + n_pool]])
        sync = _sync_of(index.db.device) if trace else (lambda: None)
        t = [time.perf_counter_ns()]
        index.writer.add_items(ids, data.items_host[lo : lo + self.u])
        t.append(time.perf_counter_ns())
        index.writer.builder(seed=seed).ef_construction(cfg["ef_construction"]).build(cfg["m"], cfg["m0"])
        sync()
        t.append(time.perf_counter_ns())
        index.db.commit_rw_txn()
        t.append(time.perf_counter_ns())
        index.reader = None  # the old Reader's device copy goes before the new one is made
        index.reader = Reader.open(index.db, 0)
        sync()
        t.append(time.perf_counter_ns())
        res = index.reader.nns(self.k).ef_search(self.ef).by_vectors(probe)
        t.append(time.perf_counter_ns())
        self.next_id = lo + self.u
        self.pool_at = (self.pool_at + n_pool) % self.pool
        if w is not None:
            for name, a, b in zip(STAGES, t, t[1:]):
                w.span(name, a, b)
            w.results.append(res)
            w.sources.append((np.concatenate([-own - 1, pool_idx]), self.next_id))
            self.n_items_read.append(index.reader.n_items())
            w.durations.append((t[-1] - t[0]) / 1e9)
        return t[-1]

    def warm(self, index, data, seed: int) -> None:
        for _ in range(self.cell.mix["warmup_updates"]):
            self.update(index, data, seed, None, False)

    def window(self, index, data, seconds: float, trace: bool, seed: int) -> Window:
        w = Window(time.time_ns() - time.perf_counter_ns(), ("probe",))
        t_end = time.perf_counter_ns() + int(seconds * 1e9)
        w.start_ns = time.perf_counter_ns()
        while time.perf_counter_ns() < t_end:
            w.attempted += 1
            try:
                w.end_ns = self.update(index, data, seed, w, trace)
            except Exception:
                traceback.print_exc()
                w.failed += 1
                index.db.abort_rw_txn()
                break
            w.work += self.u
        w.end_ns = w.end_ns or time.perf_counter_ns()
        return w

    def after_window(self, index, data, w: Window, seed: int) -> dict:
        """``store_mismatch``: what ``Reader.open`` served against what was
        committed, in mismatches."""
        bad = sum(int(got != n) for got, (_, n) in zip(self.n_items_read, w.sources))
        if w.sources:
            cfg = self.cell.config
            reader = index.reader
            live = w.sources[-1][1]
            ids = np.sort(reader.item_ids().to_array().astype(np.int64))
            bad += int(not np.array_equal(ids, np.arange(live)))
            sample = np.random.default_rng(seed).integers(cfg["n_items"], live, size=64)
            for item in sample.tolist():
                got = reader.item_vector(int(item))
                if got is None or not np.array_equal(np.asarray(got, dtype=np.float32), data.items_host[item]):
                    bad += 1
        return {"store_mismatch": bad}

    def report(self, w: Window) -> None:
        if w.durations:
            d = np.asarray(w.durations)
            log(f"{len(d)} updates: s min {d.min():.3f} median {np.median(d):.3f} max {d.max():.3f}")
        for name in STAGES:
            log(f"update stage {name}: s " + " ".join(f"{(b - a) / 1e9:.3f}" for n, a, b in w.spans if n == name))


def _sync_of(device):
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None
