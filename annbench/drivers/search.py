"""search: a closed loop of searches by one caller.

``Reader.nns(k).ef_search(ef).by_vectors`` of the mix's ``batch`` queries,
taken in order from the pool (``by_vector`` where ``batch`` is 1), until the
window's length has passed; the call that runs across the end counts whole.

The answers that are judged after the window: every call of the first pass
through the pool (each pool query once), and of the later calls a share
``JUDGE_SHARE`` drawn from the seed. The others are dropped as they come,
as a user drops an answer once read, so that the window's host does not
hold millions of answers that no user would keep.
"""

from __future__ import annotations

import gc
import time
import traceback

import numpy as np

from annbench.harness import Window, log

#: the share of the calls after the first pass whose answers are judged
JUDGE_SHARE = 1 / 16


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.k, self.ef = cell.config["nns"], cell.config["ef_search"]
        self.batch = cell.mix["batch"]
        self.pool = cell.config["query_pool"]
        self.name = "by_vector" if self.batch == 1 else "by_vectors"

    def call(self, reader, data, start: int):
        if self.batch == 1:
            return [reader.nns(self.k).ef_search(self.ef).by_vector(data.pool_host[start])]
        return reader.nns(self.k).ef_search(self.ef).by_vectors(data.pool_host[start : start + self.batch])

    def warm(self, index, data, seed: int) -> None:
        for i in range(self.cell.mix["warmup_calls"]):
            self.call(index.reader, data, (i * self.batch) % self.pool)

    def window(self, index, data, seconds: float, trace: bool, seed: int) -> Window:
        w = Window(time.time_ns() - time.perf_counter_ns(), (self.name,))
        reader, b = index.reader, self.batch
        first_pass = -(-self.pool // b)
        # a draw per call, made before the window; more than any window holds
        draws = np.random.default_rng(seed).random(1 << 22) < JUDGE_SHARE
        start, i = 0, 0
        t_end = time.perf_counter_ns() + int(seconds * 1e9)
        w.start_ns = time.perf_counter_ns()
        while True:
            t0 = time.perf_counter_ns()
            if t0 >= t_end:
                break
            w.attempted += b
            try:
                res = self.call(reader, data, start)
            except Exception:
                traceback.print_exc()
                w.failed += b
                res = None
            t1 = time.perf_counter_ns()
            w.span(self.name, t0, t1)
            w.durations.append((t1 - t0) / 1e9)
            w.call_starts.append(start)
            if res is not None:
                w.work += b
                if i < first_pass or draws[i % len(draws)]:
                    w.results.append(res)
                    w.sources.append((np.arange(start, start + b) % self.pool, self.cell.config["n_items"]))
                    gc.freeze()  # kept until judged: not walked again by the collector
            res = None
            start = (start + b) % self.pool
            i += 1
        w.end_ns = w.spans[-1][2]
        return w

    def after_window(self, index, data, w: Window, seed: int) -> dict:
        return {}

    def report(self, w: Window) -> None:
        if w.durations:
            d = np.asarray(w.durations) * 1e3
            log(f"{len(d)} calls, {len(w.results)} kept for judging: ms min {d.min():.3f} median "
                f"{np.median(d):.3f} p95 {np.percentile(d, 95):.3f} max {d.max():.3f}")
