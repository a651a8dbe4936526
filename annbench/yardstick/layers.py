"""The per-layer readings that the readers in ``annbench/metrics/`` share.

Each takes the ``harness.TraceContext`` of a traced run and returns a number,
or raises ``NothingToRead`` with the reason where its source holds nothing
(the harness then leaves the metric out of the result's line and prints
the reason on standard error).

* ``search_span_ms``: the program's span ``reader_search`` (the device search
  and its one transfer to the host), unfenced, mean per call;
* ``api_host_ms``: a call's wall time less that span, mean per call: the
  query preparation, the result assembly and the QueryBuilder;
* ``kernel_device_ms``: device time of every kernel that starts inside a
  call, whatever its name, mean per call;
* ``kernel_roofline``: the least time of the rows a plain search of the same
  queries reads (``plain_search``, each distinct row once, at the card's
  published bandwidth) over the device time of the call's kernels, on a
  sample of calls. The rows' widths are the configuration's, not the
  served tensors';
* ``device_idle``: the share of the window in which no operation ran on the
  device;
* ``stage_s``: a benchmark span of the append traffic, mean per update.
"""

from __future__ import annotations

import numpy as np
import torch

from . import peaks, plain_search
from . import trace as ytrace

#: calls of a traced window that the plain search repeats
ROOFLINE_SAMPLE = 8
#: bytes of a stored row's element by the configuration's storage tier
TIER_BYTES = {"raw": 4, "bf16": 2, "int8": 1}


class NothingToRead(Exception):
    """The metric's source holds nothing in this run."""


def _calls(ctx) -> list:
    calls = ctx.calls()
    if not calls:
        raise NothingToRead("no call of the traffic in the traced window")
    return calls


def search_span_ms(ctx) -> float:
    calls = _calls(ctx)
    spans = [s.ms for s in ctx.program_spans if s.name == "reader_search"]
    if len(spans) != len(calls):
        raise NothingToRead(f"{len(spans)} program spans reader_search for {len(calls)} calls")
    return float(np.sum(spans)) / len(calls)


def api_host_ms(ctx) -> float:
    span = search_span_ms(ctx)
    calls = _calls(ctx)
    return sum(c.end - c.start for c in calls) / 1e6 / len(calls) - span


def kernel_device_ms(ctx) -> float:
    calls = _calls(ctx)
    ns = ytrace.kernel_time_in(ctx.device, calls)
    if ns <= 0:
        raise NothingToRead("no kernel started inside a call: the profiler saw no device work")
    return ns / 1e6 / len(calls)


def kernel_roofline(ctx) -> float:
    """% (see the module docstring)."""
    calls = _calls(ctx)
    g = ctx.graph
    if g is None:
        raise NothingToRead("the Reader serves no device graph under the name the plain search reads")
    cfg = ctx.cell.config
    row = TIER_BYTES[cfg["tier"]]
    rng = np.random.default_rng(ctx.seed)
    picks = sorted(rng.choice(len(calls), size=min(ROOFLINE_SAMPLE, len(calls)), replace=False).tolist())
    batch = ctx.cell.mix["batch"]
    pool = cfg["query_pool"]
    least_s, kernel_ns = 0.0, 0
    for i in picks:
        ns = ytrace.kernel_time_in(ctx.device, [calls[i]])
        if ns <= 0:
            raise NothingToRead(f"no kernel started inside call {i}")
        start = ctx.window.call_starts[i]
        q = ctx.data.queries[(torch.arange(start, start + batch, device=ctx.data.queries.device) % pool)]
        rows = plain_search.rows_read(g, q, cfg["ef_search"])
        nbytes = rows.bytes(cfg["dimensions"], cfg["m0"], cfg["m"], batch, row)
        least_s += nbytes / peaks.HBM_BYTES_PER_S
        kernel_ns += ns
    return 100.0 * least_s / (kernel_ns / 1e9)


def device_idle(ctx) -> float:
    if ctx.hi <= ctx.lo or not ctx.device:
        raise NothingToRead("no device operation in the traced window")
    return 100.0 * (1.0 - ytrace.busy_ns(ctx.device, ctx.lo, ctx.hi) / (ctx.hi - ctx.lo))


def stage_s(ctx, name: str) -> float:
    times = [(b - a) / 1e9 for n, a, b in ctx.window.spans if n == name]
    if not times:
        raise NothingToRead(f"no span {name} in the window")
    return float(np.mean(times))
