"""The readers of the program's spans (``yardstick/program.py`` and the
metrics that use it): on a synthetic trace whose idle time is counted by
hand, on a program that records no such span, and on the spans a CPU run
of the program records."""

import tempfile
from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from annbench import harness
from annbench.yardstick import program
from annbench.yardstick import trace as ytrace
from annbench.yardstick.layers import NothingToRead

from conftest import TINY

OFFSET = 1000  # the window's offset from the program's clock to the profiler's
SEARCH_METRICS = ["api_prep_ms", "api_collect_ms", "search_host_gap_ms", "beam_hops"]
APPEND_METRICS = ["build_prologue_s.append", "build_upload_s.append", "build_graph_s.append", "build_waves.append",
                  "commit_log_s.append", "commit_publish_s.append"]
NEW_METRICS = [f"{m}.{t}" for m in SEARCH_METRICS for t in ("b256", "q1")] + APPEND_METRICS


def _span(name, sid, parent, a, b, **fields):
    """A recorded span as the program keeps it, on the program's clock."""
    return SimpleNamespace(name=name, fields=fields, ms=(b - a) / 1e6, start_ns=a, end_ns=b, id=sid, parent=parent)


def _one_call(base, t, hops):
    """The spans of one search call that starts at ``t`` (ids from ``base``)."""
    return [
        _span("reader_prep", base + 1, base, t + 5, t + 15),
        _span("search_descend", base + 3, base + 2, t + 16, t + 25),
        _span("search_beam", base + 4, base + 2, t + 25, t + 45),
        _span("search_to_host", base + 5, base + 2, t + 45, t + 63),
        _span("reader_search", base + 2, base, t + 15, t + 65, hops=hops),
        _span("reader_collect", base + 6, base, t + 67, t + 75),
        _span("reader_top_up", base + 7, base, t + 75, t + 80),
        _span("reader_query", base, None, t, t + 90),
    ]


def _ctx(cell_name, call_name, calls, spans, device):
    cell = harness.load_cell(cell_name)
    w = harness.Window(OFFSET, (call_name,))
    host = [ytrace.Interval(call_name, a, b) for a, b in calls]
    lo, hi = calls[0][0], calls[-1][1]
    return harness.TraceContext(cell, w, host, device, lo, hi, spans, None, None, 1)


def _search_ctx(cell_name="wiki-485k.search-b256", call_name="by_vectors"):
    """Two calls on the profiler's clock, [1100, 1200] and [1300, 1400]; the
    program's spans of each start 5 ns after the call; the device busy 3 + 25
    ns inside each call's reader_search."""
    spans = _one_call(0, 105, 4) + _one_call(8, 305, 6)
    device = [ytrace.Interval("greedy_descend_kernel", 1125, 1128), ytrace.Interval("beam_search_kernel", 1135, 1160),
              ytrace.Interval("greedy_descend_kernel", 1325, 1328), ytrace.Interval("beam_search_kernel", 1335, 1360)]
    return _ctx(cell_name, call_name, [(1100, 1200), (1300, 1400)], spans, device)


def _append_ctx():
    """Two updates: each a prologue, a build with its upload, a commit."""
    spans = []
    for u, t in enumerate((100, 600)):
        b = 10 * u
        spans += [
            _span("build_prologue", b, None, t, t + 100),
            _span("build_upload", b + 2, b + 1, t + 110, t + 150),
            _span("build_graph", b + 1, None, t + 100, t + 300, waves=3 + u),
            _span("store_commit", b + 3, None, t + 310, t + 400, batch_bytes=10, serialize_ns=5, log_ns=20 + u,
                  publish_ns=50),
        ]
    calls = [(OFFSET + 450, OFFSET + 460), (OFFSET + 950, OFFSET + 960)]
    return _ctx("dbpedia-100k.append", "probe", calls, spans, [])


def test_program_spans_move_onto_the_profiler_clock_inside_the_calls():
    ctx = _search_ctx()
    moved = program.on_profiler_clock(ctx, program.named(ctx, "reader_search"))
    assert [(iv.start, iv.end) for iv in moved] == [(1120, 1170), (1320, 1370)]
    calls = ctx.calls()
    assert all(any(c.start <= iv.start <= iv.end <= c.end for c in calls) for iv in moved)


def test_means_per_call_of_spans_and_fields():
    ctx = _search_ctx()
    assert program.ms_per_call(ctx, "reader_prep") == pytest.approx(10e-6)
    assert program.ms_per_call(ctx, "reader_collect", "reader_top_up") == pytest.approx(13e-6)
    assert program.field_per_call(ctx, "reader_search", "hops") == 5


def test_idle_inside_spans_is_counted_as_by_hand():
    ctx = _search_ctx()
    # reader_search lasts 50 ns a call, the device is busy 3 + 25 of them
    assert program.idle_inside(ctx, program.on_profiler_clock(ctx, program.named(ctx, "reader_search"))) == 44
    assert program.idle_ms_per_call(ctx, "reader_search") == pytest.approx(22e-6)
    # intervals overlapping each other and the window's ends count once
    ivs = [ytrace.Interval("x", 1000, 1130), ytrace.Interval("x", 1120, 1140), ytrace.Interval("x", 1390, 1500)]
    assert program.idle_inside(ctx, ivs) == (40 - 3 - 5) + 10


def test_idle_goes_to_the_innermost_open_span():
    ctx = _search_ctx()
    got = dict(program.idle_by_program_span(ctx))
    per_call = {"reader_query": 17, "reader_prep": 10, "reader_search": 3, "search_descend": 6, "search_beam": 5,
                "search_to_host": 8, "reader_collect": 8, "reader_top_up": 5}
    want = {k: 2 * v * 1e-9 for k, v in per_call.items()}
    want[program.OUTSIDE] = 120e-9  # before, between and after the calls' roots
    assert got == pytest.approx(want)
    busy = ytrace.busy_ns(ctx.device, ctx.lo, ctx.hi)
    assert sum(got.values()) == pytest.approx((ctx.hi - ctx.lo - busy) * 1e-9)


@pytest.mark.parametrize("tag,cell,call", [("b256", "wiki-485k.search-b256", "by_vectors"),
                                           ("q1", "wiki-485k.search-q1", "by_vector")])
def test_the_search_readers(tag, cell, call):
    ctx = _search_ctx(cell, call)
    read = {m: harness.metric_reader(f"{m}.{tag}")(ctx) for m in SEARCH_METRICS}
    assert read == pytest.approx({"api_prep_ms": 10e-6, "api_collect_ms": 13e-6, "search_host_gap_ms": 22e-6,
                                  "beam_hops": 5})


def test_the_append_readers():
    ctx = _append_ctx()
    read = {m: harness.metric_reader(m)(ctx) for m in APPEND_METRICS}
    assert read == pytest.approx({"build_prologue_s.append": 100e-9, "build_upload_s.append": 40e-9,
                                  "build_graph_s.append": 200e-9, "build_waves.append": 3.5,
                                  "commit_log_s.append": 20.5e-9, "commit_publish_s.append": 50e-9})


class _OldSpan(NamedTuple):
    """A span as a program without a clock, parents or counters keeps it."""

    name: str
    fields: dict
    ms: float
    probed: Optional[int] = None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_reader_finds_nothing_where_the_program_recorded_nothing(name):
    ctx = _append_ctx() if name.endswith(".append") else _search_ctx()
    ctx.program_spans = []
    with pytest.raises(NothingToRead):
        harness.metric_reader(name)(ctx)


@pytest.mark.parametrize("name", ["search_host_gap_ms.b256", "beam_hops.b256", "build_waves.append",
                                  "commit_log_s.append"])
def test_spans_without_a_clock_or_a_counter_read_nothing(name):
    ctx = _append_ctx() if name.endswith(".append") else _search_ctx()
    ctx.program_spans = [_OldSpan(s.name, {}, s.ms) for s in ctx.program_spans]
    with pytest.raises(NothingToRead):
        harness.metric_reader(name)(ctx)
    with pytest.raises(NothingToRead):
        program.idle_by_program_span(ctx)


@pytest.mark.parametrize("workload", ["wiki-485k.search-b256", "dbpedia-100k.append"])
def test_the_program_spans_of_a_cpu_run(workload):
    """The spans the program records in a short window: every reader_search
    lies inside one of the benchmark's call spans on the profiler's clock,
    and every new metric of the cell reads a number."""
    from hannoy_tpu_torch.utils import tracing

    cell = harness.load_cell(workload, sizes=TINY)
    data = harness.make_data(cell, 8, "cpu")
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, 8, store, "cpu", "raw")
        driver = harness.driver_of(cell)
        with tracing.record() as spans:
            w = driver.window(index, data, 0.3, True, 8)
        index = None
    host = [ytrace.Interval(n, a + w.offset_ns, b + w.offset_ns) for n, a, b in w.spans]
    ctx = harness.TraceContext(cell, w, host, [], w.start_ns + w.offset_ns, w.end_ns + w.offset_ns, list(spans),
                               None, data, 8)
    calls = ctx.calls()
    searches = program.on_profiler_clock(ctx, program.named(ctx, "reader_search"))
    assert len(searches) == len(calls) >= 1
    assert all(c.start <= s.start <= s.end <= c.end for s, c in zip(searches, calls))
    read = harness.read_per_layer(cell, ctx)
    assert {m["name"] for m in cell.per_layer} & set(NEW_METRICS) <= set(read)
    assert all(read[m]["value"] > 0 for m in read if m.startswith(("api_prep", "build_graph", "commit_log")))
