"""The reader of ``build_graph_reused.append`` (field ``graph_reused`` of the
program's span ``build_prologue``): on synthetic spans, on a program that
records no such span or no such field, and on the spans a CPU run of the
append records."""

import tempfile

import pytest

from annbench import harness
from annbench.yardstick import trace as ytrace
from annbench.yardstick.layers import NothingToRead

from conftest import TINY
from test_annbench_program import _ctx, _OldSpan, _span

NAME = "build_graph_reused.append"


def _prologues(*reused):
    """One update a value: a prologue with the field, a build and a commit."""
    spans, calls = [], []
    for u, r in enumerate(reused):
        t, b = 100 + 500 * u, 10 * u
        spans += [
            _span("build_prologue", b, None, t, t + 100, graph_reused=r),
            _span("build_graph", b + 1, None, t + 100, t + 300, waves=3),
            _span("store_commit", b + 2, None, t + 310, t + 400),
        ]
        calls.append((1000 + t - 5, 1000 + t + 450))
    return _ctx("dbpedia-100k.append", "probe", calls, spans, [])


@pytest.mark.parametrize("reused, want", [((0, 1), 0.5), ((1, 1, 1), 1.0), ((0,), 0.0)])
def test_the_share_of_builds_that_reused_a_graph(reused, want):
    assert harness.metric_reader(NAME)(_prologues(*reused)) == pytest.approx(want)


def test_nothing_to_read_without_the_span():
    ctx = _prologues(1, 1)
    ctx.program_spans = [s for s in ctx.program_spans if s.name != "build_prologue"]
    with pytest.raises(NothingToRead):
        harness.metric_reader(NAME)(ctx)


def test_nothing_to_read_on_a_program_without_the_field():
    """A program older than the field: its prologue carries no ``graph_reused``."""
    ctx = _prologues(1, 1)
    ctx.program_spans = [_span(s.name, s.id, s.parent, s.start_ns, s.end_ns) for s in ctx.program_spans]
    with pytest.raises(NothingToRead):
        harness.metric_reader(NAME)(ctx)
    ctx.program_spans = [_OldSpan(s.name, {}, s.ms) for s in ctx.program_spans]
    with pytest.raises(NothingToRead):
        harness.metric_reader(NAME)(ctx)


def test_every_update_of_a_cpu_window_forks_the_last_commit():
    from hannoy_tpu_torch.utils import tracing

    cell = harness.load_cell("dbpedia-100k.append", sizes=TINY)
    data = harness.make_data(cell, 8, "cpu")
    with tempfile.TemporaryDirectory() as store:
        index = harness.build_index(cell, data, 8, store, "cpu", "raw")
        driver = harness.driver_of(cell)
        driver.warm(index, data, 8)
        with tracing.record() as spans:
            w = driver.window(index, data, 0.3, True, 8)
        index = None
    host = [ytrace.Interval(n, a + w.offset_ns, b + w.offset_ns) for n, a, b in w.spans]
    ctx = harness.TraceContext(cell, w, host, [], w.start_ns + w.offset_ns, w.end_ns + w.offset_ns, list(spans),
                               None, data, 8)
    assert harness.read_per_layer(cell, ctx)[NAME]["value"] == 1
