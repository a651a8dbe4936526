"""The program's own spans beside the device's trace.

The program records spans in memory (``tracing.record()`` around the
window; ``TraceContext.program_spans``). Each has a ``name``, its
``fields`` (counters among them), its duration ``ms``, ``start_ns`` and
``end_ns`` on ``time.perf_counter_ns()``, an ``id`` given in the order the
spans opened, and the ``id`` of its ``parent``. The benchmark's call spans
are taken on the same clock and moved onto the profiler's
(``time.time_ns``) by the window's ``offset_ns``; ``on_profiler_clock``
moves program spans the same way.

* ``named``: the program spans of some names;
* ``ms_per_call`` / ``field_per_call``: a span's time or a field's sum,
  over the traffic's calls (a search call, or an update of the append);
* ``on_profiler_clock``: program spans as ``trace.Interval`` on the
  profiler's clock;
* ``idle_inside``: the device's idle time inside a set of intervals, and
  ``idle_ms_per_call`` inside the spans of some names, over the calls;
* ``idle_by_program_span``: the device's idle time in the window by the
  innermost program span open at the time.

The spans are read by their attributes: nothing here imports the program.
Where the program records no span of a name, no clock or no field, the
reading raises ``NothingToRead``.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Sequence

from . import trace as ytrace
from .layers import NothingToRead

#: the label of idle time inside the window that no program span covers
OUTSIDE = "outside program spans"


def named(ctx, *names: str) -> list:
    """The program spans whose name is one of ``names``, in closing order."""
    spans = [s for s in ctx.program_spans if s.name in names]
    if not spans:
        raise NothingToRead(f"no program span {' or '.join(names)} in the traced window")
    return spans


def _calls(ctx) -> int:
    n = len(ctx.calls())
    if not n:
        raise NothingToRead("no call of the traffic in the traced window")
    return n


def ms_per_call(ctx, *names: str) -> float:
    """The spans' ms summed over ``names``, over the traffic's calls."""
    return sum(s.ms for s in named(ctx, *names)) / _calls(ctx)


def field_per_call(ctx, name: str, field: str) -> float:
    """Field ``field`` of span ``name`` summed, over the traffic's calls."""
    values = [s.fields.get(field) for s in named(ctx, name)]
    if any(v is None for v in values):
        raise NothingToRead(f"program span {name} carries no field {field}")
    return sum(values) / _calls(ctx)


def on_profiler_clock(ctx, spans: Sequence) -> list[ytrace.Interval]:
    """``spans`` as intervals on the profiler's clock, in the order given."""
    if any(getattr(s, "start_ns", None) is None for s in spans):
        raise NothingToRead("the program's spans carry no clock")
    off = ctx.window.offset_ns
    return [ytrace.Interval(s.name, s.start_ns + off, s.end_ns + off) for s in spans]


def _busy_in(pieces: list, starts: list, a: int, b: int) -> int:
    """ns of the sorted disjoint ``pieces`` inside [a, b)."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    busy = 0
    while i < len(pieces) and pieces[i][0] < b:
        busy += max(0, min(pieces[i][1], b) - max(pieces[i][0], a))
        i += 1
    return busy


def idle_inside(ctx, intervals: Sequence[ytrace.Interval]) -> int:
    """ns of the window inside the union of ``intervals`` in which no
    operation ran on the device."""
    pieces = ytrace.merged(ctx.device, ctx.lo, ctx.hi)
    starts = [s for s, _ in pieces]
    return sum((b - a) - _busy_in(pieces, starts, a, b) for a, b in ytrace.merged(intervals, ctx.lo, ctx.hi))


def idle_ms_per_call(ctx, *names: str) -> float:
    """The device's idle time inside the spans of ``names``, over the
    traffic's calls (ms)."""
    return idle_inside(ctx, on_profiler_clock(ctx, named(ctx, *names))) / 1e6 / _calls(ctx)


def _innermost(spans: Sequence[tuple]) -> list[tuple[int, int, str]]:
    """``spans`` as (start, end, order, name), ``order`` the order they
    opened in → contiguous (start, end, label) pieces from the first start
    to the last end, each labelled with the innermost span open there (the
    open one that opened last), or ``OUTSIDE``."""
    events = sorted([(s[0], 1, k) for k, s in enumerate(spans)] + [(s[1], 0, k) for k, s in enumerate(spans)])
    out: list = []
    heap: list = []
    active: set = set()
    i = 0
    while i < len(events):
        t = events[i][0]
        while i < len(events) and events[i][0] == t:
            _, opens, k = events[i]
            if opens:
                active.add(k)
                heapq.heappush(heap, (-spans[k][2], k))
            else:
                active.discard(k)
            i += 1
        while heap and heap[0][1] not in active:
            heapq.heappop(heap)
        if i < len(events):
            out.append((t, events[i][0], spans[heap[0][1]][3] if heap else OUTSIDE))
    return out


def idle_by_program_span(ctx) -> list[list]:
    """[[label, seconds], ...]: the device's idle time inside the window by
    the innermost program span open at the time (``OUTSIDE`` where none
    is), largest first."""
    if ctx.hi <= ctx.lo or not ctx.program_spans:
        raise NothingToRead("no program span in the traced window")
    clocked = []
    for iv, s in zip(on_profiler_clock(ctx, ctx.program_spans), ctx.program_spans):
        a, b = max(iv.start, ctx.lo), min(iv.end, ctx.hi)
        if b > a:
            clocked.append((a, b, s.id, s.name))
    pieces = ytrace.merged(ctx.device, ctx.lo, ctx.hi)
    starts = [a for a, _ in pieces]
    by: dict[str, int] = {}
    for a, b, label in _innermost(clocked):
        if label != OUTSIDE:
            by[label] = by.get(label, 0) + (b - a) - _busy_in(pieces, starts, a, b)
    total_idle = (ctx.hi - ctx.lo) - sum(b - a for a, b in pieces)
    by[OUTSIDE] = total_idle - sum(by.values())
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1]) if v > 0]
