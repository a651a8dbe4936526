"""Reduction of a ``torch.profiler`` trace of the device to the benchmark's numbers.

The profiler records the device's activity only (kernels, copies, sets):
recording every host operator as well would cost the host more than the
search's own host work. Device intervals carry the profiler's clock, which
is the host's wall clock in nanoseconds (``time.time_ns``); the benchmark's
own host spans are taken on that clock too, so each idle gap of the device
can be put beside what the host was doing.

* ``busy_ns``: the union of the device's intervals inside the window;
* ``kernel_time_in``: the time of every kernel that starts inside a host
  span (a call), whatever its name;
* ``top_ops``: device time by operation name, largest first;
* ``idle_by_host``: the device's idle time inside the window, split by the
  benchmark's host span it falls in — ``<span>:head`` before the span's
  first device operation, ``<span>:tail`` after its last, ``<span>:mid``
  between them, ``<span>:idle`` in a span with no device operation, and
  ``harness`` outside every span.
"""

from __future__ import annotations

import bisect
import re
from typing import NamedTuple, Optional, Sequence


class Interval(NamedTuple):
    name: str
    start: int  # ns, the host's wall clock
    end: int


def device_intervals(prof) -> list[Interval]:
    """The device's operations in a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = [
        Interval(e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda
    ]
    out.sort(key=lambda iv: iv.start)
    return out


def merged(intervals: Sequence[Interval], lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the intervals, clipped to [lo, hi], as sorted disjoint pieces."""
    pieces: list[tuple[int, int]] = []
    for iv in sorted(intervals, key=lambda iv: iv.start):
        s, e = max(iv.start, lo), min(iv.end, hi)
        if e <= s:
            continue
        if pieces and s <= pieces[-1][1]:
            pieces[-1] = (pieces[-1][0], max(pieces[-1][1], e))
        else:
            pieces.append((s, e))
    return pieces


def busy_ns(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    return sum(e - s for s, e in merged(intervals, lo, hi))


_ARGS = re.compile(r"\(.*$")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, at most 80 characters."""
    base = name[5:] if name.startswith("void ") else name
    base = _ARGS.sub("", base.replace("(anonymous namespace)::", ""))
    depth, kept = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            kept.append(ch)
    return ("".join(kept).strip() or name)[:80]


def top_ops(intervals: Sequence[Interval], lo: int, hi: int, n: int = 10) -> list[list]:
    """[[name, seconds], ...]: device time by short name, largest first."""
    by: dict[str, int] = {}
    for iv in intervals:
        s, e = max(iv.start, lo), min(iv.end, hi)
        if e > s:
            key = short_name(iv.name)
            by[key] = by.get(key, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(
    intervals: Sequence[Interval], spans: Sequence[Interval], lo: int, hi: int, n: int = 10
) -> list[list]:
    """[[label, seconds], ...]: the device's idle time by host activity
    (module docstring), largest first."""
    pieces = merged(intervals, lo, hi)
    starts = [s for s, _ in pieces]

    def inside(a: int, b: int) -> list[tuple[int, int]]:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        out = []
        while i < len(pieces) and pieces[i][0] < b:
            s, e = max(pieces[i][0], a), min(pieces[i][1], b)
            if e > s:
                out.append((s, e))
            i += 1
        return out

    by: dict[str, int] = {}
    in_spans = 0
    for sp in spans:
        a, b = max(sp.start, lo), min(sp.end, hi)
        if b <= a:
            continue
        busy = inside(a, b)
        idle = (b - a) - sum(e - s for s, e in busy)
        in_spans += idle
        if not busy:
            by[f"{sp.name}:idle"] = by.get(f"{sp.name}:idle", 0) + idle
            continue
        head, tail = busy[0][0] - a, b - busy[-1][1]
        by[f"{sp.name}:head"] = by.get(f"{sp.name}:head", 0) + head
        by[f"{sp.name}:tail"] = by.get(f"{sp.name}:tail", 0) + tail
        by[f"{sp.name}:mid"] = by.get(f"{sp.name}:mid", 0) + idle - head - tail
    total_idle = (hi - lo) - sum(e - s for s, e in pieces)
    by["harness"] = max(0, total_idle - in_spans)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n] if v > 0]


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel: not a copy and not a set."""
    return not name.startswith(("Memcpy", "Memset"))


def kernel_time_in(intervals: Sequence[Interval], spans: Sequence[Interval]) -> int:
    """ns of every kernel that starts inside one of ``spans`` (sorted,
    disjoint), whatever its name."""
    starts = [sp.start for sp in spans]
    total = 0
    for iv in intervals:
        if not is_kernel(iv.name):
            continue
        i = bisect.bisect_right(starts, iv.start) - 1
        if i >= 0 and iv.start < spans[i].end:
            total += iv.end - iv.start
    return total
