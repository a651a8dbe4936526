"""Lightweight tracing spans.

The reference instruments hot functions with ``tracing`` spans
(``#[instrument]`` on walk_layer / get_neighbours /
prepare_levels_and_entry_points, hnsw.rs:221,427,459) and debug events
through the build (writer.rs:653,701). Here ``span(name, **fields)`` is a
context manager that logs ``name fields... took=...ms`` at debug level under
the ``hannoy_tpu_torch`` logger; enable with
``logging.getLogger("hannoy_tpu_torch").setLevel(logging.DEBUG)`` (the
RUST_LOG analogue).

``record()`` also collects the spans closed inside its block, as
``SpanTime``: the name, the fields, the duration ``ms``, ``start_ns`` and
``end_ns`` on ``time.perf_counter_ns()``, the span's ``id`` and its
``parent`` (the id of the span of the same recorder that was open when it
opened, ``None`` at a root: the spans of one call share their root). A
reader moves them onto another clock by one offset, taken once as
``time.time_ns() - time.perf_counter_ns()`` (the profiler's clock).

``span`` returns a handle: ``set(**fields)`` adds fields known only at the
block's end (a counter), and ``recording`` says whether the span keeps or
logs its fields at all, so that a caller does work to fill a counter only
when it is set. With no recorder and debug logging off, ``span`` returns
one shared no-op handle: it reads no clock and keeps nothing.

PyTorch queues device work and returns, so a span's wall time says little
about the device unless both of its ends wait for the device: ``record(
fence=torch.cuda.synchronize)`` runs the fence at each span's start and
end. ``record(probe=...)`` reads a counter at both ends of each span and
keeps the difference (e.g. a kernel's launch count, to say which span
launched it).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import time
from typing import Callable, NamedTuple, Optional

logger = logging.getLogger("hannoy_tpu_torch")


class SpanTime(NamedTuple):
    name: str
    fields: dict
    ms: float
    #: the recorder's probe at the span's end less at its start
    probed: Optional[int] = None
    #: ``time.perf_counter_ns()`` at the span's start and end (after the fence)
    start_ns: int = 0
    end_ns: int = 0
    #: unique within its recorder, in the order the spans opened
    id: int = 0
    #: the id of the enclosing open span of the same recorder, or None
    parent: Optional[int] = None


class _Recorder:
    __slots__ = ("spans", "fence", "probe", "open", "next_id")

    def __init__(self, fence, probe):
        self.spans: list = []
        self.fence: Optional[Callable[[], None]] = fence
        self.probe: Optional[Callable[[], int]] = probe
        #: ids of the spans open now, innermost last
        self.open: list = []
        self.next_id = 0


_RECORDER: contextvars.ContextVar[Optional[_Recorder]] = contextvars.ContextVar(
    "hannoy_tpu_torch_spans", default=None
)


@contextlib.contextmanager
def record(fence: Optional[Callable[[], None]] = None, probe: Optional[Callable[[], int]] = None):
    """Collect every span closed inside the block → the list of
    ``SpanTime`` it yields, in closing order. ``fence`` runs at each
    span's start and end (nothing is fenced outside a ``record`` block);
    ``probe`` is read at both and its difference kept in ``probed``."""
    rec = _Recorder(fence, probe)
    token = _RECORDER.set(rec)
    try:
        yield rec.spans
    finally:
        _RECORDER.reset(token)


class _NoSpan:
    """The handle of a span that nothing records or logs."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **fields) -> None:
        pass


_OFF = _NoSpan()


class _Span:
    __slots__ = ("name", "fields", "rec", "id", "parent", "p0", "t0")
    recording = True

    def __init__(self, name: str, fields: dict, rec: Optional[_Recorder]):
        self.name = name
        self.fields = fields
        self.rec = rec

    def set(self, **fields) -> None:
        """Add fields (counters known only at the block's end)."""
        self.fields.update(fields)

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            if rec.fence is not None:
                rec.fence()
            self.id = rec.next_id
            rec.next_id += 1
            self.parent = rec.open[-1] if rec.open else None
            rec.open.append(self.id)
            self.p0 = rec.probe() if rec.probe is not None else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        if rec is not None and rec.fence is not None:
            rec.fence()
        t1 = time.perf_counter_ns()
        ms = (t1 - self.t0) / 1e6
        if rec is not None:
            rec.open.remove(self.id)
            probed = None if self.p0 is None else rec.probe() - self.p0
            rec.spans.append(SpanTime(self.name, self.fields, ms, probed, self.t0, t1, self.id, self.parent))
        if logger.isEnabledFor(logging.DEBUG):
            extras = " ".join(f"{k}={v}" for k, v in self.fields.items())
            logger.debug("%s %s took=%.2fms", self.name, extras, ms)


def span(name: str, **fields):
    """Time a block (module docstring) → its handle, ``set`` and
    ``recording``."""
    rec = _RECORDER.get()
    if rec is None and not logger.isEnabledFor(logging.DEBUG):
        return _OFF
    return _Span(name, fields, rec)
