"""Lightweight tracing spans.

The reference instruments hot functions with ``tracing`` spans
(``#[instrument]`` on walk_layer / get_neighbours /
prepare_levels_and_entry_points, hnsw.rs:221,427,459) and debug events
through the build (writer.rs:653,701). Here a span is a context manager
that logs wall-time at debug level under the ``hannoy_tpu_torch`` logger;
enable with ``logging.getLogger("hannoy_tpu_torch").setLevel(logging.DEBUG)``
(the RUST_LOG analogue).

``record()`` also collects the spans closed inside its block. PyTorch
queues device work and returns, so a span's wall time says little about
the device unless both of its ends wait for the device: ``record(fence=
torch.cuda.synchronize)`` runs the fence at each span's start and end.
``record(probe=...)`` reads a counter at both ends of each span and keeps
the difference (e.g. a kernel's launch count, to say which span launched
it).
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


class _Recorder(NamedTuple):
    spans: list
    fence: Optional[Callable[[], None]]
    probe: Optional[Callable[[], int]]


_RECORDER: contextvars.ContextVar[Optional[_Recorder]] = contextvars.ContextVar(
    "hannoy_tpu_torch_spans", default=None
)


@contextlib.contextmanager
def record(fence: Optional[Callable[[], None]] = None, probe: Optional[Callable[[], int]] = None):
    """Collect every span closed inside the block → the list of
    ``SpanTime`` it yields, in closing order. ``fence`` runs at each
    span's start and end (nothing is fenced outside a ``record`` block);
    ``probe`` is read at both and its difference kept in ``probed``."""
    rec = _Recorder([], fence, probe)
    token = _RECORDER.set(rec)
    try:
        yield rec.spans
    finally:
        _RECORDER.reset(token)


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a block and log ``name fields... took=...ms`` at debug level."""
    rec = _RECORDER.get()
    if rec is not None and rec.fence is not None:
        rec.fence()
    p0 = rec.probe() if rec is not None and rec.probe is not None else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if rec is not None and rec.fence is not None:
            rec.fence()
        dt = (time.perf_counter() - t0) * 1e3
        if rec is not None:
            rec.spans.append(SpanTime(name, fields, dt, None if p0 is None else rec.probe() - p0))
        if logger.isEnabledFor(logging.DEBUG):
            extras = " ".join(f"{k}={v}" for k, v in fields.items())
            logger.debug("%s %s took=%.2fms", name, extras, dt)
