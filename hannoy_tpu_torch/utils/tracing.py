"""Lightweight tracing spans.

The reference instruments hot functions with ``tracing`` spans
(``#[instrument]`` on walk_layer / get_neighbours /
prepare_levels_and_entry_points, hnsw.rs:221,427,459) and debug events
through the build (writer.rs:653,701). Here a span is a context manager
that logs wall-time at debug level under the ``hannoy_tpu_torch`` logger;
enable with ``logging.getLogger("hannoy_tpu_torch").setLevel(logging.DEBUG)``
(the RUST_LOG analogue).
"""

from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger("hannoy_tpu_torch")


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a block and log ``name fields... took=...ms`` at debug level."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        if logger.isEnabledFor(logging.DEBUG):
            extras = " ".join(f"{k}={v}" for k, v in fields.items())
            logger.debug("%s %s took=%.2fms", name, extras, dt)
