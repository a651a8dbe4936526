"""Build statistics counters.

Reference: the hannoy crate's ``src/stats.rs:10-38`` (``BuildStats`` — links
added, store hits, per-layer population histogram; debug-logged after each
build at writer.rs:575). On TPU the equivalents are host-side counters
incremented per wave plus device-reduced totals.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

logger = logging.getLogger("hannoy_tpu_torch")


@dataclass
class BuildStats:
    """Real, device-accumulated counters (one transfer per build):

    * ``links_added`` — net non-sentinel link-row entries written: forward
      links scattered for inserted items plus the net delta of every
      reverse-edge merge (the analogue of stats.rs inserted-links counts).
    * ``store_gathers`` — vector rows physically gathered from HBM by the
      candidate beams (the LMDB-hit analogue).
    * ``beam_iters`` — total layer-walk loop iterations across waves.
    * ``touched`` — slots whose link rows this build rewrote; the Writer
      flushes exactly these (reference flushes only its in-progress maps,
      hnsw.rs:192-213).
    """

    links_added: int = 0
    store_gathers: int = 0
    waves: int = 0
    layer_dist: dict[int, int] = field(default_factory=dict)
    beam_iters: int = 0
    touched: Optional[np.ndarray] = None

    def log(self) -> None:
        logger.debug(
            "BuildStats(links=%d gathers=%d waves=%d beam_iters=%d layers=%s)",
            self.links_added,
            self.store_gathers,
            self.waves,
            self.beam_iters,
            dict(sorted(self.layer_dist.items())),
        )
