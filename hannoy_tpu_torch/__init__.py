"""hannoy-tpu's PyTorch port: HNSW build and search on an NVIDIA GPU.

Counterpart of ``hannoy_tpu`` (the JAX reference package), written in
PyTorch with a hand-written CUDA kernel for the per-hop gather → distance
over every row type (f32, the bf16 and int8 storage tiers, the bit-packed
rows of hamming and the binary quantized metrics).
It imports neither JAX nor ``hannoy_tpu``; the host modules it needs
(the store, the id sets, the schema) are its own copies, and the on-disk
format is shared: either package opens a directory the other wrote.

The front door is the JAX package's: ``Database(path, Metric.COSINE,
device="cuda")`` → ``db.writer(dimensions)`` → ``add_items`` →
``builder().build()`` → ``commit_rw_txn()`` → ``db.reader().by_vecs(...)``.
Under it runs the engine: stage items in a ``HostGraph`` →
``build_graph`` (insertion waves, or for fresh builds of >= 8192 items the
bulk cluster-blocked path, as in the JAX package) →
``to_device`` → ``hnsw_search``, with ``flat_topk`` as the exact oracle.
The device is always explicit — a keyword of ``Database``, an argument of
the engine's functions; nothing picks one by itself. So is the storage
tier (``Database(tier=)``, ``build_graph(tier=)``, ``to_device(tier=)``),
which the JAX package reads from the environment. What of the API is
not ported yet is listed in ROADMAP.md.
"""

from __future__ import annotations

from . import errors
from .api import Database, Metric, Reader, Writer
from .build.builder import BuildOptions, build_graph
from .models.flat import flat_topk
from .models.hnsw import DeviceGraph, HostGraph, from_device, slot_capacity, to_device
from .ops.beam import BeamResult, default_ef_upper, hnsw_search, hnsw_search_filtered
from .ops.distances import (
    BQ_COSINE,
    BQ_EUCLIDEAN,
    BQ_MANHATTAN,
    COSINE,
    EUCLIDEAN,
    HAMMING,
    MANHATTAN,
    by_name,
)
from .version import CURRENT_VERSION, Version

__version__ = "0.1.0"

__all__ = [
    "errors",
    "Database",
    "Writer",
    "Reader",
    "Metric",
    "Version",
    "CURRENT_VERSION",
    "BuildOptions",
    "build_graph",
    "flat_topk",
    "DeviceGraph",
    "HostGraph",
    "from_device",
    "slot_capacity",
    "to_device",
    "BeamResult",
    "default_ef_upper",
    "hnsw_search",
    "hnsw_search_filtered",
    "COSINE",
    "EUCLIDEAN",
    "MANHATTAN",
    "HAMMING",
    "BQ_COSINE",
    "BQ_EUCLIDEAN",
    "BQ_MANHATTAN",
    "by_name",
]
