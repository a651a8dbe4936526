"""hannoy-tpu's PyTorch port: HNSW build and search on an NVIDIA GPU.

Counterpart of ``hannoy_tpu`` (the JAX reference package), written in
PyTorch with a hand-written CUDA kernel for the per-hop gather → distance.
It imports neither JAX nor ``hannoy_tpu``; the host modules it needs are
its own copies.

The ported slice is the engine under the JAX package's main path: stage
items in a ``HostGraph`` → ``build_graph`` (insertion waves) →
``to_device`` → ``hnsw_search``, with ``flat_topk`` as the exact oracle.
The device is always explicit; nothing picks one by itself. The
``Database``/``Writer``/``Reader`` API is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from . import errors
from .build.builder import BuildOptions, build_graph
from .models.flat import flat_topk
from .models.hnsw import DeviceGraph, HostGraph, from_device, slot_capacity, to_device
from .ops.beam import BeamResult, default_ef_upper, hnsw_search
from .ops.distances import COSINE, EUCLIDEAN, MANHATTAN, Metric, by_name

__version__ = "0.1.0"

__all__ = [
    "errors",
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
    "COSINE",
    "EUCLIDEAN",
    "MANHATTAN",
    "Metric",
    "by_name",
]
