"""Which builds the JAX package sends down its bulk (cluster-blocked) path.

Only the eligibility rule of ``hannoy_tpu/build/bulk.py`` is ported: the
port's ``build_graph`` raises ``NotImplementedError`` where this returns
True, since the bulk builder itself is not ported yet (ROADMAP.md
queue 1).
"""

from __future__ import annotations

#: metrics the JAX package's dense block path supports (f32 manhattan
#: stays on the wave path)
BULK_METRICS = (
    "cosine",
    "euclidean",
    "hamming",
    "binary quantized cosine",
    "binary quantized euclidean",
    "binary quantized manhattan",
)


def eligible(metric, n_active: int, n_deleted: int, n_insert: int, opts) -> bool:
    """Bulk path applies to large fresh builds of every metric except f32
    manhattan. Incremental builds and deletes keep the wave path."""
    if opts.bulk is False:
        return False
    if metric.name not in BULK_METRICS:
        return False
    if n_active or n_deleted:
        return False
    if opts.bulk is True:
        return n_insert > 1
    return n_insert >= opts.bulk_threshold
