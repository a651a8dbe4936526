"""synthetic_hard: embedding-corpus-like vectors made on the device from the
seed (``yardstick/data.py``): Zipf topics, a power-law spectrum, queries
partly around topics that no item belongs to. The configuration's ``data``
group gives its parameters."""

from annbench.yardstick import data


def make(n: int, d: int, n_queries: int, seed: int, device, **params):
    """→ (items [n, d], queries [n_queries, d]), float32 on ``device``."""
    v = data.synthetic_hard(n, d, n_queries, seed, device, **params)
    return v.items, v.queries
