"""Tie-aware recall@k, the arithmetic of the JAX package's ``bench.py``.

A returned item is a hit when its distance is within ``TIE_EPS`` of the
exact k-th distance or closer: items tied with the k-th one count, whichever
of them the search returned. Here both distances come from the plain
reference (the returned item's distance recomputed, and the exact k-th), so
the rule does not rest on the program's own numbers. A missing entry (a
short row) is a miss.
"""

from __future__ import annotations

import torch

#: ``bench.py``'s allowance on the exact k-th distance
TIE_EPS = 1e-6


def hits(ref_dists: torch.Tensor, kth: torch.Tensor) -> torch.Tensor:
    """[R, k] recomputed distances of the returned items (NaN or +inf where
    a row is short), [R] exact k-th distances → [R, k] bool."""
    return ref_dists <= (kth[:, None] + TIE_EPS)


def recall_per_row(ref_dists: torch.Tensor, kth: torch.Tensor, k: int) -> torch.Tensor:
    """→ [R] float64, the share of the k places that hold a hit."""
    return hits(ref_dists, kth).sum(dim=1, dtype=torch.float64) / k
