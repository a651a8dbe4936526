"""HNSW level sampling.

Replicates the reference's geometric level distribution: quantiles of
``Exp(1/ln M)`` — ``P(level=l) = M^-l * (1 - 1/M)``, truncated where the
probability drops below 1e-9 (``get_default_probas``, hnsw.rs:94-110), and
categorical sampling per item (``get_random_level``, hnsw.rs:113-119).
"""

from __future__ import annotations

import numpy as np


def assign_probas(m: int) -> np.ndarray:
    """Per-level probabilities (reference hnsw.rs:94-110)."""
    level_factor = 1.0 / np.log(np.float32(m) + np.finfo(np.float32).eps)
    probas = []
    level = 0
    while True:
        p = float(np.exp(level * (-1.0 / level_factor)) * (1.0 - np.exp(-1.0 / level_factor)))
        if p < 1e-9:
            break
        probas.append(p)
        level += 1
    return np.asarray(probas, dtype=np.float64)


def sample_levels(rng: np.random.Generator, m: int, n: int) -> np.ndarray:
    """Sample a level for each of n items → int array [n]."""
    p = assign_probas(m)
    p = p / p.sum()
    return rng.choice(len(p), size=n, p=p).astype(np.int32)
