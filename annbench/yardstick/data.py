"""Embedding-corpus-like vectors, made on the device from the run's seed.

A torch copy of the "synthetic-hard" generator that the JAX package's
benchmark folder carries (``benchmarks/datasets.py::synthetic_hard``),
rewritten to run on the card from one ``torch.Generator``:

* hierarchical topics: ``roots`` root clusters, each split into
  ``subs_per_root`` subclusters, root sizes Zipf-distributed (exponent 1.1);
* an anisotropic covariance with a power-law spectrum
  (λ_i ∝ (i+1)^-decay), rotated by a random orthonormal basis;
* queries drawn from the same process but not from the items, a share
  ``ood_share`` of them around topics that no item belongs to; the pool is
  shuffled, so that every batch taken from it in order mixes both kinds.

The same seed on the same card gives the same vectors, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: rows made per matrix product, to bound the temporaries
CHUNK = 1 << 16


class Vectors(NamedTuple):
    items: torch.Tensor  # [n, d] float32 on the device
    queries: torch.Tensor  # [n_queries, d] float32 on the device


def synthetic_hard(
    n: int,
    d: int,
    n_queries: int,
    seed: int,
    device,
    spectrum_decay: float = 0.6,
    roots: int = 48,
    subs_per_root: int = 8,
    ood_share: float = 0.1,
) -> Vectors:
    """``n`` items and ``n_queries`` queries of ``d`` float32 each (see the
    module docstring). TF32 is turned off for the products: the vectors do
    not depend on a matmul setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def normal(*shape) -> torch.Tensor:
        return torch.randn(*shape, generator=g, device=device, dtype=torch.float32)

    spectrum = torch.arange(1, d + 1, device=device, dtype=torch.float64) ** (-spectrum_decay)
    basis, _ = torch.linalg.qr(normal(d, d).double())
    w_t = (basis * spectrum[None, :]).T.contiguous().float()  # z @ w_t: z's directions scaled, rotated

    sizes = 1.0 / torch.arange(1, roots + 1, device=device, dtype=torch.float64) ** 1.1
    sizes = sizes / sizes.sum()
    root_centers = (normal(roots, d) @ w_t) * 6.0
    sub_centers = (root_centers[:, None, :] + 2.0 * (normal(roots, subs_per_root, d) @ w_t)).reshape(-1, d)

    def around(centers: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
        out = torch.empty((len(assign), d), device=device, dtype=torch.float32)
        for s in range(0, len(assign), CHUNK):
            a = assign[s : s + CHUNK]
            out[s : s + len(a)] = centers[a] + normal(len(a), d) @ w_t
        return out

    def topic_of(count: int) -> torch.Tensor:
        root = torch.multinomial(sizes, count, replacement=True, generator=g)
        return root * subs_per_root + torch.randint(0, subs_per_root, (count,), generator=g, device=device)

    items = around(sub_centers, topic_of(n))
    n_in = int(n_queries * (1.0 - ood_share))
    q_in = around(sub_centers, topic_of(n_in))
    ood_centers = (normal(n_queries - n_in, d) @ w_t) * 6.0
    q_ood = around(ood_centers, torch.arange(n_queries - n_in, device=device))
    queries = torch.cat([q_in, q_ood])[torch.randperm(n_queries, generator=g, device=device)]
    return Vectors(items, queries.contiguous())
