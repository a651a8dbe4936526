"""Sorted-list / top-k primitives for beam search.

Counterpart of ``hannoy_tpu/ops/topk.py``: fixed-width *sorted arrays*
replace the reference's heaps, and push/pop becomes a whole-array
sort-merge. ``jax.lax.sort`` is stable and ``lax.top_k`` breaks ties
toward the lower index, so every sort here is ``torch.sort(stable=True)``
and top-k is a stable sort sliced (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

import torch

#: Sentinel id for empty slots (reference uses heap emptiness).
NO_ID = -1
#: Sentinel distance for empty slots — sorts after every real distance.
INF = float("inf")


def sort_by_dist(dists: torch.Tensor, *payloads: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Sort rows ascending by distance along the last axis (stable).

    ``dists`` is the key; every payload array is permuted identically.
    +inf (empty) slots end up last, so a "size-k sorted list" is simply
    the first k columns.
    """
    d, order = torch.sort(dists, dim=-1, stable=True)
    return (d, *(torch.gather(p, -1, order) for p in payloads))


def smallest_k(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row, ascending, ties toward the
    lower column → (values, int64 columns). Equal to
    ``lax.top_k(-dists, k)`` negated."""
    d, order = torch.sort(dists, dim=-1, stable=True)
    return d[..., :k], order[..., :k]


def merge_sorted(
    r_dists: torch.Tensor,  # [..., K1]
    r_payloads: tuple[torch.Tensor, ...],
    n_dists: torch.Tensor,  # [..., K2]
    n_payloads: tuple[torch.Tensor, ...],
    keep: int,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Merge a sorted result list with new candidates, keep best ``keep``
    (one concat + sort instead of ef sequential heap ops)."""
    d = torch.cat([r_dists, n_dists], dim=-1)
    ps = tuple(torch.cat([rp, np_], dim=-1) for rp, np_ in zip(r_payloads, n_payloads))
    out = sort_by_dist(d, *ps)
    return out[0][..., :keep], tuple(o[..., :keep] for o in out[1:])


def contains(ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
    """For each element of ``ids_a [..., K]``, is it present in
    ``ids_b [..., L]``? → bool [..., K]. ``NO_ID`` never matches.

    The beam-local dedup that replaces the reference's visited bitmap."""
    eq = ids_a[..., :, None] == ids_b[..., None, :]
    hit = (eq & (ids_b[..., None, :] != NO_ID)).any(-1)
    return hit & (ids_a != NO_ID)


def unique_mask(ids: torch.Tensor) -> torch.Tensor:
    """Mask keeping only the first occurrence of each id along the last
    axis (NO_ID slots are kept=False)."""
    k = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]
    earlier = torch.ones(k, k, dtype=torch.bool, device=ids.device).tril(-1)
    earlier_dup = (eq & earlier).any(-1)
    return ~earlier_dup & (ids != NO_ID)
