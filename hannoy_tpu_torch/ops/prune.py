"""Batched α-SNG robust pruning and link-row merging.

Counterpart of ``hannoy_tpu/ops/prune.py``: the candidate-candidate
distance matrix ``[B, K, K]`` is computed in one batched product, and the
greedy selection is a loop over candidate rank whose state is a selection
mask — each step consults one column of the precomputed matrix.

Semantics: candidates sorted ascending by distance-to-query; candidate
``c`` is selected iff for every already-selected ``s``:
``d(c,s) * α >= d(c,q)`` (strict ``<`` rejects), until ``cap`` are
selected.
"""

from __future__ import annotations

import torch

from . import distances, topk
from .topk import INF, NO_ID


def pairwise_block(
    metric: distances.Metric,
    vecs: torch.Tensor,  # [B, K, D*]
    norms: torch.Tensor,  # [B, K]
) -> torch.Tensor:
    """All-pairs distances within each row's candidate set → [B, K, K].

    For cosine and euclidean f32 rows are rounded to bf16 first
    (``distances.BULK_BF16``, as in the JAX package) and multiplied in
    f32, so each product is exact, as bf16×bf16→f32 is on the TPU, and
    only the summation order differs. int8 rows are cast (cosine) or
    dequantised by the scales in ``norms`` (the others); bf16 rows are
    taken as they are; packed rows take their popcounts from the Gram
    of their unpacked bits (exact, ``distances.unpack_bits``: the JAX
    package's fused XOR-popcount over ``[B, K, K, W]`` would run here as
    a dozen elementwise passes over that block), ``PACKED_CHUNK_ELEMS``
    unpacked elements at a time."""
    name = metric.name
    if metric.is_packed:
        B, K, W = vecs.shape
        rows_pc = distances._row_popcounts(vecs)
        step = max(1, distances.PACKED_CHUNK_ELEMS // max(1, K * W * 32))
        pc = torch.empty((B, K, K), dtype=torch.float32, device=vecs.device)
        for b0 in range(0, B, step):
            bits = distances.unpack_bits(vecs[b0 : b0 + step])
            dots = torch.bmm(bits, bits.transpose(1, 2))
            r = rows_pc[b0 : b0 + step]
            pc[b0 : b0 + step] = r[:, :, None] + r[:, None, :] - 2.0 * dots
        return distances._packed_from_popcount(name, pc, W * 32, norms[:, :, None] * norms[:, None, :])
    if vecs.dtype == torch.int8 and name != "cosine":
        vecs = distances._deq(vecs, norms)
    vecs = vecs.to(torch.float32)
    if name == "manhattan":
        return torch.cdist(vecs, vecs, p=1.0)
    if distances.BULK_BF16:
        vecs = distances.bf16_round(vecs)
    dots = torch.bmm(vecs, vecs.transpose(1, 2))
    if name == "cosine":
        return distances.cosine_from_dots(dots, norms[:, :, None] * norms[:, None, :])
    sq = (vecs * vecs).sum(-1)
    return (sq[:, :, None] + sq[:, None, :] - 2.0 * dots).clamp(min=0.0)


def robust_prune(
    metric: distances.Metric,
    vectors: torch.Tensor,  # [N_pad, D] store
    norms: torch.Tensor,  # [N_pad]
    cand_ids: torch.Tensor,  # [B, K] slots sorted ascending by cand_d, -1 padded
    cand_d: torch.Tensor,  # [B, K]
    cap: int,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """α-prune each row's candidate list → (sel_ids [B, cap], sel_d [B, cap]).

    Output stays ascending by distance; unused slots are (-1, +inf).
    """
    B, K = cand_ids.shape
    valid = (cand_ids != NO_ID) & torch.isfinite(cand_d) & topk.unique_mask(cand_ids)
    safe = cand_ids.clamp(min=0).long()
    pair = pairwise_block(metric, vectors[safe], norms[safe])  # [B, K, K]

    sel_mask = torch.zeros((B, K), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros((B,), dtype=torch.int32, device=cand_ids.device)
    for t in range(K):
        conflict = (sel_mask & (pair[:, t, :] * alpha < cand_d[:, t, None])).any(-1)
        ok = valid[:, t] & ~conflict & (count < cap)
        sel_mask[:, t] = ok
        count += ok.to(torch.int32)

    d = torch.where(sel_mask, cand_d, INF)
    ids = torch.where(sel_mask, cand_ids, NO_ID)
    d, ids = topk.sort_by_dist(d, ids)
    return ids[:, :cap], d[:, :cap]


def merge_link_rows(
    metric: distances.Metric,
    vectors: torch.Tensor,
    norms: torch.Tensor,
    row_ids: torch.Tensor,  # [U, cap] existing neighbor slots
    row_d: torch.Tensor,  # [U, cap]
    inc_ids: torch.Tensor,  # [U, K] incoming neighbor slots
    inc_d: torch.Tensor,  # [U, K]
    cap: int,
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge incoming (reverse) edges into existing link rows: append while
    there is room, α-prune existing ∪ incoming on overflow (the JAX
    package's documented deviation from the reference's drop)."""
    ids = torch.cat([row_ids, inc_ids], dim=-1)
    d = torch.cat([row_d, inc_d], dim=-1)
    keep = topk.unique_mask(ids) & torch.isfinite(d)
    d = torch.where(keep, d, INF)
    ids = torch.where(keep, ids, NO_ID)
    d, ids = topk.sort_by_dist(d, ids)
    n_total = (ids != NO_ID).sum(-1)

    pruned_ids, pruned_d = robust_prune(metric, vectors, norms, ids, d, cap, alpha)
    fits = (n_total <= cap)[:, None]
    return torch.where(fits, ids[:, :cap], pruned_ids), torch.where(fits, d[:, :cap], pruned_d)
