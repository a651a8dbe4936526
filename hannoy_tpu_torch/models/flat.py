"""Flat (exact) index — brute-force top-k on the device.

Counterpart of ``hannoy_tpu/models/flat.py``: one ``[B, N]`` distance
matrix plus top-k, the recall oracle for tests and the smoke run.
"""

from __future__ import annotations

import torch

from ..ops import distances, topk
from ..ops.topk import INF, NO_ID


def flat_topk(
    metric_name: str,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    db: torch.Tensor,  # [N, D]
    dbn: torch.Tensor,  # [N]
    mask: torch.Tensor,  # [N] or [B, N] bool — candidate/valid slots
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k among masked slots → (dists [B,k], int32 slots [B,k]).

    Masked-out slots return +inf / -1; ties go to the lower slot. A 2-D
    mask filters per query row."""
    metric = distances.by_name(metric_name)
    d = distances.matrix_distances(metric, q, qn, db, dbn)
    d = torch.where(mask if mask.dim() == 2 else mask[None, :], d, INF)
    dists, idx = topk.smallest_k(d, k)
    slots = torch.where(dists < INF, idx, NO_ID).to(torch.int32)
    return dists, slots
