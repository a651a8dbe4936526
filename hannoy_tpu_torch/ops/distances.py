"""Distance layer: the metrics of the hannoy crate, batched in PyTorch.

Counterpart of ``hannoy_tpu/ops/distances.py``. Every distance is
"smaller is closer" with the reference's formulas:

* ``cosine``    — ``(1 - cos)/2`` with cos clamped to [-1, 1]; 0.0 when
                  ``|p||q| <= eps``. Norm cached in the item header.
* ``euclidean`` — **squared** L2, no sqrt.
* ``manhattan`` — ``Σ|p-q|``.

The metric table, ``np_norms`` and ``np_pairwise`` are the JAX package's
numpy code, copied for the three f32 metrics. Everything here covers
those metrics in f32; the packed metrics (hamming, binary quantized) and
the bf16/int8 storage tiers are not ported yet and raise
``NotImplementedError``.

Precision: f32 matrix products must run in full f32, as the JAX package's
``Precision.HIGHEST`` does. On CUDA that needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default);
``chip_smoke.py`` sets and checks it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .codecs import BINARY, BQ, F32

_EPS = np.float32(1.1920929e-07)  # f32::EPSILON

#: the α-prune's candidate Gram (``prune.pairwise_block``) rounds its f32
#: inputs to bf16 for the dot metrics, as the JAX package does by default
#: (its ``HANNOY_TPU_BULK_BF16=1``)
BULK_BF16 = True


@dataclass(frozen=True)
class Metric:
    """A distance metric (reference trait ``Distance``)."""

    name: str  # DB-stable string identity (D::name())
    codec: str  # which vector codec backs it

    @property
    def is_packed(self) -> bool:
        return self.codec != F32


COSINE = Metric("cosine", F32)
EUCLIDEAN = Metric("euclidean", F32)
MANHATTAN = Metric("manhattan", F32)
HAMMING = Metric("hamming", BINARY)
BQ_COSINE = Metric("binary quantized cosine", BQ)
BQ_EUCLIDEAN = Metric("binary quantized euclidean", BQ)
BQ_MANHATTAN = Metric("binary quantized manhattan", BQ)

ALL_METRICS = [COSINE, EUCLIDEAN, MANHATTAN, HAMMING, BQ_COSINE, BQ_EUCLIDEAN, BQ_MANHATTAN]
BY_NAME = {m.name: m for m in ALL_METRICS}
#: the metrics the device functions of this package cover
F32_METRICS = ("cosine", "euclidean", "manhattan")


def by_name(name: str) -> Metric:
    return BY_NAME[name]


def check_supported(metric: Metric) -> str:
    """Name of ``metric`` if the port's device code covers it, else raise."""
    if metric.name not in F32_METRICS:
        raise NotImplementedError(
            f"metric {metric.name!r} is not ported yet (ROADMAP.md queue 1: "
            "packed metrics and storage tiers)"
        )
    return metric.name


# --------------------------------------------------------------------------
# Headers / norms (host)
# --------------------------------------------------------------------------


def np_norms(metric: Metric, packed: np.ndarray) -> np.ndarray:
    """Per-item header scalar for a batch of rows → [B] float32: the L2
    norm for cosine, 0.0 (the reference's unused ``bias``) otherwise."""
    packed = np.atleast_2d(packed)
    if check_supported(metric) == "cosine":
        return np.sqrt(np.einsum("bd,bd->b", packed, packed, dtype=np.float64)).astype(np.float32)
    return np.zeros(packed.shape[0], dtype=np.float32)


# --------------------------------------------------------------------------
# Numpy reference implementation (oracle for tests)
# --------------------------------------------------------------------------


def np_pairwise(
    metric: Metric,
    a: np.ndarray,
    a_norm: np.ndarray,
    b: np.ndarray,
    b_norm: np.ndarray,
) -> np.ndarray:
    """Exact [A, B] distance matrix between row batches (numpy)."""
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    name = check_supported(metric)
    if name == "cosine":
        dots = a.astype(np.float32) @ b.astype(np.float32).T
        denom = np.outer(a_norm, b_norm)
        cos = np.clip(np.divide(dots, denom, out=np.zeros_like(dots), where=denom > _EPS), -1, 1)
        out = np.where(denom > _EPS, (1.0 - cos) / 2.0, 0.0)
        return out.astype(np.float32)
    if name == "euclidean":
        diff = a[:, None, :].astype(np.float32) - b[None, :, :].astype(np.float32)
        return np.einsum("abd,abd->ab", diff, diff).astype(np.float32)
    return np.abs(a[:, None, :].astype(np.float32) - b[None, :, :]).sum(-1).astype(np.float32)


# --------------------------------------------------------------------------
# Device implementations (torch, f32 metrics)
# --------------------------------------------------------------------------


def cosine_from_dots(dots: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """The cosine epilogue: ``(1 - clip(dot / max(denom, eps), -1, 1)) / 2``,
    0 where ``denom <= eps`` (cosine.rs:40-56)."""
    cos = (dots / denom.clamp(min=float(_EPS))).clamp(-1.0, 1.0)
    return torch.where(denom > float(_EPS), (1.0 - cos) * 0.5, 0.0)


def gathered_distances(
    metric: Metric,
    q: torch.Tensor,  # [B, D]
    q_norm: torch.Tensor,  # [B]
    c: torch.Tensor,  # [B, K, D] gathered candidate rows
    c_norm: torch.Tensor,  # [B, K]
) -> torch.Tensor:
    """Distances between each query and its K gathered candidates → [B, K].

    The plain form of the per-hop gather → distance; ``beam_cuda`` holds
    the hand-written kernel that computes it without materialising ``c``.
    """
    name = check_supported(metric)
    if name == "cosine":
        dots = torch.einsum("bd,bkd->bk", q, c)
        return cosine_from_dots(dots, q_norm[:, None] * c_norm)
    diff = q[:, None, :] - c
    if name == "euclidean":
        return (diff * diff).sum(-1)
    return diff.abs().sum(-1)


def matrix_distances(
    metric: Metric,
    q: torch.Tensor,  # [B, D]
    q_norm: torch.Tensor,  # [B]
    db: torch.Tensor,  # [N, D]
    db_norm: torch.Tensor,  # [N]
) -> torch.Tensor:
    """Full [B, N] distance matrix — the brute-force / recall-oracle path.

    Euclidean uses the norm expansion ``|p|²+|q|²-2pq`` (clamped at 0), as
    the JAX package does, so it is one matrix product.
    """
    name = check_supported(metric)
    if name == "manhattan":
        return torch.cdist(q, db, p=1.0)
    dots = q @ db.T
    if name == "cosine":
        return cosine_from_dots(dots, q_norm[:, None] * db_norm[None, :])
    q2 = (q * q).sum(-1)
    n2 = (db * db).sum(-1)
    return (q2[:, None] + n2[None, :] - 2.0 * dots).clamp(min=0.0)
