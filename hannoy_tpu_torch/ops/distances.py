"""Distance layer: the seven metrics of the hannoy crate, batched in PyTorch.

Counterpart of ``hannoy_tpu/ops/distances.py``. Every distance is
"smaller is closer" with the reference's formulas:

* ``cosine``       — ``(1 - cos)/2`` with cos clamped to [-1, 1]; 0.0 when
                     ``|p||q| <= eps``. Norm cached in the item header.
* ``euclidean``    — **squared** L2, no sqrt.
* ``manhattan``    — ``Σ|p-q|``.
* ``hamming``      — ``popcount(p^q) / padded_bits``.
* ``bq cosine``    — cosine over ±1 vectors: ``dot = D_pad - 2·popcount(p^q)``.
* ``bq euclidean`` — ``4 · popcount(p^q)``.
* ``bq manhattan`` — ``2 · popcount(p^q)``.

The metric table, ``np_norms`` and ``np_pairwise`` are the JAX package's
numpy code, copied.

Row types on the device. f32 rows are ``float32``. The storage tiers of
the f32 metrics hold ``bfloat16`` rows, or ``int8`` rows with a scalar in
the norm header (cosine: 127, the length of the stored row, so the scale
cancels in cos; euclidean / manhattan: the row's own scale
``max|v_i| / 127``, applied after each gather by ``_deq``); the encoders
are in ``models.hnsw.to_device``. Packed rows (hamming and the binary
quantized metrics) are the codec's uint32 lanes held as **``int32``
tensors of the same bits**: PyTorch has no shifts and no population count
for ``uint32``, while ``^``, ``&`` and ``>>`` on ``int32`` give the same
bits (an arithmetic shift is always masked here). ``popcount`` is SWAR
arithmetic on those lanes; ``as_lanes`` views a host ``uint32`` array as
``int32`` for upload.

Precision: f32 matrix products must run in full f32, as the JAX package's
``Precision.HIGHEST`` does. On CUDA that needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default);
``chip_smoke.py`` sets and checks it. Products on bf16 rows take f32
operands that hold bf16 values (``bf16_round``): each product is then
exact and the sum is f32, as the TPU's bf16×bf16→f32 is, where a bf16
matmul on CUDA would round its output to bf16. Unpacked bits are f32
zeros and ones for the same reason, so popcounts taken as products are
exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import codecs
from .codecs import BINARY, BQ, F32

_EPS = np.float32(1.1920929e-07)  # f32::EPSILON

#: the α-prune's candidate Gram (``prune.pairwise_block``), the bulk
#: builder's cluster blocks (``block_distances``) and its k-means round
#: their f32 inputs to bf16 for the dot metrics, as the JAX package does
#: by default (its ``HANNOY_TPU_BULK_BF16=1``)
BULK_BF16 = True

#: elements of the largest temporary one step of a chunked packed op may
#: hold: the [B, N, W] XOR block of ``matrix_distances`` (it walks the
#: queries), the unpacked [B, K, 32·W] block of ``prune.pairwise_block``
PACKED_CHUNK_ELEMS = 1 << 26


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


def by_name(name: str) -> Metric:
    return BY_NAME[name]


# --------------------------------------------------------------------------
# Headers / norms (host)
# --------------------------------------------------------------------------


def np_norms(metric: Metric, packed: np.ndarray) -> np.ndarray:
    """Per-item header scalar for a batch of packed rows → [B] float32.

    cosine → L2 norm; bq cosine → sqrt(bq_dot(v,v)) == sqrt(D_pad);
    hamming → popcount (unused by search); others → 0.0 (the reference's
    unused ``bias``).
    """
    packed = np.atleast_2d(packed)
    if metric.name == "cosine":
        return np.sqrt(np.einsum("bd,bd->b", packed, packed, dtype=np.float64)).astype(np.float32)
    if metric.name == "binary quantized cosine":
        d_pad = packed.shape[1] * codecs.LANE_BITS
        return np.full(packed.shape[0], np.sqrt(np.float32(d_pad)), dtype=np.float32)
    if metric.name == "hamming":
        return _np_popcount_rows(packed).astype(np.float32)
    return np.zeros(packed.shape[0], dtype=np.float32)


def _np_popcount_rows(x: np.ndarray) -> np.ndarray:
    by = np.atleast_2d(x).astype("<u4").view(np.uint8)
    return np.unpackbits(by, axis=1).sum(axis=1)


def as_lanes(packed: np.ndarray) -> np.ndarray:
    """Host uint32 lanes → the int32 view of the same bits that the device
    holds (see the module docstring)."""
    return np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)


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
    """Exact [A, B] distance matrix between packed row batches (numpy)."""
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    name = metric.name
    if name == "cosine":
        dots = a.astype(np.float32) @ b.astype(np.float32).T
        denom = np.outer(a_norm, b_norm)
        cos = np.clip(np.divide(dots, denom, out=np.zeros_like(dots), where=denom > _EPS), -1, 1)
        out = np.where(denom > _EPS, (1.0 - cos) / 2.0, 0.0)
        return out.astype(np.float32)
    if name == "euclidean":
        diff = a[:, None, :].astype(np.float32) - b[None, :, :].astype(np.float32)
        return np.einsum("abd,abd->ab", diff, diff).astype(np.float32)
    if name == "manhattan":
        return np.abs(a[:, None, :].astype(np.float32) - b[None, :, :]).sum(-1).astype(np.float32)
    # packed metrics
    xor = a[:, None, :] ^ b[None, :, :]
    pc = np.unpackbits(xor.astype("<u4").view(np.uint8).reshape(a.shape[0], b.shape[0], -1), axis=2).sum(
        axis=2
    )
    d_pad = a.shape[1] * codecs.LANE_BITS
    if name == "hamming":
        return (pc / np.float32(d_pad)).astype(np.float32)
    if name == "binary quantized euclidean":
        return (4.0 * pc).astype(np.float32)
    if name == "binary quantized manhattan":
        return (2.0 * pc).astype(np.float32)
    if name == "binary quantized cosine":
        dot = d_pad - 2.0 * pc
        denom = np.outer(a_norm, b_norm)
        cos = np.divide(dot, denom, out=np.zeros_like(dot, dtype=np.float64), where=denom != 0)
        return np.where(denom != 0, (1.0 - cos) / 2.0, 0.0).astype(np.float32)
    raise ValueError(f"unknown metric {name}")


# --------------------------------------------------------------------------
# Device implementations (torch)
# --------------------------------------------------------------------------


def device_dtype(metric: Metric) -> torch.dtype:
    """Row type of a raw-tier device store: int32 lanes for the packed
    codecs (the bits of the codec's uint32 lanes), float32 otherwise."""
    return torch.int32 if metric.is_packed else torch.float32


def cosine_from_dots(dots: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """The cosine epilogue: ``(1 - clip(dot / max(denom, eps), -1, 1)) / 2``,
    0 where ``denom <= eps`` (cosine.rs:40-56)."""
    cos = (dots / denom.clamp(min=float(_EPS))).clamp(-1.0, 1.0)
    return torch.where(denom > float(_EPS), (1.0 - cos) * 0.5, 0.0)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held in f32: a product of two such tensors
    is exact, as the TPU's bf16×bf16→f32 is, and only its summation order
    differs (a bf16 product on CUDA would round its output to bf16)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _deq(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 capacity-tier rows → f32 through the per-row scale in the norm
    header (the euclidean / manhattan int8 tier, ``models.hnsw.to_device``).
    Other row types pass through: f32 queries carry scale 0 and never
    arrive here as int8."""
    if rows.dtype == torch.int8:
        return rows.to(torch.float32) * scale[..., None]
    return rows


def _tier_operands(name: str, q, q_norm, c, c_norm):
    """Queries and rows of any tier as f32 values, and whether the rows
    were bf16 → (q, c, bf16). int8 rows are cast (cosine: the 127 cancels
    through the norm header) or dequantised by their scale (the others,
    int8 queries by theirs)."""
    if c.dtype == torch.int8:
        if name != "cosine":
            q, c = _deq(q, q_norm), _deq(c, c_norm)
    bf16 = c.dtype == torch.bfloat16
    return q.to(torch.float32), c.to(torch.float32), bf16


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 lane → int32 (SWAR; every shifted value is
    masked, so the arithmetic shift's sign bits never count, and the sums
    are taken modulo 2**32 as for unsigned lanes)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0x3F


def _row_popcounts(x: torch.Tensor) -> torch.Tensor:
    """Total set bits per packed row → float32 [...]."""
    return popcount(x).sum(-1, dtype=torch.int32).to(torch.float32)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """Unpack int32 lanes → {0, 1} float32 bits, LSB-first per lane
    (``[..., W] → [..., W*32]``), the JAX package's bit order.

    The bridge from the packed codecs to matrix products: for two bit
    rows, ``popcount(p ^ q) == pc(p) + pc(q) - 2·dot(bits_p, bits_q)``, and
    the dot of {0, 1} vectors accumulated in f32 is exact. (The JAX
    package unpacks to bf16 for the TPU's matrix unit; f32 here, see the
    module docstring.)"""
    shifts = torch.arange(codecs.LANE_BITS, dtype=x.dtype, device=x.device)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * codecs.LANE_BITS).to(torch.float32)


def _packed_from_popcount(name: str, pc: torch.Tensor, d_pad: int, norm_prod: torch.Tensor) -> torch.Tensor:
    pc = pc.to(torch.float32)
    if name == "hamming":
        # a tensor divisor: by a Python number PyTorch multiplies by the
        # reciprocal on CUDA, one ulp off the true quotient
        return pc / torch.full((), float(d_pad), device=pc.device)
    if name == "binary quantized euclidean":
        return 4.0 * pc
    if name == "binary quantized manhattan":
        return 2.0 * pc
    if name == "binary quantized cosine":
        dot = float(d_pad) - 2.0 * pc
        cos = dot / torch.where(norm_prod != 0, norm_prod, 1.0)
        return torch.where(norm_prod != 0, (1.0 - cos) * 0.5, 0.0)
    raise ValueError(f"unknown packed metric {name}")


def gathered_distances(
    metric: Metric,
    q: torch.Tensor,  # [B, D*] queries (int32 lanes for packed codecs)
    q_norm: torch.Tensor,  # [B]
    c: torch.Tensor,  # [B, K, D*] gathered candidate rows
    c_norm: torch.Tensor,  # [B, K]
) -> torch.Tensor:
    """Distances between each query and its K gathered candidates → [B, K].

    The plain form of the per-hop gather → distance; ``beam_cuda`` holds
    the hand-written kernel that computes it without materialising ``c``.

    bf16 rows: cosine rounds the query to bf16 and accumulates in f32, the
    subtractive metrics upcast the rows and keep the query as it is. int8
    rows: see ``_tier_operands``. A query gathered from the store (a
    build) has the rows' type; a search's is f32 (or packed lanes).
    """
    name = metric.name
    if metric.is_packed:
        pc = popcount(q[:, None, :] ^ c).sum(-1, dtype=torch.int32)
        d_pad = q.shape[-1] * codecs.LANE_BITS
        return _packed_from_popcount(name, pc, d_pad, q_norm[:, None] * c_norm)
    q, c, bf16 = _tier_operands(name, q, q_norm, c, c_norm)
    if name == "cosine":
        dots = torch.einsum("bd,bkd->bk", bf16_round(q) if bf16 else q, c)
        return cosine_from_dots(dots, q_norm[:, None] * c_norm)
    diff = q[:, None, :] - c
    if name == "euclidean":
        return (diff * diff).sum(-1)
    return diff.abs().sum(-1)


def matrix_distances(
    metric: Metric,
    q: torch.Tensor,  # [B, D*]
    q_norm: torch.Tensor,  # [B]
    db: torch.Tensor,  # [N, D*]
    db_norm: torch.Tensor,  # [N]
) -> torch.Tensor:
    """Full [B, N] distance matrix — the brute-force / recall-oracle path.

    Euclidean uses the norm expansion ``|p|²+|q|²-2pq`` (clamped at 0), as
    the JAX package does, so it is one matrix product (on bf16 rows the
    product takes the bf16-rounded query, the norms the query as it is).
    The packed codecs stream an XOR-popcount over ``PACKED_CHUNK_ELEMS``
    elements at a time.
    """
    name = metric.name
    if metric.is_packed:
        B, (N, W) = q.shape[0], db.shape
        step = max(1, PACKED_CHUNK_ELEMS // max(1, N * W))
        pc = torch.empty((B, N), dtype=torch.int32, device=q.device)
        for b0 in range(0, B, step):
            pc[b0 : b0 + step] = popcount(q[b0 : b0 + step, None, :] ^ db[None, :, :]).sum(-1, dtype=torch.int32)
        return _packed_from_popcount(name, pc, W * codecs.LANE_BITS, q_norm[:, None] * db_norm[None, :])
    q, db, bf16 = _tier_operands(name, q, q_norm, db, db_norm)
    if name == "manhattan":
        return torch.cdist(q, db, p=1.0)
    dots = (bf16_round(q) if bf16 else q) @ db.T
    if name == "cosine":
        return cosine_from_dots(dots, q_norm[:, None] * db_norm[None, :])
    q2 = (q * q).sum(-1)
    n2 = (db * db).sum(-1)
    return (q2[:, None] + n2[None, :] - 2.0 * dots).clamp(min=0.0)


def packed_matrix_mxu(
    metric: Metric,
    q: torch.Tensor,  # [B, W] packed lanes
    q_norm: torch.Tensor,  # [B]
    db: torch.Tensor,  # [N, W]
    db_norm: torch.Tensor,  # [N]
) -> torch.Tensor:
    """[B, N] packed-metric distances through one matrix product (exact):
    ``popcount(p^q) = pc(p) + pc(q) - 2·dot(bits)`` over unpacked {0, 1}
    rows — see :func:`unpack_bits`. Used where both operands are bounded
    (the build's flat member tables and brute-force candidates); the
    streaming XOR-popcount of :func:`matrix_distances` stays for an
    arbitrarily large ``db`` (unpacked rows take 32× the packed bytes)."""
    dots = unpack_bits(q) @ unpack_bits(db).T
    pc = _row_popcounts(q)[:, None] + _row_popcounts(db)[None, :] - 2.0 * dots
    d_pad = q.shape[-1] * codecs.LANE_BITS
    return _packed_from_popcount(metric.name, pc, d_pad, q_norm[:, None] * db_norm[None, :])


def block_distances(
    metric: Metric,
    q: torch.Tensor,  # [G, S, D*] row blocks
    q_norm: torch.Tensor,  # [G, S]
    c: torch.Tensor,  # [G, T, D*] column blocks
    c_norm: torch.Tensor,  # [G, T]
) -> torch.Tensor:
    """Batched block distance matrices → [G, S, T]: the bulk builder's
    cluster-block candidate op, one batched matrix product.

    The packed codecs unpack both blocks to {0, 1} and take the popcount
    from the product (exact). With ``BULK_BF16`` f32 operands are rounded
    to bf16 first (tier rows are taken as they are: bf16 values, int8
    codes or dequantised int8 rows), and the euclidean norms are taken
    from the rounded rows, as in the JAX package. f32 manhattan would
    materialise [G, S, T, D] and stays on the wave path (``ValueError``,
    as there)."""
    name = metric.name
    if metric.is_packed:
        dots = torch.bmm(unpack_bits(q), unpack_bits(c).transpose(1, 2))
        pc = _row_popcounts(q)[:, :, None] + _row_popcounts(c)[:, None, :] - 2.0 * dots
        d_pad = q.shape[-1] * codecs.LANE_BITS
        return _packed_from_popcount(name, pc, d_pad, q_norm[:, :, None] * c_norm[:, None, :])
    if name == "manhattan":
        raise ValueError(f"block_distances supports dot metrics only, got {name}")
    q, c, _ = _tier_operands(name, q, q_norm, c, c_norm)
    if BULK_BF16:
        q, c = bf16_round(q), bf16_round(c)
    dots = torch.bmm(q, c.transpose(1, 2))
    if name == "cosine":
        return cosine_from_dots(dots, q_norm[:, :, None] * c_norm[:, None, :])
    q2 = (q * q).sum(-1)
    c2 = (c * c).sum(-1)
    return (q2[:, :, None] + c2[:, None, :] - 2.0 * dots).clamp(min=0.0)
