"""hamming: the hannoy crate's hamming distance, ``popcount(a ^ b) / padded_bits``
(``hamming.rs``), over the sign bits ``x > 0.0`` of the binary codec
(``binary.rs``), in float64.

The bits are padded with zeros to whole 64-bit words (the codec's word
size), so ``padded_bits`` is the width rounded up to 64: 1,536 stays 1,536.
For {0, 1} rows ``popcount(a ^ b) = |a| + |b| - 2·a·b``. Each term is a
count of at most the row's width, so every value is an integer and exact.

``pairwise``'s ``a·b`` is a matrix product of {0, 1} values, taken on the
card in half precision over blocks of at most 2,048 columns (on the CPU in
float32). Every product is 0 or 1 and every partial sum an integer of at
most 2,048, which half precision holds exactly (11 bits of significand).
So the result equals the float64 product bit for bit, in a fraction of
its time: a float64 product of 10,000 queries and 999,000 rows of 1,536
takes about nine minutes of the card's.
"""

import torch

#: bits of the codec's word: widths are padded up to a multiple
WORD_BITS = 64
#: columns of a half-precision block whose counts are all exact
HALF_EXACT = 2048


def padded_bits(d: int) -> int:
    return -(-d // WORD_BITS) * WORD_BITS


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x > 0


def pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float64 → [Q, N]."""
    a, b = _bits(q), _bits(x)
    dots = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float64, device=q.device)
    half = torch.float16 if q.device.type == "cuda" else torch.float32
    for s in range(0, q.shape[1], HALF_EXACT):
        dots += (a[:, s : s + HALF_EXACT].to(half) @ b[:, s : s + HALF_EXACT].to(half).T).double()
    na = a.sum(dim=1, dtype=torch.float64)
    nb = b.sum(dim=1, dtype=torch.float64)
    return (na[:, None] + nb[None, :] - 2.0 * dots) / padded_bits(q.shape[1])


def rowwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[M, D], [M, D] float64 → [M], row j against row j."""
    a, b = _bits(q).double(), _bits(x).double()
    return (a.sum(dim=1) + b.sum(dim=1) - 2.0 * (a * b).sum(dim=1)) / padded_bits(q.shape[1])
