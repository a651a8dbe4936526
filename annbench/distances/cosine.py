"""cosine: the hannoy crate's cosine distance, ``(1 - clip(cos, -1, 1)) / 2``,
0 where ``|p||q|`` is not above f32's epsilon (``cosine.rs``), in float64."""

import torch

_EPS = 1.1920929e-07  # f32 epsilon (cosine.rs's zero-norm guard)


def _from_dots(dots: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    cos = torch.where(den > _EPS, dots / den.clamp(min=_EPS), torch.zeros_like(dots)).clamp(-1.0, 1.0)
    return torch.where(den > _EPS, (1.0 - cos) / 2.0, torch.zeros_like(dots))


def pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float64 → [Q, N]."""
    return _from_dots(q @ x.T, q.norm(dim=1)[:, None] * x.norm(dim=1)[None, :])


def rowwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[M, D], [M, D] float64 → [M], row j against row j."""
    return _from_dots((q * x).sum(dim=1), q.norm(dim=1) * x.norm(dim=1))
