"""The plain reference: exact distances and exact top-k, in float64.

The distance is the configuration's ``metric``, found by name in
``distances/<metric>.py`` (spaces in the name as ``_``): each such file
holds the hannoy crate's formula for one metric as ``pairwise`` ([Q, N]) and
``rowwise`` ([M], row against row), in plain torch. Everything is computed
in float64 from the vectors that the benchmark made and handed to the
program, with TF32 off, so no product runs in a lower precision than asked.
It imports nothing of the program, of the JAX package or of JAX, and takes
nothing the program made: it reads the program's answers only to judge them.

Everything runs in blocks, so that it fits beside what the run left on the
device: ``exact_topk`` in blocks of queries, ``distances_of`` in blocks of
(query, item) pairs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

import torch

HERE = Path(__file__).resolve().parent


def distance(metric: str, home: Path = HERE) -> ModuleType:
    """``distances/<metric>.py`` under ``home``: the metric's plain formula."""
    path = home / "distances" / f"{metric.replace(' ', '_')}.py"
    if not path.is_file():
        raise ValueError(f"no plain distance for the metric {metric!r}: add {path.relative_to(home.parent)}")
    spec = importlib.util.spec_from_file_location(f"annbench_distance_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_topk(dist: ModuleType, queries: torch.Tensor, items: torch.Tensor, k: int, block: int = 512) -> torch.Tensor:
    """The exact distances of the ``k`` nearest of each query among
    ``items`` [N, D] by ``dist``, in float64 → [Q, k] ascending."""
    _no_tf32()
    x = items.double()
    out = []
    for s in range(0, queries.shape[0], block):
        d = dist.pairwise(queries[s : s + block].double(), x)
        out.append(torch.topk(d, k, dim=1, largest=False, sorted=True).values)
        del d
    return torch.cat(out)


def distances_of(dist: ModuleType, queries: torch.Tensor, items: torch.Tensor, qidx: torch.Tensor,
                 ids: torch.Tensor, block: int = 1 << 16) -> torch.Tensor:
    """float64 distance by ``dist`` of query ``qidx[j]`` to item ``ids[j]``
    for every j (flat [M] index tensors, on the items' device) → [M]."""
    _no_tf32()
    out = torch.empty(qidx.shape[0], dtype=torch.float64, device=items.device)
    for s in range(0, qidx.shape[0], block):
        out[s : s + block] = dist.rowwise(queries[qidx[s : s + block]].double(), items[ids[s : s + block]].double())
    return out
