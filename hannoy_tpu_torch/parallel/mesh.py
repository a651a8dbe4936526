"""The device list of a sharded index (the port's mesh).

Counterpart of ``hannoy_tpu/parallel/mesh.py``. The JAX package lays its
shards over a ``jax.sharding.Mesh`` that ``make_mesh`` takes from
``jax.devices()``, and runs every shard's step as one SPMD program. Here
one process drives a list of ``torch.device``: shard ``s`` lives and runs
on ``devices[s]``, and the caller gives the list — nothing probes for a
card. A device may repeat: S shards on one card, or on ``"cpu"``.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: the name of the shard dimension (the JAX package's mesh axis)
SHARD_AXIS = "shard"


def make_mesh(devices: Sequence) -> list[torch.device]:
    """The mesh of a sharded index: shard ``s`` runs on ``devices[s]``."""
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_leading(mesh: Sequence[torch.device], x) -> list[torch.Tensor]:
    """Shard an array's leading dim across the mesh: ``x[s]`` on ``mesh[s]``."""
    if len(x) != len(mesh):
        raise ValueError(f"{len(x)} rows for {len(mesh)} shards")
    return [torch.as_tensor(x[s]).to(d) for s, d in enumerate(mesh)]


def replicated(mesh: Sequence[torch.device], x) -> list[torch.Tensor]:
    """``x`` on every shard's device, one copy per distinct device."""
    copies: dict[torch.device, torch.Tensor] = {}
    for d in mesh:
        if d not in copies:
            copies[d] = torch.as_tensor(x).to(d)
    return [copies[d] for d in mesh]
