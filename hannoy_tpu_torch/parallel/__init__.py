"""Sharded build and serving over a list of devices (the JAX package's
``hannoy_tpu.parallel``, with ``make_mesh`` taking the device list)."""

from .mesh import SHARD_AXIS, make_mesh, replicated, shard_leading
from .sharded import (
    ShardedIndex,
    build_sharded,
    partition_round_robin,
    sharded_insert_wave,
)
from .sharded_api import ShardedReader, ShardedWriter, reshard, shard_of
from .spmd_build import spmd_store_build

__all__ = [
    "SHARD_AXIS",
    "make_mesh",
    "replicated",
    "shard_leading",
    "ShardedIndex",
    "build_sharded",
    "partition_round_robin",
    "sharded_insert_wave",
    "ShardedReader",
    "ShardedWriter",
    "reshard",
    "shard_of",
    "spmd_store_build",
]
