"""Store-backed sharded indexes: durable deployments over several devices.

Counterpart of ``hannoy_tpu/parallel/sharded_api.py``. Shard ``s`` of a
sharded index persists as store index ``base_index + s`` — ordinary
per-index records (items, links, metadata, journal), so every
single-index capability (incremental builds, deletes, validity checks)
applies per shard, and a sharded deployment opens shard by shard with a
plain :class:`hannoy_tpu_torch.Reader` as well.

Where the JAX package takes a ``jax.sharding.Mesh`` (by default every
device JAX sees), these take ``devices``: a list of ``torch.device``, one
per shard, which may repeat (S shards on one card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..api import Database, Reader
from ..models.hnsw import HostGraph
from ..ops import codecs
from ..store.schema import Key, Metadata, NodeMode, Prefix, UpdateStatus, encode_update_status, keys_bytes
from .mesh import make_mesh
from .sharded import ShardedIndex, pad_to_common_shapes


def shard_of(item_id: int, n_shards: int) -> int:
    """Deterministic item → shard routing (round-robin by id)."""
    return int(item_id) % n_shards


class ShardedWriter:
    """Routes item CRUD to per-shard Writers and builds every shard.

    ``build()`` drives all shards' journal-pending changes (inserts and
    deletes) through lockstep device waves (``spmd_build.spmd_store_build``)
    when ``devices`` was given, shard ``s`` on ``devices[s]``; without
    ``devices`` it builds the shards one after the other on the Database's
    device, each through the whole single-device builder (the bulk path
    included: the mode for one card holding many shards). Either way
    durability flows through each shard's ordinary store epilogue.
    """

    def __init__(
        self,
        database: Database,
        dimensions: int,
        n_shards: int,
        base_index: int = 0,
        m: int = 16,
        ef: int = 96,
        m0: Optional[int] = None,
        devices: Optional[Sequence] = None,
    ):
        self.n_shards = n_shards
        self.base_index = base_index
        self._writers = [
            database.writer(dimensions, index=base_index + s, m=m, ef=ef, m0=m0) for s in range(n_shards)
        ]
        self._database = database
        self._devices = make_mesh(devices) if devices is not None else None
        if self._devices is not None and len(self._devices) != n_shards:
            raise ValueError(f"{n_shards} shards need {n_shards} devices, got {len(self._devices)}")

    def add_item(self, item: int, vector) -> None:
        self._writers[shard_of(item, self.n_shards)].add_item(item, vector)

    def add_items(self, items: Sequence[int], vectors: np.ndarray) -> None:
        items = np.asarray(list(items), dtype=np.uint32)
        vectors = np.asarray(vectors, dtype=np.float32)
        for s in range(self.n_shards):
            mask = (items % self.n_shards) == s
            if mask.any():
                self._writers[s].add_items(items[mask], vectors[mask])

    def del_item(self, item: int) -> bool:
        return self._writers[shard_of(item, self.n_shards)].del_item(item)

    def build(self, spmd: Optional[bool] = None, opts=None, **kw) -> None:
        """Build every shard's pending changes.

        ``spmd=None`` takes the lockstep path when the writer was given
        ``devices``, the sequential one otherwise. ``opts`` is the shared
        ``BuildOptions`` of the lockstep path; ``**kw`` (m / m0) goes to the
        per-shard builders of the sequential path. A shard's device graph
        lives only inside its build, so the sequential path holds about one
        shard in device memory at a time."""
        if not any(w.need_build() for w in self._writers):
            return
        if spmd is None:
            spmd = self._devices is not None
        if spmd:
            if self._devices is None:
                raise ValueError("the lockstep build runs shard s on devices[s]: give the ShardedWriter devices=")
            from .spmd_build import spmd_store_build

            spmd_store_build(self._writers, opts=opts, devices=self._devices)
        else:
            for w in self._writers:
                if w.need_build():
                    w.builder().build(**kw)

    def __enter__(self) -> "ShardedWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.build()
            self._database.commit_rw_txn()
        else:
            self._database.abort_rw_txn()


def reshard(
    database: Database,
    old_n_shards: int,
    new_n_shards: int,
    *,
    base_index: int = 0,
    new_base_index: Optional[int] = None,
    dimensions: Optional[int] = None,
    m: int = 16,
    ef: int = 96,
    m0: Optional[int] = None,
    build: bool = True,
    opts=None,
    spmd: Optional[bool] = None,
    devices: Optional[Sequence] = None,
) -> ShardedWriter:
    """Migrate a sharded deployment to another shard count.

    Every item moves to the shard its id now routes to
    (``item % new_n_shards``): item records move **verbatim** between store
    indexes (no decode / re-pack), journal stones mark every moved item,
    and the per-shard graphs are rebuilt fresh. Everything happens under
    the shared write transaction: an abort rolls back to the old layout.

    ``new_base_index=None`` reshards in place at ``base_index`` (the old
    indexes are cleared before the new layout is written). A distinct
    ``new_base_index`` writes the new layout beside the old one, which is
    then cleared; the ranges must not overlap.

    Returns a :class:`ShardedWriter` over the new layout (``devices``, if
    given, one per new shard), already built when ``build=True``; commit
    with ``database.commit_rw_txn()``.
    """
    if old_n_shards < 1 or new_n_shards < 1:
        raise ValueError("shard counts must be >= 1")
    in_place = new_base_index is None or new_base_index == base_index
    new_base = base_index if in_place else new_base_index
    if not in_place:
        old_rng = range(base_index, base_index + old_n_shards)
        new_rng = range(new_base, new_base + new_n_shards)
        if max(old_rng.start, new_rng.start) < min(old_rng.stop, new_rng.stop):
            raise ValueError(f"old index range {old_rng} overlaps new range {new_rng}")
    wtxn = database._wtxn()
    db = database._db
    metric = database.metric.distance

    # dimensions from the first shard that has been built, else required
    if dimensions is None:
        for s in range(old_n_shards):
            md = db.get(wtxn, Key.metadata(base_index + s).to_bytes())
            if md is not None:
                dimensions = Metadata.from_bytes(md).dimensions
                break
        if dimensions is None:
            raise ValueError("no shard has metadata yet - pass dimensions= explicitly")

    vec_bytes = codecs.pack(np.zeros((1, dimensions), np.float32), metric.codec).nbytes
    rec = 7 + vec_bytes  # tag ∥ u16 hdr-len ∥ f32 norm ∥ packed row

    # ---- read every item record of the old layout (vectorized) ----
    all_ids: list[np.ndarray] = []
    all_rows: list[np.ndarray] = []
    for s in range(old_n_shards):
        keys_u64, rows = db.scan_fixed(wtxn, Prefix.item(base_index + s), rec)
        all_ids.append(((keys_u64 >> np.uint64(8)) & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        all_rows.append(rows)
    ids = np.concatenate(all_ids)
    rows = np.concatenate(all_rows, axis=0)

    # ---- drop the old layout (links, metadata, journal, items) ----
    for s in range(old_n_shards):
        database.writer(dimensions, index=base_index + s).clear()

    # ---- write the new layout: verbatim item records + journal stones ----
    stone = encode_update_status(UpdateStatus.UPDATED)
    stone_row = np.frombuffer(stone, dtype=np.uint8)
    dest = ids % np.uint32(new_n_shards)
    for t in range(new_n_shards):
        sel = np.nonzero(dest == t)[0]
        if not len(sel):
            continue
        t_idx = new_base + t
        t_ids = ids[sel]
        offs = (np.arange(len(sel) + 1, dtype=np.uint64) * rec).astype(np.uint64)
        db.put_many_raw(
            wtxn, keys_bytes(t_idx, NodeMode.ITEM, t_ids).tobytes(), np.ascontiguousarray(rows[sel]).tobytes(), offs
        )
        soffs = (np.arange(len(sel) + 1, dtype=np.uint64) * len(stone)).astype(np.uint64)
        db.put_many_raw(
            wtxn,
            keys_bytes(t_idx, NodeMode.UPDATED, t_ids).tobytes(),
            np.broadcast_to(stone_row, (len(sel), len(stone))).tobytes(),
            soffs,
        )

    w = ShardedWriter(
        database, dimensions, n_shards=new_n_shards, base_index=new_base, m=m, ef=ef, m0=m0, devices=devices
    )
    if build:
        w.build(spmd=spmd, opts=opts)
    return w


class ShardedReader:
    """Opens every shard's graph from the store and serves fan-out search
    over the devices (per-shard beam, then the top-k merge on
    ``devices[0]``)."""

    def __init__(self, database: Database, n_shards: int, base_index: int = 0, *, devices: Sequence):
        self.n_shards = n_shards
        self.base_index = base_index
        self._readers = [Reader.open(database, base_index + s) for s in range(n_shards)]
        graphs: list[HostGraph] = [r._graph for r in self._readers]
        pad_to_common_shapes(graphs)
        self._index = ShardedIndex.from_host_graphs(graphs, devices, serve_only=True, tier=database.tier)

    def n_items(self) -> int:
        return sum(r.n_items() for r in self._readers)

    def dimensions(self) -> int:
        return self._readers[0].dimensions()

    def search(self, queries: np.ndarray, n: int = 10, ef_search: int = 100):
        """→ list per query of (item_id, distance), globally merged."""
        ids, dists = self._index.search(np.atleast_2d(queries), k=n, ef=max(ef_search, n))
        return [
            [(int(i), float(d)) for i, d in zip(ids[b], dists[b]) if i != 0xFFFFFFFF and np.isfinite(d)]
            for b in range(ids.shape[0])
        ]

    def assert_validity(self) -> None:
        for r in self._readers:
            r.assert_validity()
