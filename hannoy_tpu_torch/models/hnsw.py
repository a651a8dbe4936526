"""The HNSW index model: host mirror (numpy) + device tensors (torch).

Counterpart of ``hannoy_tpu/models/hnsw.py``:

* item vectors → one ``[N_pad, D*]`` tensor plus a ``[N_pad]`` norm
  header: f32 rows, or the ``bf16`` / ``int8`` storage tier of an f32
  metric (``to_device(tier=)``), or the packed codecs' lanes as int32
  (``ops.distances``); the host mirror and the store keep f32 rows (or
  uint32 lanes), so files on disk do not depend on the tier;
* link rows → fixed-width ``int32`` neighbor tables with sentinel ``-1``:
  layer 0 is slot-indexed ``[N_pad, M0]``; upper layers are compact
  ``[L, U_pad, M]`` tables plus a per-level ``slot → row`` map;
* item ids are arbitrary ``u32``; device tensors are indexed by dense
  *slots*, and the host keeps ``ids[slot]`` and the ``id → slot`` map.

Link distances are cached beside ids (``dists0``/``upper_dists``) during
builds. Unlike the JAX package, ``from_device`` keeps them in f32.

``HostGraph.load`` / ``flush_links`` read and write the store's links
records (ids only; ``wave_ops.fill_link_dists`` restores the distances on
the device). Every ``to_device`` uploads the vectors anew: the JAX
package's device vector cache is not ported (ROADMAP.md). The JAX package
selects the storage tier by environment variables; here it is an
argument.

``HostGraph.permute`` and ``permute_device`` renumber slots (the bulk
build's ``bulk_renumber``): an in-memory layout change only, since the
store is keyed by item id.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..ops import codecs, distances
from ..store.env import Database, RoTxn, RwTxn
from ..store.schema import (
    Key,
    NodeMode,
    Prefix,
    decode_item,
    decode_links,
    keys_bytes,
    links_payload,
)

INVALID_ID = np.uint32(0xFFFFFFFF)


def slot_capacity(n: int) -> int:
    """Round a slot count up (the JAX package's capacity buckets)."""
    if n <= 256:
        return 256
    cap = 256
    while cap < n:
        cap += max(256, cap // 2)
    return cap


@dataclasses.dataclass
class HostGraph:
    """Host-side (numpy) mirror of one index's graph — the mutable working
    form used by builders and the staging area before the device."""

    metric: distances.Metric
    dimensions: int
    m: int  # M — max links on layers > 0
    m0: int  # M0 — max links on layer 0
    ids: np.ndarray  # [N_pad] u32, INVALID_ID = free slot
    levels: np.ndarray  # [N_pad] i16, -1 = free slot
    vectors: np.ndarray  # [N_pad, D*]
    norms: np.ndarray  # [N_pad] f32
    links0: np.ndarray  # [N_pad, M0] i32 slots, -1 sentinel
    dists0: np.ndarray  # [N_pad, M0] f32, +inf sentinel
    # upper[l-1] for layer l >= 1:
    upper_links: list[np.ndarray]  # each [U_l, M] i32
    upper_dists: list[np.ndarray]  # each [U_l, M] f32
    slot_rows: list[np.ndarray]  # each [N_pad] i32: slot -> row, -1 absent
    upper_row_count: list[int]  # rows allocated so far per upper layer
    entry_slots: list[int]
    max_level: int
    id_to_slot: dict[int, int] = dataclasses.field(default_factory=dict)
    free_slots: list[int] = dataclasses.field(default_factory=list)
    next_fresh: int = 0  # first never-allocated slot

    # -- construction ------------------------------------------------------
    @classmethod
    def empty(
        cls,
        metric: distances.Metric,
        dimensions: int,
        m: int,
        m0: int,
        capacity: int = 256,
    ) -> "HostGraph":
        d_star = codecs.n_lanes(dimensions, metric.codec) if metric.is_packed else dimensions
        vec_dtype = np.uint32 if metric.is_packed else np.float32
        return cls(
            metric=metric,
            dimensions=dimensions,
            m=m,
            m0=m0,
            ids=np.full(capacity, INVALID_ID, dtype=np.uint32),
            levels=np.full(capacity, -1, dtype=np.int16),
            vectors=np.zeros((capacity, d_star), dtype=vec_dtype),
            norms=np.zeros(capacity, dtype=np.float32),
            links0=np.full((capacity, m0), -1, dtype=np.int32),
            dists0=np.full((capacity, m0), np.inf, dtype=np.float32),
            upper_links=[],
            upper_dists=[],
            slot_rows=[],
            upper_row_count=[],
            entry_slots=[],
            max_level=0,
        )

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]

    @property
    def n_items(self) -> int:
        return int((self.levels >= 0).sum())

    def valid_mask(self) -> np.ndarray:
        return self.levels >= 0

    def reset_links(self) -> None:
        """Drop all link state, keeping staged items — the next build
        relinks every live item (``force_rebuild`` analogue)."""
        self.links0.fill(-1)
        self.dists0.fill(np.inf)
        self.upper_links = []
        self.upper_dists = []
        self.slot_rows = []
        self.upper_row_count = []
        self.entry_slots = []
        self.max_level = 0
        self.levels[self.levels >= 0] = 0

    # -- slot management ---------------------------------------------------
    def grow(self, min_capacity: int) -> None:
        new_cap = slot_capacity(min_capacity)
        if new_cap <= self.capacity:
            return
        extra = new_cap - self.capacity

        def pad(a: np.ndarray, fill) -> np.ndarray:
            shape = (extra,) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)], axis=0)

        self.ids = pad(self.ids, INVALID_ID)
        self.levels = pad(self.levels, -1)
        self.vectors = pad(self.vectors, 0)
        self.norms = pad(self.norms, 0.0)
        self.links0 = pad(self.links0, -1)
        self.dists0 = pad(self.dists0, np.inf)
        self.slot_rows = [pad(sr, -1) for sr in self.slot_rows]

    def alloc_slot(self, item_id: int) -> int:
        existing = self.id_to_slot.get(item_id)
        if existing is not None:
            return existing
        if self.free_slots:
            slot = self.free_slots.pop()
        else:
            if self.next_fresh >= self.capacity:
                self.grow(self.capacity + 1)
            slot = self.next_fresh
            self.next_fresh += 1
        self.ids[slot] = item_id
        self.id_to_slot[item_id] = slot
        return slot

    def release_slot(self, slot: int) -> None:
        item_id = int(self.ids[slot])
        self.id_to_slot.pop(item_id, None)
        self.ids[slot] = INVALID_ID
        self.levels[slot] = -1
        self.links0[slot] = -1
        self.dists0[slot] = np.inf
        for l in range(len(self.slot_rows)):
            row = self.slot_rows[l][slot]
            if row >= 0:
                self.upper_links[l][row] = -1
                self.upper_dists[l][row] = np.inf
                self.slot_rows[l][slot] = -1
        self.free_slots.append(slot)

    def ensure_layers(self, max_level: int) -> None:
        """Make sure compact tables exist for layers 1..max_level."""
        while len(self.upper_links) < max_level:
            self.upper_links.append(np.full((64, self.m), -1, dtype=np.int32))
            self.upper_dists.append(np.full((64, self.m), np.inf, dtype=np.float32))
            self.slot_rows.append(np.full(self.capacity, -1, dtype=np.int32))
            self.upper_row_count.append(0)

    def upper_row(self, level: int, slot: int) -> int:
        """Row index of ``slot`` in layer ``level`` (>=1), allocating if new."""
        l = level - 1
        self.ensure_layers(level)
        row = int(self.slot_rows[l][slot])
        if row >= 0:
            return row
        row = self.upper_row_count[l]
        if row >= self.upper_links[l].shape[0]:
            extra = max(64, self.upper_links[l].shape[0] // 2)
            self.upper_links[l] = np.concatenate(
                [self.upper_links[l], np.full((extra, self.m), -1, dtype=np.int32)]
            )
            self.upper_dists[l] = np.concatenate(
                [self.upper_dists[l], np.full((extra, self.m), np.inf, dtype=np.float32)]
            )
        self.upper_links[l][row] = -1
        self.upper_dists[l][row] = np.inf
        self.slot_rows[l][slot] = row
        self.upper_row_count[l] = row + 1
        return row

    def links_of(self, slot: int, level: int) -> np.ndarray:
        if level == 0:
            row = self.links0[slot]
        else:
            r = self.slot_rows[level - 1][slot] if level - 1 < len(self.slot_rows) else -1
            if r < 0:
                return np.empty(0, dtype=np.int32)
            row = self.upper_links[level - 1][r]
        return row[row >= 0]

    def set_links(self, slot: int, level: int, link_slots: np.ndarray, link_dists: np.ndarray) -> None:
        cap = self.m0 if level == 0 else self.m
        k = min(len(link_slots), cap)
        if level == 0:
            self.links0[slot] = -1
            self.dists0[slot] = np.inf
            self.links0[slot, :k] = link_slots[:k]
            self.dists0[slot, :k] = link_dists[:k]
        else:
            row = self.upper_row(level, slot)
            self.upper_links[level - 1][row] = -1
            self.upper_dists[level - 1][row] = np.inf
            self.upper_links[level - 1][row, :k] = link_slots[:k]
            self.upper_dists[level - 1][row, :k] = link_dists[:k]

    def permute(self, perm: np.ndarray) -> None:
        """Renumber slots: new slot ``i`` takes old slot ``perm[i]``
        (``perm`` a bijection over the capacity). Link values are slots and
        go through the inverse; upper-table rows are not slots and keep
        their order (only ``slot_rows`` is re-indexed)."""
        perm = np.asarray(perm, dtype=np.int64)
        assert perm.shape[0] == self.capacity
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.capacity, dtype=np.int64)

        def remap_vals(table: np.ndarray) -> np.ndarray:
            return np.where(table >= 0, inv[np.maximum(table, 0)], -1).astype(table.dtype)

        self.permute_host_only(perm, inv)
        self.links0 = remap_vals(self.links0)[perm]
        self.dists0 = self.dists0[perm]
        for l in range(len(self.upper_links)):
            self.upper_links[l] = remap_vals(self.upper_links[l])

    def permute_host_only(self, perm: np.ndarray, inv: np.ndarray) -> None:
        """``permute`` without the link tables: for a build that renumbered
        them on the device (``permute_device``) before ``from_device``
        brings them back."""
        self.ids = self.ids[perm]
        self.levels = self.levels[perm]
        self.vectors = self.vectors[perm]
        self.norms = self.norms[perm]
        for l in range(len(self.slot_rows)):
            self.slot_rows[l] = self.slot_rows[l][perm]
        self.entry_slots = [int(inv[e]) for e in self.entry_slots]
        self.id_to_slot = {int(self.ids[s]): int(s) for s in np.nonzero(self.ids != INVALID_ID)[0]}
        self.free_slots = np.nonzero(self.ids == INVALID_ID)[0].tolist()
        self.next_fresh = self.capacity

    # -- store I/O ---------------------------------------------------------
    @classmethod
    def load(
        cls,
        db: Database,
        txn: RoTxn,
        index: int,
        metric: distances.Metric,
        metadata,
    ) -> "HostGraph":
        """Reconstruct the graph mirror from the store (the ``Reader.open``
        and incremental-``Writer`` load path).

        Persisted link rows carry only neighbor ids (like the reference's
        RoaringBitmaps); they come back with NaN distances, "unknown", and
        ``wave_ops.fill_link_dists`` recomputes them on the device.
        """
        n = len(metadata.items)
        g = cls.empty(
            metric,
            metadata.dimensions,
            metadata.m,
            metadata.m0,
            capacity=slot_capacity(max(n, 1)),
        )
        if hasattr(db, "bulk_rows") and n and not getattr(txn, "overlay", None):
            # native store, clean snapshot: one C call stages every item's
            # header+vector (value layout: tag u8 ∥ hlen u16 ∥ f32 norm ∥
            # vector bytes). Dirty write txns fall through to the row loop —
            # bulk_rows reads the committed generation only.
            codec = metric.codec
            vec_bytes = (
                metadata.dimensions * 4
                if codec == codecs.F32
                else codecs.padded_dim(metadata.dimensions, codec) // 8
            )
            keys, rows = db.bulk_rows(
                txn, Prefix.item(index), skip=3, row_bytes=4 + vec_bytes, cap=n
            )
            items = (keys & 0xFFFFFFFF00) >> 8  # u64 key → item field
            for item in items:
                g.alloc_slot(int(item))
            g.norms[: len(keys)] = rows[:, :4].copy().view("<f4")[:, 0]
            g.vectors[: len(keys)] = rows[:, 4:].copy().view("<f4" if codec == codecs.F32 else "<u4")
            g.levels[: len(keys)] = 0
        else:
            for key, val in db.prefix_iter(txn, Prefix.item(index)):
                item = Key.from_bytes(key).item
                header, vecb = decode_item(val)
                s = g.alloc_slot(item)
                g.vectors[s] = codecs.vector_from_bytes(vecb, metric.codec)
                g.norms[s] = struct.unpack("<f", header)[0]
                g.levels[s] = 0
        g.max_level = metadata.max_level
        g.ensure_layers(g.max_level)
        # Two passes over links rows. A links row whose owner has no item
        # record belongs to a deleted-but-not-yet-rebuilt item (del_item
        # removes the record immediately; its links persist until the next
        # build — reference writer.rs:577-580). Such owners get *ghost*
        # slots (zero vector) so survivor rows keep their edges intact and
        # a builder's deletion repair sees the full graph.
        raw_rows: list[tuple[int, int, np.ndarray]] = []
        for key, val in db.prefix_iter(txn, Prefix.links(index)):
            k = Key.from_bytes(key)
            ids = decode_links(val).to_array()
            raw_rows.append((k.item, k.layer, ids))
            if k.item not in g.id_to_slot:
                s = g.alloc_slot(k.item)
                g.levels[s] = 0  # raised as its rows are applied below
        # Vectorized id → slot mapping + batched layer-0 fill: one sorted
        # table + one np.searchsorted over every link of the layer instead
        # of a Python dict probe per link. Upper layers are ~1/M of the
        # rows and keep the simple per-row path.
        known_ids = np.fromiter(g.id_to_slot.keys(), dtype=np.int64, count=len(g.id_to_slot))
        known_slots = np.fromiter(g.id_to_slot.values(), dtype=np.int32, count=len(g.id_to_slot))
        order = np.argsort(known_ids)
        known_ids, known_slots = known_ids[order], known_slots[order]

        def map_ids(ids64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            """→ (slots for the hits, hit mask) — missing ids dropped."""
            pos = np.searchsorted(known_ids, ids64)
            pos_ok = pos < len(known_ids)
            hit = np.zeros(len(ids64), dtype=bool)
            hit[pos_ok] = known_ids[pos[pos_ok]] == ids64[pos_ok]
            return known_slots[pos[hit]], hit

        l0 = [(item, ids) for item, layer, ids in raw_rows if layer == 0]
        if l0:
            owners = np.asarray([g.id_to_slot[item] for item, _ in l0], dtype=np.int64)
            lens = np.asarray([len(ids) for _, ids in l0], dtype=np.int64)
            flat = (
                np.concatenate([ids for _, ids in l0]).astype(np.int64)
                if lens.sum()
                else np.empty(0, dtype=np.int64)
            )
            slots_flat, hit = map_ids(flat)
            row_of = np.repeat(np.arange(len(l0)), lens)[hit]
            # rank within each row after dropping misses
            rank = np.zeros(len(row_of), dtype=np.int64)
            if len(row_of):
                first = np.concatenate([[True], row_of[1:] != row_of[:-1]])
                idx = np.arange(len(row_of))
                starts = np.maximum.accumulate(np.where(first, idx, 0))
                rank = idx - starts
            keep = rank < g.m0
            g.links0[owners, :] = -1
            g.dists0[owners, :] = np.inf
            g.links0[owners[row_of[keep]], rank[keep]] = slots_flat[keep]
            g.dists0[owners[row_of[keep]], rank[keep]] = np.nan
        for item, layer, ids in raw_rows:
            slot = g.id_to_slot[item]
            g.levels[slot] = max(g.levels[slot], layer)
            if layer == 0:
                continue  # bulk-filled above
            link_slots, _ = map_ids(ids.astype(np.int64))
            # NaN marks "distance unknown, recompute on device"
            g.set_links(
                slot, layer, link_slots, np.full(len(link_slots), np.nan, dtype=np.float32)
            )
        g.entry_slots = [
            g.id_to_slot[e] for e in metadata.entry_points if e in g.id_to_slot
        ]
        return g

    def flush_links(self, db: Database, wtxn: RwTxn, index: int, slots=None) -> None:
        """Persist link rows to the store (reference's single-threaded
        flush, hnsw.rs:192-213: layers → LMDB puts).

        ``slots``: rows to flush — builds pass the touched set
        (``BuildStats.touched``) so a small incremental build into a large
        index issues puts for the rows it changed only (the reference
        flushes only nodes in its in-progress maps). ``None`` flushes every
        valid slot.

        Writes one links row per (item, layer<=level) — including empty
        rows, matching the reference where every inserted node gets a
        ``NodeState`` even if no links were added (hnsw.rs:419-424).

        The rows are assembled with the vectorized schema codecs
        (``keys_bytes``/``links_payload``, byte-identical to the
        per-record codecs) and written with one ``put_many_raw`` per level
        batch, which both store backends provide."""
        if slots is None:
            slots = np.nonzero(self.valid_mask())[0]
        slots = np.asarray(slots, dtype=np.int64)
        slots = slots[self.levels[slots] >= 0]  # released since touched
        if not len(slots):
            return
        lvls = self.levels[slots]
        for level in range(int(lvls.max()) + 1):
            sl = slots[lvls >= level]
            if level == 0:
                table = self.links0[sl]
            else:
                rows = self.slot_rows[level - 1][sl]
                table = self.upper_links[level - 1][np.maximum(rows, 0)]
                table = np.where((rows >= 0)[:, None], table, -1)
            link_ids = np.where(
                table >= 0,
                self.ids[np.maximum(table, 0)].astype(np.int64),
                np.int64(-1),
            )
            for start in range(0, len(sl), 262144):
                part = slice(start, start + 262144)
                keys = keys_bytes(
                    index, NodeMode.LINKS, self.ids[sl[part]].astype(np.uint32), layer=level
                )
                vbuf, offs = links_payload(link_ids[part])
                db.put_many_raw(wtxn, keys.tobytes(), vbuf, offs)

    # -- invariants --------------------------------------------------------
    def check_validity(self) -> None:
        """Graph invariant checker (reference ``assert_validity``): links
        point only at live slots at or above their layer; entry slots are
        live and at the top layer; only live slots own upper rows.

        The JAX package's checker, vectorised per layer; raises
        ``AssertionError`` naming the first offending slot."""
        valid = self.valid_mask()
        levels = self.levels.astype(np.int64)
        for level in range(min(int(levels.max(initial=0)), len(self.slot_rows)) + 1):
            if level == 0:
                owners = np.nonzero(valid)[0]
                table = self.links0[owners]
            else:
                rows = self.slot_rows[level - 1]
                owners = np.nonzero(valid & (levels >= level) & (rows >= 0))[0]
                table = self.upper_links[level - 1][rows[owners]]
            nb = np.maximum(table, 0)
            for bad, what in (
                ((table >= 0) & ~valid[nb], f"level {level} links dead slot"),
                ((table >= 0) & (levels[nb] < level), "links below its level:"),
            ):
                if bad.any():
                    r, c = np.argwhere(bad)[0]
                    raise AssertionError(f"slot {int(owners[r])} {what} {int(table[r, c])}")
        live = np.nonzero(valid)[0]
        for ep in self.entry_slots:
            if not valid[ep]:
                raise AssertionError(f"entry slot {ep} is dead")
            if int(self.levels[ep]) < self.max_level:
                raise AssertionError("entry point below top layer")
        for l, rows in enumerate(self.slot_rows):
            dead = np.nonzero((rows >= 0) & ~valid)[0]
            if len(dead):
                raise AssertionError(f"dead slot {int(dead[0])} still owns a layer-{l + 1} row")
        if len(live) and not self.entry_slots:
            raise AssertionError("non-empty graph must have entry points")


def host_graph_from_arrays(
    *,
    metric: str | distances.Metric,
    dimensions: int,
    m: int,
    m0: int,
    ids: np.ndarray,
    levels: np.ndarray,
    vectors: np.ndarray,
    norms: np.ndarray,
    links0: np.ndarray,
    dists0: np.ndarray,
    upper_links: list[np.ndarray],
    upper_dists: list[np.ndarray],
    slot_rows: list[np.ndarray],
    upper_row_count: list[int],
    entry_slots: list[int],
    max_level: int,
    id_to_slot: dict[int, int] | None = None,
    free_slots: list[int] | None = None,
    next_fresh: int | None = None,
) -> HostGraph:
    """A ``HostGraph`` from another implementation's state: plain numpy
    arrays, lists and ints (the fields of the JAX package's ``HostGraph``).
    Every array is copied."""
    if isinstance(metric, str):
        metric = distances.by_name(metric)
    ids = np.array(ids, dtype=np.uint32)
    if id_to_slot is None:
        live = np.nonzero(ids != INVALID_ID)[0]
        id_to_slot = {int(ids[s]): int(s) for s in live}
    return HostGraph(
        metric=metric,
        dimensions=int(dimensions),
        m=int(m),
        m0=int(m0),
        ids=ids,
        levels=np.array(levels, dtype=np.int16),
        vectors=np.array(vectors),
        norms=np.array(norms, dtype=np.float32),
        links0=np.array(links0, dtype=np.int32),
        dists0=np.array(dists0, dtype=np.float32),
        upper_links=[np.array(a, dtype=np.int32) for a in upper_links],
        upper_dists=[np.array(a, dtype=np.float32) for a in upper_dists],
        slot_rows=[np.array(a, dtype=np.int32) for a in slot_rows],
        upper_row_count=[int(c) for c in upper_row_count],
        entry_slots=[int(e) for e in entry_slots],
        max_level=int(max_level),
        id_to_slot=dict(id_to_slot),
        free_slots=list(free_slots or []),
        next_fresh=int(next_fresh if next_fresh is not None else len(id_to_slot)),
    )


# --------------------------------------------------------------------------
# Device form
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceGraph:
    """Device-resident search and build state: tensors plus static meta.

    ``upper_links``/``upper_dists`` are stacked ``[L, U_pad, M]``;
    ``slot_rows`` is ``[L, N_pad]``. ``L == 0`` (flat graph) uses zero-size
    leading dims. Builders update the tables in place.
    """

    vectors: torch.Tensor  # [N_pad, D*] f32 | bf16 | int8 | int32 lanes
    norms: torch.Tensor  # [N_pad] f32 (int8 tier: 127 or the row's scale)
    links0: torch.Tensor  # [N_pad, M0] i32
    dists0: torch.Tensor  # [N_pad, M0] f32 ([1, 1] placeholder when serve-only)
    upper_links: torch.Tensor  # [L, U_pad, M] i32
    upper_dists: torch.Tensor  # [L, U_pad, M] f32
    slot_rows: torch.Tensor  # [L, N_pad] i32
    entry_slots: torch.Tensor  # [E_pad] i32, -1 padded
    valid: torch.Tensor  # [N_pad] bool
    metric_name: str
    max_level: int

    @property
    def metric(self) -> distances.Metric:
        return distances.by_name(self.metric_name)

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def m0(self) -> int:
        return self.links0.shape[1]


def ep_pad(n: int) -> int:
    """Entry-point array width for ``n`` entry points: a power of two, at
    least 32, never truncating seeds (a flat index keeps every top-layer
    item as an entry point)."""
    p = 32
    while p < n:
        p *= 2
    return p


def _t(arr: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host array (never a view of host memory)."""
    return torch.tensor(np.asarray(arr), device=device)


TIERS = ("raw", "bf16", "int8")


def _rows_to_device(rows, device) -> torch.Tensor:
    """Host rows of any device row type → a device tensor of that type
    (bf16 rows come as a torch tensor, or as numpy's extension type)."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device)
    rows = np.asarray(rows)
    if rows.dtype == np.uint32:
        return _t(distances.as_lanes(rows), device)
    if rows.dtype.name == "bfloat16":
        return _t(np.ascontiguousarray(rows).view(np.int16), device).view(torch.bfloat16)
    if rows.dtype in (np.int8, np.int32):
        return _t(rows, device)
    return _t(np.asarray(rows, dtype=np.float32), device)


def encode_tier(metric: distances.Metric, vecs: np.ndarray, norms: np.ndarray, tier: str):
    """Host rows and norm headers → (rows, headers) as the device holds
    them under ``tier`` (the JAX package's encoders; rows come back as
    numpy, bf16 as a torch tensor since numpy has no such type).

    * ``int8``, cosine: ``round(127·v/|v|)`` with header 127, the length
      of the stored row (0 for a zero row, so the cosine guard still
      gives distance 0);
    * ``int8``, euclidean / manhattan: ``round(127·v/max|v_i|)`` with the
      row's scale ``max|v_i|/127`` in the header (``distances._deq``);
    * ``bf16``: a cast, headers unchanged.
    """
    if tier == "int8":
        if metric.name == "cosine":
            mags = np.linalg.norm(vecs, axis=-1, keepdims=True)
            header = np.where(mags[:, 0] > 1e-30, np.float32(127.0), np.float32(0.0))
        else:
            mags = np.abs(vecs).max(axis=-1, keepdims=True)
            header = np.where(mags[:, 0] > 1e-30, mags[:, 0] / np.float32(127.0), 0.0).astype(np.float32)
        unit = np.divide(vecs, mags, out=np.zeros_like(vecs), where=mags > 1e-30)
        return np.clip(np.rint(127.0 * unit), -127, 127).astype(np.int8), header
    if tier == "bf16":
        return torch.from_numpy(np.ascontiguousarray(vecs)).to(torch.bfloat16), norms
    return vecs, norms


def device_graph_from_arrays(
    device,
    *,
    vectors: np.ndarray,
    norms: np.ndarray,
    links0: np.ndarray,
    dists0: np.ndarray,
    upper_links: np.ndarray,
    upper_dists: np.ndarray,
    slot_rows: np.ndarray,
    entry_slots: np.ndarray,
    valid: np.ndarray,
    metric_name: str,
    max_level: int,
) -> DeviceGraph:
    """A ``DeviceGraph`` on ``device`` from another implementation's
    device state as numpy arrays (the fields of the JAX package's
    ``DeviceGraph``). ``vectors`` keep their row type: float32, int8,
    bfloat16 (numpy's extension type, taken by its bits), or uint32 lanes
    (held as int32, see ``ops.distances``)."""
    return DeviceGraph(
        vectors=_rows_to_device(vectors, device),
        norms=_t(np.asarray(norms, dtype=np.float32), device),
        links0=_t(np.asarray(links0, dtype=np.int32), device),
        dists0=_t(np.asarray(dists0, dtype=np.float32), device),
        upper_links=_t(np.asarray(upper_links, dtype=np.int32), device),
        upper_dists=_t(np.asarray(upper_dists, dtype=np.float32), device),
        slot_rows=_t(np.asarray(slot_rows, dtype=np.int32), device),
        entry_slots=_t(np.asarray(entry_slots, dtype=np.int32), device),
        valid=_t(np.asarray(valid, dtype=bool), device),
        metric_name=str(metric_name),
        max_level=int(max_level),
    )


def to_device(g: HostGraph, device, serve_only: bool = False, tier: str = "raw", link_slack: int = 0) -> DeviceGraph:
    """Copy a host graph into device tensors on ``device``.

    ``serve_only``: search never reads link distances, so readers upload
    ``[1, 1]`` placeholders for ``dists0``/``upper_dists``.

    ``link_slack``: extra layer-0 columns for a build (the table becomes
    ``[N_pad, M0 + slack]``, the host rows in its first M0 columns, -1 /
    +inf in the rest; ``build.wave_ops.prune_slack_rows``).

    ``tier``: how the rows of an f32 metric are held on the device —
    ``"raw"`` f32, ``"bf16"`` (half the bytes) or ``"int8"`` (a quarter;
    ``encode_tier``). Packed metrics are always ``"raw"`` (their lanes).
    """
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    n_layers = len(g.upper_links)
    if n_layers:
        u_pad = max(a.shape[0] for a in g.upper_links)
        up = np.full((n_layers, u_pad, g.m), -1, dtype=np.int32)
        ud = np.full((n_layers, u_pad, g.m), np.inf, dtype=np.float32)
        sr = np.full((n_layers, g.capacity), -1, dtype=np.int32)
        for l in range(n_layers):
            a = g.upper_links[l]
            up[l, : a.shape[0]] = a
            ud[l, : a.shape[0]] = g.upper_dists[l]
            sr[l] = g.slot_rows[l]
    else:
        up = np.zeros((0, 1, g.m), dtype=np.int32)
        ud = np.zeros((0, 1, g.m), dtype=np.float32)
        sr = np.zeros((0, g.capacity), dtype=np.int32)
    eps = np.full(ep_pad(len(g.entry_slots)), -1, dtype=np.int32)
    eps[: len(g.entry_slots)] = np.asarray(g.entry_slots, dtype=np.int32)
    links0, dists0 = g.links0, g.dists0
    if link_slack:
        links0 = np.pad(links0, ((0, 0), (0, link_slack)), constant_values=-1)
        dists0 = np.pad(dists0, ((0, 0), (0, link_slack)), constant_values=np.inf)
    if serve_only:
        dists0, ud = np.zeros((1, 1), np.float32), np.zeros((1, 1, 1), np.float32)
    rows, headers = encode_tier(g.metric, g.vectors, g.norms, "raw" if g.metric.is_packed else tier)
    return device_graph_from_arrays(
        device,
        vectors=rows,
        norms=headers,
        links0=links0,
        dists0=dists0,
        upper_links=up,
        upper_dists=ud,
        slot_rows=sr,
        entry_slots=eps,
        valid=g.valid_mask(),
        metric_name=g.metric.name,
        max_level=g.max_level,
    )


def permute_device(dev: DeviceGraph, perm: torch.Tensor, inv: torch.Tensor) -> DeviceGraph:
    """Renumber the slots of a device graph → a new ``DeviceGraph``: new
    slot ``i`` takes old slot ``perm[i]``, and link values and entry slots
    (slots) go through ``inv``; upper-table rows keep their order, only
    ``slot_rows`` is re-indexed (``HostGraph.permute`` on the device)."""
    p, iv = perm.long(), inv.to(torch.int32)

    def remap(t: torch.Tensor) -> torch.Tensor:
        return torch.where(t >= 0, iv[t.clamp(min=0).long()], -1)

    return DeviceGraph(
        vectors=dev.vectors[p],
        norms=dev.norms[p],
        links0=remap(dev.links0)[p],
        dists0=dev.dists0[p],
        upper_links=remap(dev.upper_links),
        upper_dists=dev.upper_dists,
        slot_rows=dev.slot_rows[:, p],
        entry_slots=remap(dev.entry_slots),
        valid=dev.valid[p],
        metric_name=dev.metric_name,
        max_level=dev.max_level,
    )


def from_device(g: HostGraph, dev: DeviceGraph) -> None:
    """Copy the link tables of ``dev`` back into the host mirror (builders
    sync before the host reads them). Distances stay f32. A slack-widened
    layer-0 table comes back as its first M0 columns (rows pruned to M0
    first, ``wave_ops.prune_slack_rows``)."""
    g.links0 = dev.links0[:, : g.m0].cpu().numpy().copy()
    g.dists0 = dev.dists0[:, : g.m0].cpu().numpy().copy()
    up = dev.upper_links.cpu().numpy()
    ud = dev.upper_dists.cpu().numpy()
    for l in range(up.shape[0]):
        rows = g.upper_links[l].shape[0]
        g.upper_links[l] = up[l, :rows].copy()
        g.upper_dists[l] = ud[l, :rows].copy()
