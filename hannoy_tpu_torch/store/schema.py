"""Key/value schema for the host store.

Mirrors the reference's LMDB schema so the on-host persistence layer has the
same addressing model:

* 8-byte keys ``u16 index ∥ u8 mode ∥ u32 item ∥ u8 layer``, big-endian so
  lexicographic byte order equals logical order and prefix scans work
  (reference ``src/key.rs:19-82``).
* ``NodeMode`` discriminants are DB-format-stable: Metadata=0, Updated=1,
  Links=2, Item=3 (reference ``src/node_id.rs:8-21``). Layer sorts *after*
  item so a node's vector and its per-layer links are adjacent
  (``src/node_id.rs:43-45``).
* Values are tagged unions: tag 0 → Item{header, vector-bytes}, tag 1 →
  Links{id set} (reference ``src/node.rs:21-22,133-174``).
* Per-index singleton metadata record (``src/metadata.rs:12-73``) and
  version stamp under metadata-mode items 0 and 1
  (``src/node_id.rs:55-73``).
* Update journal "stones": Updated=0 / Removed=1 under Updated-mode keys
  (``src/update_status.rs:6-33``).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

import numpy as np

from ..utils.idset import IdSet
from ..version import Version

KEY_SIZE = 8
_KEY_FMT = ">HBIB"  # index u16, mode u8, item u32, layer u8 — big-endian


class NodeMode(enum.IntEnum):
    """DB-format-stable discriminants (reference src/node_id.rs:8-21)."""

    METADATA = 0
    UPDATED = 1
    LINKS = 2
    ITEM = 3


class UpdateStatus(enum.IntEnum):
    """Journal stone payloads (reference src/update_status.rs:6-33)."""

    UPDATED = 0
    REMOVED = 1


@dataclass(frozen=True, order=True)
class Key:
    """An 8-byte store key. Ordering == serialized byte ordering."""

    index: int
    mode: NodeMode
    item: int
    layer: int = 0

    def to_bytes(self) -> bytes:
        return struct.pack(_KEY_FMT, self.index, int(self.mode), self.item, self.layer)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Key":
        index, mode, item, layer = struct.unpack(_KEY_FMT, data)
        return cls(index, NodeMode(mode), item, layer)

    # Constructors mirroring reference src/node_id.rs:55-73 / src/key.rs:19-49
    @classmethod
    def metadata(cls, index: int) -> "Key":
        return cls(index, NodeMode.METADATA, 0, 0)

    @classmethod
    def version(cls, index: int) -> "Key":
        return cls(index, NodeMode.METADATA, 1, 0)

    @classmethod
    def updated(cls, index: int, item: int) -> "Key":
        return cls(index, NodeMode.UPDATED, item, 0)

    @classmethod
    def links(cls, index: int, item: int, layer: int) -> "Key":
        return cls(index, NodeMode.LINKS, item, layer)

    @classmethod
    def item(cls, index: int, item: int) -> "Key":
        return cls(index, NodeMode.ITEM, item, 0)


class Prefix:
    """Range-scan prefixes (reference src/key.rs:86-127)."""

    @staticmethod
    def all(index: int) -> bytes:
        return struct.pack(">H", index)

    @staticmethod
    def updated(index: int) -> bytes:
        return struct.pack(">HB", index, int(NodeMode.UPDATED))

    @staticmethod
    def links(index: int) -> bytes:
        return struct.pack(">HB", index, int(NodeMode.LINKS))

    @staticmethod
    def item(index: int) -> bytes:
        return struct.pack(">HB", index, int(NodeMode.ITEM))


# --------------------------------------------------------------------------
# Node payload codecs (reference src/node.rs:133-174)
# --------------------------------------------------------------------------

_TAG_ITEM = 0
_TAG_LINKS = 1


def encode_item(header: bytes, vector_bytes: bytes) -> bytes:
    """Item payload: tag 0 ∥ u16 header length ∥ header ∥ raw vector bytes."""
    return struct.pack(">BH", _TAG_ITEM, len(header)) + header + vector_bytes


def decode_item(data: bytes) -> tuple[bytes, bytes]:
    tag, hlen = struct.unpack_from(">BH", data, 0)
    if tag != _TAG_ITEM:
        raise ValueError(f"expected item payload, found tag {tag}")
    header = data[3 : 3 + hlen]
    vector = data[3 + hlen :]
    return header, vector


_TAG_LINKS_RAW = 2


def encode_links(ids: np.ndarray | IdSet) -> bytes:
    """Links payload: tag 2 ∥ raw sorted little-endian u32 ids.

    Neighbor lists are <= M0 arbitrary u32s — run-length coding (the
    roaring analogue used for the dense metadata items set) buys nothing
    there, and builds write one row per (item, layer), so this is the
    store's hottest encoder."""
    if isinstance(ids, IdSet):
        arr = ids.to_array()
    else:
        arr = np.sort(np.asarray(ids, dtype=np.uint32))
    return struct.pack(">B", _TAG_LINKS_RAW) + arr.astype("<u4").tobytes()


def decode_links(data: bytes) -> IdSet:
    (tag,) = struct.unpack_from(">B", data, 0)
    if tag == _TAG_LINKS_RAW:
        arr = np.frombuffer(data, dtype="<u4", offset=1).astype(np.uint32)
        return IdSet._wrap(arr)  # already sorted unique
    if tag != _TAG_LINKS:
        raise ValueError(f"expected links payload, found tag {tag}")
    return IdSet.from_bytes(data[1:])


def payload_tag(data: bytes) -> int:
    return data[0]


# --------------------------------------------------------------------------
# Vectorized batch codecs — byte-identical twins of the per-record codecs
# above, for the two store hot paths (item staging, link flush) where a
# per-record Python loop dominates large builds.
# --------------------------------------------------------------------------


def keys_bytes(index: int, mode: NodeMode, items: np.ndarray, layer: int = 0) -> np.ndarray:
    """Vectorized ``Key(...).to_bytes()`` for a batch of items → [n, 8] u8.

    Row ``i`` is byte-identical to ``Key(index, mode, items[i],
    layer).to_bytes()`` (same big-endian u16∥u8∥u32∥u8 layout as the
    reference key codec, src/key.rs:54-82)."""
    items = np.ascontiguousarray(items, dtype=np.uint32)
    n = len(items)
    buf = np.empty((n, 8), dtype=np.uint8)
    buf[:, 0] = (index >> 8) & 0xFF
    buf[:, 1] = index & 0xFF
    buf[:, 2] = int(mode)
    buf[:, 3:7] = items.astype(">u4").view(np.uint8).reshape(n, 4)
    buf[:, 7] = layer
    return buf


def items_payload(headers: np.ndarray, vector_rows: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Vectorized ``encode_item`` for fixed-size rows → (vbuf, offsets).

    ``headers`` is ``[n, H]`` u8 (every row the same header length, as all
    metric headers are a single little-endian f32 norm); ``vector_rows``
    is ``[n, B]`` u8 of raw packed vector bytes. Row ``i`` of the output
    is byte-identical to ``encode_item(headers[i], vector_rows[i])``."""
    n, H = headers.shape
    B = vector_rows.shape[1]
    rec = 3 + H + B
    out = np.empty((n, rec), dtype=np.uint8)
    out[:, 0] = _TAG_ITEM
    out[:, 1] = (H >> 8) & 0xFF
    out[:, 2] = H & 0xFF
    out[:, 3 : 3 + H] = headers
    out[:, 3 + H :] = vector_rows
    offs = (np.arange(n + 1, dtype=np.uint64) * rec).astype(np.uint64)
    return out.tobytes(), offs


def links_payload(link_ids: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Vectorized ``encode_links`` for a batch of rows → (vbuf, offsets).

    ``link_ids`` is ``[n, M]`` int64 with -1 for empty slots; valid
    entries are item ids in [0, 2^32). Row ``i`` of the output is
    byte-identical to ``encode_links(row's valid ids)`` — tag 2 ∥ sorted
    little-endian u32 ids (empty rows are just the tag byte, matching
    the reference writing a NodeState even when no links were added,
    hnsw.rs:419-424)."""
    link_ids = np.asarray(link_ids, dtype=np.int64)
    n, M = link_ids.shape
    # sort valid ids ascending per row; invalids (−1) sort past any u32
    sort_keys = np.where(link_ids >= 0, link_ids, np.int64(1) << 33)
    sorted_ids = np.sort(sort_keys, axis=1)
    counts = (link_ids >= 0).sum(axis=1).astype(np.int64)
    lens = 1 + 4 * counts
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(lens, out=offs[1:])
    vbuf = np.zeros(int(offs[-1]), dtype=np.uint8)
    starts = offs[:-1].astype(np.int64)
    vbuf[starts] = _TAG_LINKS_RAW
    total = int(counts.sum())
    if total:
        valid_mask = sorted_ids < (np.int64(1) << 33)
        flat_ids = sorted_ids[valid_mask].astype("<u4").view(np.uint8).reshape(-1, 4)
        # destination byte offset of each valid id: its row's start + 1
        # (tag) + 4 × its rank within the row
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        dst = np.repeat(starts + 1, counts) + 4 * within
        for b in range(4):
            vbuf[dst + b] = flat_ids[:, b]
    return vbuf.tobytes(), offs


# --------------------------------------------------------------------------
# Metadata codec (reference src/metadata.rs:12-73)
# --------------------------------------------------------------------------


@dataclass
class Metadata:
    """Per-index singleton record.

    Fields mirror the reference ``Metadata``: dimensions, items bitmap,
    distance name (string identity used to check the reader's metric,
    ``src/reader.rs:400-405``), entry points, max level — plus the build's
    (m, m0) link capacities, which the reference bakes in as const generics
    (writer.rs:215) but a runtime-shaped engine must persist.
    """

    dimensions: int
    items: IdSet
    distance: str
    entry_points: list[int]
    max_level: int
    m: int = 16
    m0: int = 32

    def to_bytes(self) -> bytes:
        dist_b = self.distance.encode("utf-8")
        eps = np.asarray(self.entry_points, dtype=">u4")
        items_b = self.items.to_bytes()
        return (
            struct.pack(">IBBBH", self.dimensions, self.max_level, self.m, self.m0, len(dist_b))
            + dist_b
            + struct.pack(">I", eps.size)
            + eps.tobytes()
            + items_b
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Metadata":
        dims, max_level, m, m0, dlen = struct.unpack_from(">IBBBH", data, 0)
        off = 9
        distance = data[off : off + dlen].decode("utf-8")
        off += dlen
        (n_eps,) = struct.unpack_from(">I", data, off)
        off += 4
        eps = np.frombuffer(data, dtype=">u4", count=n_eps, offset=off)
        off += 4 * n_eps
        items = IdSet.from_bytes(data[off:])
        return cls(
            dimensions=dims,
            items=items,
            distance=distance,
            entry_points=[int(e) for e in eps],
            max_level=max_level,
            m=m,
            m0=m0,
        )


def encode_update_status(status: UpdateStatus) -> bytes:
    return bytes([int(status)])


def decode_update_status(data: bytes) -> UpdateStatus:
    return UpdateStatus(data[0])


def encode_version(v: Version) -> bytes:
    return v.to_bytes()


def decode_version(data: bytes) -> Version:
    return Version.from_bytes(data)
