"""Compressed sets of u32 item ids.

The port's replacement for the reference's RoaringBitmap usage
(``roaring`` crate; e.g. items bitmap in ``src/metadata.rs:12-73``, visited
sets in ``src/hnsw.rs:471``). On host we represent a set as an immutable
sorted ``uint32`` numpy array — set algebra becomes vectorised merges — and
serialise with run-length encoding so dense ranges cost O(1) instead of
O(n), matching roaring's compression goal (~200 B/vector edge overhead claim
in the reference README).
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator

import numpy as np

_U32_MAX = 0xFFFFFFFF


class IdSet:
    """Immutable sorted set of u32 ids with roaring-like algebra.

    Supports ``| & - ^``, containment, iteration, and an RLE byte codec.
    """

    __slots__ = ("_a",)

    def __init__(self, ids: Iterable[int] | np.ndarray = ()):
        a = np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids)
        if a.size == 0:
            self._a = np.empty(0, dtype=np.uint32)
            return
        if a.min() < 0 or a.max() > _U32_MAX:
            raise ValueError("ids must be u32")
        self._a = np.unique(a.astype(np.uint32))

    @classmethod
    def _wrap(cls, sorted_unique: np.ndarray) -> "IdSet":
        out = cls.__new__(cls)
        out._a = sorted_unique
        return out

    # -- basic protocol ----------------------------------------------------
    def __len__(self) -> int:
        return int(self._a.size)

    def __bool__(self) -> bool:
        return self._a.size > 0

    def __iter__(self) -> Iterator[int]:
        return iter(int(x) for x in self._a)

    def __contains__(self, item: int) -> bool:
        i = np.searchsorted(self._a, np.uint32(item))
        return i < self._a.size and self._a[i] == item

    def __eq__(self, other) -> bool:
        return isinstance(other, IdSet) and np.array_equal(self._a, other._a)

    def __hash__(self):
        return hash(self._a.tobytes())

    def __repr__(self) -> str:
        if len(self) <= 16:
            return f"IdSet({list(self._a)})"
        return f"IdSet(<{len(self)} ids, min={self._a[0]}, max={self._a[-1]}>)"

    # -- algebra -----------------------------------------------------------
    def __or__(self, other: "IdSet") -> "IdSet":
        return IdSet._wrap(np.union1d(self._a, other._a))

    def __and__(self, other: "IdSet") -> "IdSet":
        return IdSet._wrap(np.intersect1d(self._a, other._a, assume_unique=True))

    def __sub__(self, other: "IdSet") -> "IdSet":
        return IdSet._wrap(np.setdiff1d(self._a, other._a, assume_unique=True))

    def __xor__(self, other: "IdSet") -> "IdSet":
        return IdSet._wrap(np.setxor1d(self._a, other._a, assume_unique=True))

    def isdisjoint(self, other: "IdSet") -> bool:
        return len(self & other) == 0

    def issubset(self, other: "IdSet") -> bool:
        return len(self - other) == 0

    def intersection_len(self, other: "IdSet") -> int:
        return len(self & other)

    def contains_array(self, ids: np.ndarray) -> np.ndarray:
        """Vectorised membership test for an array of ids."""
        ids = np.asarray(ids, dtype=np.uint32)
        return np.isin(ids, self._a, assume_unique=False)

    # -- views -------------------------------------------------------------
    def to_array(self) -> np.ndarray:
        """Sorted uint32 view (do not mutate)."""
        return self._a

    def min(self) -> int:
        if not self:
            raise ValueError("empty IdSet")
        return int(self._a[0])

    def max(self) -> int:
        if not self:
            raise ValueError("empty IdSet")
        return int(self._a[-1])

    # -- codec -------------------------------------------------------------
    def to_bytes(self) -> bytes:
        """RLE codec: u32 run count, then (start, length) u32 pairs."""
        a = self._a
        if a.size == 0:
            return struct.pack(">I", 0)
        # run starts where the delta from the previous element is != 1
        delta = np.diff(a.astype(np.int64))
        starts_idx = np.concatenate(([0], np.nonzero(delta != 1)[0] + 1))
        ends_idx = np.concatenate((starts_idx[1:], [a.size]))
        starts = a[starts_idx].astype(np.uint32)
        lengths = (ends_idx - starts_idx).astype(np.uint32)
        runs = np.empty(starts.size * 2, dtype=">u4")
        runs[0::2] = starts
        runs[1::2] = lengths
        return struct.pack(">I", starts.size) + runs.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "IdSet":
        (n_runs,) = struct.unpack_from(">I", data, 0)
        if n_runs == 0:
            return cls()
        runs = np.frombuffer(data, dtype=">u4", count=n_runs * 2, offset=4)
        starts = runs[0::2].astype(np.int64)
        lengths = runs[1::2].astype(np.int64)
        total = int(lengths.sum())
        out = np.empty(total, dtype=np.uint32)
        pos = 0
        for s, l in zip(starts, lengths):
            out[pos : pos + l] = np.arange(s, s + l, dtype=np.uint32)
            pos += l
        return cls._wrap(out)
