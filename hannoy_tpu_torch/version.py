"""Format-version stamp persisted with every build.

Mirrors the reference's ``Version`` record stored under the metadata-mode
key with item id 1 (the hannoy crate's ``src/version.rs:8-60``); written at
every build (``src/writer.rs:596-600``) to enable dumpless upgrades.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

_FMT = ">III"  # major, minor, patch — big-endian u32 each


@dataclass(frozen=True, order=True)
class Version:
    major: int
    minor: int
    patch: int

    @classmethod
    def current(cls) -> "Version":
        return CURRENT_VERSION

    def to_bytes(self) -> bytes:
        return struct.pack(_FMT, self.major, self.minor, self.patch)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Version":
        major, minor, patch = struct.unpack(_FMT, data)
        return cls(major, minor, patch)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.major}.{self.minor}.{self.patch}"


CURRENT_VERSION = Version(0, 1, 0)
