"""Typed error model for hannoy-tpu.

Mirrors the reference's 11-variant ``thiserror`` enum
(the hannoy crate's ``src/error.rs:10-103``): errors are typed, never stringly.
Variants that are LMDB-specific in the reference map onto the host-store
equivalents here.
"""

from __future__ import annotations


class HannoyError(Exception):
    """Base class for all hannoy-tpu errors."""


class StoreError(HannoyError):
    """Host persistence layer failure (reference: ``Error::Heed``/``Io``)."""


class MissingMetadata(HannoyError):
    """Index has no metadata record — it was never built.

    Reference: ``Error::MissingMetadata`` (src/error.rs), raised by
    ``Reader::open`` (src/reader.rs:390-393).
    """

    def __init__(self, index: int):
        self.index = index
        super().__init__(f"Metadata is missing on index {index}, build the database first")


class MissingKey(HannoyError):
    """An internal key (item or links row) was expected but absent.

    Reference: ``Error::MissingKey`` (src/error.rs).
    """

    def __init__(self, key):
        self.key = key
        super().__init__(f"Internal error: missing key {key!r}")


class NeedBuild(HannoyError):
    """The dirty journal is non-empty: mutations exist that were never built.

    Reference: ``Error::NeedBuild``, raised by ``Reader::open``
    (src/reader.rs:407-415).
    """

    def __init__(self, index: int):
        self.index = index
        super().__init__(
            f"The index {index} has pending updates; call Writer.build() before opening a Reader"
        )


class BuildCancelled(HannoyError):
    """A cooperative ``cancel`` closure returned True during a build.

    Reference: ``Error::BuildCancelled`` (src/error.rs), probed every
    ``CANCELLATION_PROBING`` operations (src/lib.rs:140, src/hnsw.rs:174-177).
    """

    def __init__(self):
        super().__init__("The corresponding build process has been cancelled")


class InvalidConfig(HannoyError):
    """Build/index configuration outside the supported envelope.

    The reference constrains (M, M0) at compile time via const generics and
    a bindings monomorphization table capped at (32, 64)
    (src/python.rs:267-282); here m/m0 are runtime values persisted as u8
    in Metadata, so the bound is validated up front instead of failing at
    metadata-write time after a full device build.
    """

    def __init__(self, message: str):
        super().__init__(message)


class InvalidVecDimension(HannoyError):
    """A vector with the wrong dimensionality was supplied.

    Reference: ``Error::InvalidVecDimension`` (src/error.rs), raised by
    ``Writer::add_item`` (src/writer.rs:462-468) and
    ``QueryBuilder::by_vector`` (src/reader.rs:133-138).
    """

    def __init__(self, expected: int, received: int):
        self.expected = expected
        self.received = received
        super().__init__(f"Invalid vector dimensions. Got {received} but expected {expected}")


class InvalidItemAppend(HannoyError):
    """Item id outside the supported u32 range."""

    def __init__(self, item):
        self.item = item
        super().__init__(f"Item id {item!r} must be an integer in [0, 2**32)")


class UnmatchingDistance(HannoyError):
    """Index was built with one metric but opened with another.

    Reference: ``Error::UnmatchingDistance``, raised by ``Reader::open``
    (src/reader.rs:400-405).
    """

    def __init__(self, expected: str, received: str):
        self.expected = expected
        self.received = received
        super().__init__(
            f"The distance provided to the reader is {received} but the index was built with {expected}"
        )


class UnknownVersion(HannoyError):
    """Database was written by an incompatible (newer) format version.

    Reference: ``Error::UnknownVersion`` (src/version.rs).
    """

    def __init__(self, version, current):
        self.version = version
        self.current = current
        super().__init__(f"Unknown database version {version}; this build supports <= {current}")


class DatabaseFull(StoreError):
    """The host store hit its configured ``map_size`` budget (LMDB analogue)."""

    def __init__(self):
        super().__init__("The database is full; grow env_size/map_size")
