"""Build progress reporting — the ``steppe`` analogue.

Reference: the hannoy crate's ``src/progress.rs:3-16`` — an enum of 8 named
build phases plus an atomic per-item counter, injectable via
``HannoyBuilder::progress`` (writer.rs:117-143). Here a progress sink is any
object with ``update(step)``; builds call it between device waves.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class BuildStep(enum.Enum):
    """Named build phases (reference ``HannoyBuild`` enum)."""

    RETRIEVE_THE_UPDATED_ITEMS = "retrieve_the_updated_items"
    RESOLVE_GRAPH_ENTRY_POINTS = "resolve_graph_entry_points"
    BUILDING_THE_GRAPH = "building_the_graph"
    PATCH_OLD_NEW_DELETED_LINKS = "patch_old_new_deleted_links"
    WRITING_THE_ITEMS = "writing_the_items"
    DELETING_THE_LINKS = "deleting_the_links"
    WRITE_THE_METADATA = "write_the_metadata"
    CONVERTING_FOREIGN_INDEX = "converting_foreign_index"


@dataclass
class InsertItemsStep:
    """Per-item insertion progress (reference ``AtomicInsertItemsStep``)."""

    current: int
    total: int


class NoProgress:
    """Silent sink (reference ``steppe::NoProgress``)."""

    def update(self, step) -> None:  # noqa: D102
        pass


class CallbackProgress:
    """Adapts a user callable into a progress sink."""

    def __init__(self, fn):
        self._fn = fn

    def update(self, step) -> None:
        self._fn(step)
