"""The HNSW index model: host mirror (numpy) + device tensors (torch).

Counterpart of ``hannoy_tpu/models/hnsw.py``:

* item vectors → one ``[N_pad, D]`` f32 tensor plus a ``[N_pad]`` norm
  header;
* link rows → fixed-width ``int32`` neighbor tables with sentinel ``-1``:
  layer 0 is slot-indexed ``[N_pad, M0]``; upper layers are compact
  ``[L, U_pad, M]`` tables plus a per-level ``slot → row`` map;
* item ids are arbitrary ``u32``; device tensors are indexed by dense
  *slots*, and the host keeps ``ids[slot]`` and the ``id → slot`` map.

Link distances are cached beside ids (``dists0``/``upper_dists``) during
builds. Unlike the JAX package, ``from_device`` keeps them in f32.

Not ported yet (ROADMAP.md queue 1): ``HostGraph.load``/``flush_links``
(the store), slot release and ``permute*``, and the bf16/int8 storage
tiers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import codecs, distances

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

    vectors: torch.Tensor  # [N_pad, D] f32
    norms: torch.Tensor  # [N_pad] f32
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
    ``DeviceGraph``)."""
    return DeviceGraph(
        vectors=_t(np.asarray(vectors, dtype=np.float32), device),
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


def to_device(g: HostGraph, device, serve_only: bool = False) -> DeviceGraph:
    """Copy a host graph into device tensors on ``device`` (raw f32 rows).

    ``serve_only``: search never reads link distances, so readers upload
    ``[1, 1]`` placeholders for ``dists0``/``upper_dists``.
    """
    distances.check_supported(g.metric)
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
    if serve_only:
        dists0, ud = np.zeros((1, 1), np.float32), np.zeros((1, 1, 1), np.float32)
    else:
        dists0 = g.dists0
    return device_graph_from_arrays(
        device,
        vectors=g.vectors,
        norms=g.norms,
        links0=g.links0,
        dists0=dists0,
        upper_links=up,
        upper_dists=ud,
        slot_rows=sr,
        entry_slots=eps,
        valid=g.valid_mask(),
        metric_name=g.metric.name,
        max_level=g.max_level,
    )


def from_device(g: HostGraph, dev: DeviceGraph) -> None:
    """Copy the link tables of ``dev`` back into the host mirror (builders
    sync before the host reads them). Distances stay f32."""
    g.links0 = dev.links0[:, : g.m0].cpu().numpy().copy()
    g.dists0 = dev.dists0[:, : g.m0].cpu().numpy().copy()
    up = dev.upper_links.cpu().numpy()
    ud = dev.upper_dists.cpu().numpy()
    for l in range(up.shape[0]):
        rows = g.upper_links[l].shape[0]
        g.upper_links[l] = up[l, :rows].copy()
        g.upper_dists[l] = ud[l, :rows].copy()
