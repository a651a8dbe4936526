"""User-facing API: Database / Writer / Reader / Metric.

Counterpart of ``hannoy_tpu/api.py``, which mirrors both layers of the
reference's public surface:

* the PyO3 module (``src/python.rs``, stubs in ``hannoy.pyi``):
  ``Database(path, distance, name, env_size)``, ``db.writer(dimensions,
  index, m, ef)`` as a context manager whose ``__exit__`` builds and
  commits, ``db.reader(index)``, ``reader.by_vec(q, n, ef_search)``,
  ``commit_rw_txn``/``abort_rw_txn``, a shared lazily-opened write
  transaction (python.rs:409-417);
* the Rust library (``src/writer.rs``, ``src/reader.rs``): ``add_item`` /
  ``del_item`` / ``clear`` / ``need_build`` / ``contains_item`` /
  ``item_vector`` / ``iter`` / builder options (``ef_construction``,
  ``alpha``, ``cancel``, ``progress``) / ``force_rebuild``, and the
  ``Reader.nns(count)`` QueryBuilder (``ef_search``, ``candidates``,
  ``linear_below``, ``by_vector(s)``, ``by_item(s)``, and their
  ``*_with_cancellation`` variants, which return partial results).

The on-disk store is the JAX package's, byte for byte: a directory written
by either package opens in the other.

A ``Database`` carries the device its Writers build on and its Readers
serve from (``device="cuda"`` unless the caller says otherwise; nothing
probes for a card), and the storage tier its rows are held in there
(``tier="raw"`` f32, ``"bf16"`` or ``"int8"``; files on disk do not depend
on it). Readers hold the index in device memory and answer
batched queries (``by_vecs``); single-query calls are a batch of one, and
each search brings its result to the host in one transfer.

A search's ``cancel`` closure is checked before it starts, wherever the
device loops come back to the host, and once more after them (the JAX
package's rule): once it has returned True the search stops, and every
row holds what its pool held then (``did_cancel``). A build's closure
(``HannoyBuilder.cancel``) raises ``BuildCancelled``; the transaction can
then be aborted. A build works on a fork of the committed graph, so the
half-built one is dropped and the committed one stays as it was.
"""

from __future__ import annotations

import enum
import os
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .build import builder as _builder
from .build import wave_ops
from .errors import (
    InvalidConfig,
    InvalidItemAppend,
    InvalidVecDimension,
    MissingMetadata,
    NeedBuild,
    UnknownVersion,
    UnmatchingDistance,
)
from .models import hnsw as _hnsw
from .models.flat import flat_topk
from .models.hnsw import HostGraph
from .ops import beam as _beam
from .ops import codecs, distances
from .store import schema
from .store.native_env import open_env
from .store.schema import (
    Key,
    Metadata,
    NodeMode,
    Prefix,
    UpdateStatus,
    decode_item,
    decode_links,
    decode_version,
    encode_item,
    encode_update_status,
    encode_version,
)
from .utils.idset import IdSet
from .utils.progress import BuildStep
from .utils.stats import BuildStats
from .utils.tracing import span
from .version import CURRENT_VERSION

DEFAULT_ENV_SIZE = 1024 * 1024 * 1024  # 1 GiB (python.rs:15)
DEFAULT_EF_SEARCH = 100  # reader.rs:23
DEFAULT_LINEAR_SCAN_THRESHOLD = 1000  # reader.rs:29
DEFAULT_LINEAR_SCAN_THRESHOLD_RATIO = 1.0  # reader.rs:32


class Metric(enum.Enum):
    """Distance metrics (reference ``PyDistance``, python.rs:25-56); the
    ``Metadata.distance`` strings are the JAX package's."""

    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    MANHATTAN = "manhattan"
    BQ_COSINE = "bq_cosine"
    BQ_EUCLIDEAN = "bq_euclidean"
    BQ_MANHATTAN = "bq_manhattan"
    HAMMING = "hamming"

    def __str__(self) -> str:
        return self.value

    @property
    def distance(self) -> distances.Metric:
        return _METRIC_MAP[self]


_METRIC_MAP = {
    Metric.COSINE: distances.COSINE,
    Metric.EUCLIDEAN: distances.EUCLIDEAN,
    Metric.MANHATTAN: distances.MANHATTAN,
    Metric.BQ_COSINE: distances.BQ_COSINE,
    Metric.BQ_EUCLIDEAN: distances.BQ_EUCLIDEAN,
    Metric.BQ_MANHATTAN: distances.BQ_MANHATTAN,
    Metric.HAMMING: distances.HAMMING,
}

# one Env per path, process-wide (reference ENV OnceCell, python.rs:18)
_ENVS: dict = {}
_ENVS_LOCK = threading.Lock()


def _shared_env(path: str, map_size: int, readonly: bool = False, backend: str = "native"):
    key = os.path.realpath(path) + ("//ro" if readonly else "")
    with _ENVS_LOCK:
        env = _ENVS.get(key)
        if env is None:
            env = open_env(path, map_size, backend=backend, readonly=readonly)
            env._graph_cache = {}  # {(name, index): _CachedGraph}
            env._shared_wtxn = None
            env._registry_key = key
            env._backend = backend
            _ENVS[key] = env
        elif env._backend != backend:
            raise ValueError(
                f"{path} is already open in this process with the {env._backend!r} store backend"
            )
        return env


class _CachedGraph(NamedTuple):
    """A graph held in memory for one index: the committed one in
    ``env._graph_cache``, or a write transaction's own in
    ``_pending_graphs`` until its commit stamps the generation."""

    gen: Optional[int]
    graph: HostGraph
    #: the tier its link distances were computed under; None when they are
    #: unknown (a Reader's ``HostGraph.load`` leaves them NaN)
    dists_tier: Optional[str]


def _validate_m(m: int, m0: int) -> None:
    """Metadata persists m/m0 (and max_level) as u8 — reject configs that
    would overflow after an expensive build rather than at write time."""
    if not (1 <= m <= 255):
        raise InvalidConfig(f"m must be in [1, 255], got {m}")
    if not (m <= m0 <= 255):
        raise InvalidConfig(f"m0 must be in [m, 255], got m0={m0} (m={m})")


@dataclass
class Searched:
    """Search result container (reference ``Searched``, reader.rs:36-57).

    ``truncated``: True when the layer-0 beam hit its bounded iteration cap
    (``max_iters``, 2*ef+16) while this row was still improving, before the
    reference's natural termination condition (best unexpanded > worst
    pooled); callers can retry with a larger ``ef_search``. Results are
    still valid nearest-so-far (and the degraded top-up has already run).
    ``did_cancel``: the search's cancel closure fired; the row holds the
    live items its search had found by then, sorted, with no top-up."""

    nns: list[tuple[int, float]]
    did_cancel: bool = False
    truncated: bool = False

    def into_nns(self) -> list[tuple[int, float]]:
        return self.nns


class Database:
    """A persistent vector database (reference ``PyDatabase``).

    One shared write transaction per environment is opened lazily by any
    Writer operation and lives until ``commit_rw_txn``/``abort_rw_txn`` —
    the Writer context manager commits on exit (python.rs:305-314).
    """

    def __init__(
        self,
        path: str | os.PathLike,
        distance: Metric = Metric.EUCLIDEAN,
        name: Optional[str] = None,
        env_size: Optional[int] = None,
        readonly: bool = False,
        map_size: Optional[int] = None,
        *,
        backend: str = "native",
        device: str | torch.device = "cuda",
        tier: str = "raw",
    ):
        """``device``: where this database's Writers build and its Readers
        serve (``"cuda"`` by default; pass ``"cpu"`` to run without a card).

        ``tier``: how the rows of an f32 metric are held on the device, by
        Writers (builds run on the tier's distances) and Readers alike:
        ``"raw"`` f32, ``"bf16"`` or ``"int8"`` (``models.hnsw.to_device``).
        Packed metrics ignore it; the store always keeps f32 rows.

        ``backend``: the store engine, ``"native"`` (C++, built with g++ at
        first use) or ``"python"``; both write the same files.

        ``readonly=True`` opens a lock-free consistent snapshot that
        coexists with a live writer in ANOTHER process (LMDB's concurrent
        readers, reference README.md:13 + parallel.rs:19-31): Readers work,
        any write raises, and ``refresh()`` adopts commits made since open."""
        if tier not in _hnsw.TIERS:
            raise InvalidConfig(f"tier must be one of {_hnsw.TIERS}, got {tier!r}")
        self._device = torch.device(device)
        self._tier = tier
        self._env = _shared_env(
            str(path), map_size or env_size or DEFAULT_ENV_SIZE, readonly=readonly, backend=backend
        )
        self._db = self._env.create_database(None, name)
        self._metric = distance
        self.readonly = readonly

    def refresh(self) -> bool:
        """Read-only databases: re-snapshot the store to see later commits
        (returns True when anything changed). No-op on writable handles —
        they always see their own environment's latest generation."""
        if not self.readonly:
            return False
        changed = self._env.refresh()
        if changed:
            self._env._graph_cache.clear()
        return changed

    # -- transactions --------------------------------------------------
    def _wtxn(self):
        if self._env._shared_wtxn is None or not self._env._shared_wtxn.active:
            self._env._shared_wtxn = self._env.write_txn()
        return self._env._shared_wtxn

    def commit_rw_txn(self) -> bool:
        txn = self._env._shared_wtxn
        if txn is not None and txn.active:
            with span("store_commit") as sp:
                txn.commit()
                if sp.recording:
                    sp.set(**self._env.last_commit_stats())
                self._env._shared_wtxn = None
                # stamp pending built graphs with the new generation
                for key, entry in getattr(txn, "_pending_graphs", {}).items():
                    self._env._graph_cache[key] = entry._replace(gen=self._env._gen.gen_id)
            return True
        return False

    def abort_rw_txn(self) -> bool:
        txn = self._env._shared_wtxn
        if txn is not None and txn.active:
            txn.abort()
            self._env._shared_wtxn = None
            return True
        return False

    def close(self) -> None:
        """Close the underlying environment: abort any uncommitted shared
        write transaction, flush the store (snapshot sidecar refresh) and
        release the process lock. Environments are shared per path
        (python.rs:18 OnceCell analogue), so every Database handle on this
        path becomes invalid; construct a new Database to reopen."""
        key = getattr(self._env, "_registry_key", os.path.realpath(self._env.path))
        with _ENVS_LOCK:
            # evict only on identity match: a stale handle's second close()
            # (or closing an old handle after the path was reopened) must
            # not evict a *different, live* env from the registry
            if _ENVS.get(key) is self._env:
                _ENVS.pop(key)
            elif getattr(self._env, "_closed", False):
                return  # already closed via another handle
        self.abort_rw_txn()
        self._env._closed = True
        self._env.close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- handles ---------------------------------------------------------
    def writer(
        self,
        dimensions: int,
        index: int = 0,
        m: int = 16,
        ef: int = 96,
        m0: Optional[int] = None,
    ) -> "Writer":
        """Get a writer (python.rs:119-151; m0 defaults to 2*m)."""
        return Writer(self, index, dimensions, m=m, m0=m0 or 2 * m, ef_construction=ef)

    def reader(self, index: int = 0) -> "Reader":
        return Reader.open(self, index)

    @property
    def metric(self) -> Metric:
        return self._metric

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def tier(self) -> str:
        return self._tier

    def _with_metric(self, metric: Metric) -> "Database":
        """A handle on the same environment, device and tier under another
        metric (``Writer.prepare_changing_distance``)."""
        other = Database.__new__(Database)
        other.__dict__.update(self.__dict__)
        other._metric = metric
        return other


class HannoyBuilder:
    """Fluent build configuration (reference ``HannoyBuilder``,
    writer.rs:27-259)."""

    def __init__(self, writer: "Writer", seed: int = 42):
        self._writer = writer
        self._opts = _builder.BuildOptions(seed=seed)
        self._opts.ef_construction = writer._ef_construction

    def ef_construction(self, ef: int) -> "HannoyBuilder":
        self._opts.ef_construction = ef
        return self

    def alpha(self, alpha: float) -> "HannoyBuilder":
        self._opts.alpha = alpha
        return self

    def cancel(self, fn: Callable[[], bool]) -> "HannoyBuilder":
        """Build cancellation: ``fn`` is checked throughout the build, which
        raises ``BuildCancelled`` once it returns True."""
        self._opts.cancel = fn
        return self

    def progress(self, sink) -> "HannoyBuilder":
        self._opts.progress = sink
        return self

    def wave_size(self, w: int) -> "HannoyBuilder":
        self._opts.wave_size = w
        return self

    def bulk(self, enabled: Optional[bool]) -> "HannoyBuilder":
        """Force the cluster-blocked fresh-build path on/off
        (None = auto — large fresh builds of every metric but f32
        manhattan use it; see build/bulk.py)."""
        self._opts.bulk = enabled
        return self

    def available_memory(self, nbytes: int) -> "HannoyBuilder":
        """Accepted for API parity; the reference carries this option but
        never consumes it either (writer.rs:61-65 comments it out of the
        public surface, BuildOption.available_memory stays None)."""
        return self

    def build(self, m: Optional[int] = None, m0: Optional[int] = None) -> BuildStats:
        return self._writer._build(self._opts, m=m, m0=m0)

    def force_rebuild(self, m: Optional[int] = None, m0: Optional[int] = None) -> BuildStats:
        return self._writer._force_rebuild(self._opts, m=m, m0=m0)


@dataclass
class _BuildPlan:
    """Staged state between a build's prologue (journal scan + set algebra
    + graph staging, writer.rs:521-554) and its epilogue (link deletion +
    flush + metadata, writer.rs:577-600)."""

    g: HostGraph
    metadata: Optional[Metadata]
    item_indices: IdSet
    to_delete: IdSet
    insert_slots: np.ndarray
    delete_slots: np.ndarray
    #: the build starts from a graph held in memory, not one loaded from the store
    graph_reused: bool

    @property
    def built(self) -> bool:
        return bool(len(self.insert_slots) or len(self.delete_slots))


class Writer:
    """Item CRUD + build orchestration (reference ``Writer``,
    writer.rs:275-718)."""

    def __init__(
        self,
        database: Database,
        index: int,
        dimensions: int,
        m: int = 16,
        m0: int = 32,
        ef_construction: int = 96,
    ):
        _validate_m(m, m0)
        if dimensions < 1:
            raise InvalidConfig(f"dimensions must be >= 1, got {dimensions}")
        self._database = database
        self._index = index
        self._dimensions = dimensions
        self._m = m
        self._m0 = m0
        self._ef_construction = ef_construction
        self._metric = database.metric.distance

    # -- context manager (python.rs:300-314) --------------------------------
    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.builder(seed=42).build()
            self._database.commit_rw_txn()
        else:
            self._database.abort_rw_txn()

    # -- CRUD ---------------------------------------------------------------
    @staticmethod
    def _staging(wtxn) -> dict:
        """Per-txn decoded-row cache: (index, item) → (packed_row, norm).

        Values mirror what was just written to the store in this txn;
        ``_build`` consults it before issuing per-item store reads. Dies
        with the txn (commit or abort) — durability still flows through
        the store alone."""
        staged = getattr(wtxn, "_staged_rows", None)
        if staged is None:
            staged = wtxn._staged_rows = {}
        return staged

    def _purge_staging(self, wtxn) -> None:
        staged = self._staging(wtxn)
        for key in [k for k in staged if k[0] == self._index]:
            staged.pop(key)
        self._staging_cols(wtxn).pop(self._index, None)

    @staticmethod
    def _staging_cols(wtxn) -> dict:
        """Columnar twin of ``_staging``: index → list of
        (items u32 [n], packed rows [n, W], norms [n]) batches, appended
        by ``add_items`` in txn order. ``_build`` stages a fresh build's
        vectors with one concatenate+gather instead of a dict lookup per
        item; last write wins for re-added items, and deleted items are
        never consulted (they are excluded from ``to_insert``)."""
        cols = getattr(wtxn, "_staged_cols", None)
        if cols is None:
            cols = wtxn._staged_cols = {}
        return cols

    def add_item(self, item: int, vector: Sequence[float]) -> None:
        """Store a vector + journal stone (writer.rs:462-480)."""
        if not (isinstance(item, (int, np.integer)) and 0 <= int(item) < 2**32):
            raise InvalidItemAppend(item)
        vec = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vec.shape[0] != self._dimensions:
            raise InvalidVecDimension(self._dimensions, vec.shape[0])
        packed = codecs.pack(vec[None, :], self._metric.codec)
        norm = distances.np_norms(self._metric, packed)[0]
        wtxn = self._database._wtxn()
        db = self._database._db
        header = struct.pack("<f", float(norm))
        db.put(
            wtxn,
            Key.item(self._index, int(item)).to_bytes(),
            encode_item(header, codecs.vector_to_bytes(vec, self._metric.codec)),
        )
        db.put(
            wtxn,
            Key.updated(self._index, int(item)).to_bytes(),
            encode_update_status(UpdateStatus.UPDATED),
        )
        self._staging(wtxn)[(self._index, int(item))] = (packed[0], float(norm))

    def add_items(self, items: Sequence[int], vectors: np.ndarray) -> None:
        """Batched insert — the bulk staging path.

        Records are assembled with the vectorized schema codecs
        (``keys_bytes``/``items_payload`` — byte-identical to the
        per-record ``Key.to_bytes``/``encode_item``) and written through
        one ``put_many_raw`` call per table; the only per-item Python is
        the fill of the decoded-row cache at the end."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self._dimensions:
            raise InvalidVecDimension(self._dimensions, vectors.shape[-1])
        items_arr = np.asarray(items if isinstance(items, np.ndarray) else list(items))
        if len(items_arr) and (items_arr.min(initial=0) < 0 or items_arr.max(initial=0) >= 2**32):
            bad = items_arr[(items_arr < 0) | (items_arr >= 2**32)][0]
            raise InvalidItemAppend(int(bad))
        items_arr = items_arr.astype(np.uint32)
        packed = codecs.pack(vectors, self._metric.codec)
        norms = distances.np_norms(self._metric, packed)
        wtxn = self._database._wtxn()
        db = self._database._db
        codec = self._metric.codec
        staged = self._staging(wtxn)

        n = len(items_arr)
        headers = norms.astype("<f4").view(np.uint8).reshape(n, 4)
        rows = np.ascontiguousarray(
            packed.astype("<f4" if codec == codecs.F32 else "<u4")
        ).view(np.uint8).reshape(n, -1)
        vbuf, offs = schema.items_payload(headers, rows)
        item_keys = schema.keys_bytes(self._index, NodeMode.ITEM, items_arr)
        db.put_many_raw(wtxn, item_keys.tobytes(), vbuf, offs)

        stone = encode_update_status(UpdateStatus.UPDATED)
        stones = np.frombuffer(stone, dtype=np.uint8)
        svbuf = np.broadcast_to(stones, (n, len(stone))).tobytes()
        soffs = (np.arange(n + 1, dtype=np.uint64) * len(stone)).astype(np.uint64)
        upd_keys = schema.keys_bytes(self._index, NodeMode.UPDATED, items_arr)
        db.put_many_raw(wtxn, upd_keys.tobytes(), svbuf, soffs)

        # decoded-row fast path for the next build in this txn, which would
        # otherwise re-read every value through the store
        idx = self._index
        for i, item in enumerate(items_arr.tolist()):
            staged[(idx, item)] = (packed[i], float(norms[i]))
        self._staging_cols(wtxn).setdefault(idx, []).append((items_arr, packed, norms))

    def del_item(self, item: int) -> bool:
        """Delete + journal stone; True if it existed (writer.rs:483-495).
        The next build unlinks the item: every row that linked it is
        repaired through its neighbours' rows, then its links are dropped."""
        wtxn = self._database._wtxn()
        db = self._database._db
        self._staging(wtxn).pop((self._index, int(item)), None)
        if db.delete(wtxn, Key.item(self._index, int(item)).to_bytes()):
            db.put(
                wtxn,
                Key.updated(self._index, int(item)).to_bytes(),
                encode_update_status(UpdateStatus.REMOVED),
            )
            return True
        return False

    def clear(self) -> None:
        """Remove everything for this index (writer.rs:498-511).

        On the native backend the whole index range is dropped with one
        vectorized key scan + one batched tombstone call."""
        wtxn = self._database._wtxn()
        db = self._database._db
        if hasattr(db, "scan_keys") and hasattr(db, "delete_many"):
            keys_u64 = db.scan_keys(wtxn, Prefix.all(self._index))
            if len(keys_u64):
                db.delete_many(wtxn, keys_u64)
        else:
            for key, _ in list(db.prefix_iter(wtxn, Prefix.all(self._index))):
                db.delete(wtxn, key)
        self._purge_staging(wtxn)
        self._drop_graphs()

    # -- introspection --------------------------------------------------
    def need_build(self) -> bool:
        """Journal non-empty or never built (writer.rs:423-436)."""
        txn = self._database._wtxn()
        db = self._database._db
        if next(iter(db.prefix_iter(txn, Prefix.updated(self._index))), None) is not None:
            return True
        return db.get(txn, Key.metadata(self._index).to_bytes()) is None

    def contains_item(self, item: int) -> bool:
        txn = self._database._wtxn()
        return self._database._db.get(txn, Key.item(self._index, int(item)).to_bytes()) is not None

    def item_vector(self, item: int) -> Optional[list[float]]:
        txn = self._database._wtxn()
        return _get_item_vector(
            self._database._db, txn, self._index, int(item), self._metric, self._dimensions
        )

    def iter(self) -> Iterator[tuple[int, list[float]]]:
        txn = self._database._wtxn()
        return _item_iter(self._database._db, txn, self._index, self._metric, self._dimensions)

    def is_empty(self) -> bool:
        return next(self.iter(), None) is None

    # -- building ---------------------------------------------------------
    def builder(self, seed: int = 42) -> HannoyBuilder:
        return HannoyBuilder(self, seed=seed)

    def build(self, **kw) -> BuildStats:
        return self.builder().build(**kw)

    @property
    def _cache_key(self):
        return (self._database._db.name, self._index)

    def _load_or_cached_graph(
        self, wtxn, metadata: Optional[Metadata], deleted_items: IdSet
    ) -> tuple[HostGraph, bool, bool]:
        """The graph a build starts from → ``(graph, reused, dists_known)``.

        A second build in one transaction takes the transaction's own graph.
        Otherwise the build forks the graph this process committed last
        (``HostGraph.fork``: the cache entry, which Readers serve, is never
        built on) when that graph is the transaction's base generation, and
        the journal deletes none of its items: ``HostGraph.load`` gives a
        deleted item a ghost slot (zero vector, links kept) that the
        deletion repair reads. Either graph must have the Writer's metric,
        ``m`` and ``m0``, and link distances of the Database's tier or
        unknown (``dists_known`` False: a Reader's load; the prologue fills
        them). Else the graph is loaded from the store, or starts empty."""
        env = self._database._env
        entry = getattr(wtxn, "_pending_graphs", {}).get(self._cache_key)
        fork = entry is None
        if fork:
            entry = env._graph_cache.get(self._cache_key)
            if entry is not None and (
                entry.gen != env._gen.gen_id
                or any(int(i) in entry.graph.id_to_slot for i in deleted_items)
            ):
                entry = None
        if (
            entry is not None
            and entry.graph.metric.name == self._metric.name
            and entry.graph.m == self._m
            and entry.graph.m0 == self._m0
            and entry.dists_tier in (None, self._database._tier)
        ):
            g = entry.graph
            if fork:
                with span("fork_graph", items=len(g.id_to_slot)):
                    g = g.fork()
            return g, True, entry.dists_tier is not None
        if metadata is None:
            return HostGraph.empty(self._metric, self._dimensions, self._m, self._m0), False, True
        md = Metadata(
            dimensions=metadata.dimensions,
            items=metadata.items,
            distance=metadata.distance,
            entry_points=metadata.entry_points,
            max_level=metadata.max_level,
            m=self._m,
            m0=self._m0,
        )
        with span("load_graph", items=len(metadata.items)):
            g = HostGraph.load(self._database._db, wtxn, self._index, self._metric, md)
        if len(metadata.items):
            # persisted rows carry ids only
            self._fill_link_dists(g)
        return g, False, True

    def _fill_link_dists(self, g: HostGraph) -> None:
        """Recompute every link's distance on the device, under the
        Database's tier, into the host mirror ``g``."""
        with span("load_to_device"):
            dev = _hnsw.to_device(g, self._database._device, tier=self._database._tier)
        with span("fill_link_dists"):
            dev = wave_ops.fill_link_dists(dev, g)
        with span("load_from_device"):
            _hnsw.from_device(g, dev)

    def _build(self, opts: _builder.BuildOptions, m=None, m0=None) -> BuildStats:
        try:
            with span("build_prologue") as sp:
                plan = self._build_prologue(opts, m=m, m0=m0)
                sp.set(graph_reused=int(plan.graph_reused))
            stats = BuildStats()

            # 4. device build
            if plan.built:
                with span(
                    "build_graph",
                    inserts=len(plan.insert_slots),
                    deletes=len(plan.delete_slots),
                ) as sp:
                    _builder.build_graph(
                        plan.g, plan.insert_slots, plan.delete_slots, opts, stats,
                        device=self._database._device, tier=self._database._tier,
                    )
                    sp.set(waves=stats.waves)

            with span("build_epilogue"):
                return self._build_epilogue(plan, opts, stats)
        except BaseException:
            self._forget_graph()
            raise

    def _drop_graphs(self) -> None:
        """Drop this index's committed graph and the transaction's own: the
        store no longer holds what either graph does (``clear``, a rebuild,
        a conversion), so the next build and ``Reader.open`` must not start
        from them, nor the commit keep the transaction's."""
        self._database._env._graph_cache.pop(self._cache_key, None)
        self._forget_graph()

    def _forget_graph(self) -> None:
        """Drop this index's graph from the transaction: a build that raised
        (``BuildCancelled``) left it half-built. The committed graph in the
        cache is never built on (a build forks it), so it stays."""
        txn = self._database._env._shared_wtxn
        getattr(txn, "_pending_graphs", {}).pop(self._cache_key, None)

    def _build_prologue(self, opts: _builder.BuildOptions, m=None, m0=None) -> "_BuildPlan":
        """Steps 1-3 of a build: journal scan, set algebra, graph staging."""
        if m is not None:
            self._m = m
            self._m0 = m0 or 2 * m
        wtxn = self._database._wtxn()
        db = self._database._db

        # 1. journal scan + clear (writer.rs:645-688). Stones are 1-byte
        # fixed-width records, so the whole journal is scanned into numpy
        # (keys = u64 big-endian ints; the item id is bits 8..40 of the
        # key, schema._KEY_FMT) and cleared with one batched tombstone
        # call.
        opts.progress.update(BuildStep.RETRIEVE_THE_UPDATED_ITEMS)
        keys_u64, stone_rows = db.scan_fixed(wtxn, Prefix.updated(self._index), 1)
        items_u = ((keys_u64 >> np.uint64(8)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        removed = stone_rows[:, 0] == int(UpdateStatus.REMOVED)
        db.delete_many(wtxn, keys_u64)
        updated_items = IdSet(items_u)
        deleted_items = IdSet(items_u[removed])

        # 2. set algebra (writer.rs:539-554)
        md_bytes = db.get(wtxn, Key.metadata(self._index).to_bytes())
        metadata = Metadata.from_bytes(md_bytes) if md_bytes else None
        indexed = metadata.items if metadata else IdSet()
        item_indices = ((updated_items - deleted_items) | indexed) - deleted_items
        to_delete = updated_items - item_indices
        to_insert = item_indices & updated_items

        # 3. stage graph — staged decoded rows (add_item/add_items in this
        # txn) skip the per-item store read; only items journaled by an
        # earlier txn fall back to db.get
        g, reused, dists_known = self._load_or_cached_graph(wtxn, metadata, deleted_items)
        g.grow(_hnsw.slot_capacity(len(item_indices)))
        staged = self._staging(wtxn)
        to_ins_arr = to_insert.to_array()  # sorted u32 — IdSet iteration order
        n_ins = len(to_ins_arr)
        # an item the graph holds that comes back with a new vector: rows
        # that link it keep the old vector's distance
        rewritten = reused and any(int(i) in g.id_to_slot for i in to_ins_arr.tolist())

        # slot allocation: one arange for the fresh-graph case, per-item
        # otherwise (free-list / existing-id reuse)
        if not g.id_to_slot and not g.free_slots and g.next_fresh == 0:
            insert_slots = np.arange(n_ins, dtype=np.int64)
            g.ids[insert_slots] = to_ins_arr
            g.id_to_slot = {int(i): s for s, i in enumerate(to_ins_arr.tolist())}
            g.next_fresh = n_ins
        else:
            insert_slots = np.empty(n_ins, dtype=np.int64)
            for i, item in enumerate(to_ins_arr.tolist()):
                insert_slots[i] = g.alloc_slot(int(item))

        # vectors: one gather from the columnar staging for everything
        # added in this txn; per-item fallback (dict staging, then store
        # read) only for items journaled by an earlier txn
        filled = np.zeros(n_ins, dtype=bool)
        cols = self._staging_cols(wtxn).get(self._index)
        if cols and n_ins and sum(len(c[0]) for c in cols):
            items_c = np.concatenate([c[0] for c in cols])
            rows_c = np.concatenate([c[1] for c in cols], axis=0)
            norms_c = np.concatenate([c[2] for c in cols])
            rev = items_c[::-1]
            uniq, first_rev = np.unique(rev, return_index=True)
            src = len(items_c) - 1 - first_rev  # last write wins
            pos = np.minimum(np.searchsorted(uniq, to_ins_arr), len(uniq) - 1)
            hit = uniq[pos] == to_ins_arr
            take = src[pos[hit]]
            g.set_rows(insert_slots[hit], rows_c[take], norms_c[take])
            filled[hit] = True
        rest = np.nonzero(~filled)[0]
        if len(rest):
            rows, norms = [], []
            for item in to_ins_arr[rest].tolist():
                row = staged.get((self._index, item))
                if row is None:
                    header, vecb = decode_item(db.get(wtxn, Key.item(self._index, item).to_bytes()))
                    row = (codecs.vector_from_bytes(vecb, self._metric.codec), struct.unpack("<f", header)[0])
                rows.append(row[0])
                norms.append(row[1])
            g.set_rows(insert_slots[rest], np.stack(rows), np.asarray(norms, dtype=np.float32))
        if reused and (rewritten or not dists_known):
            # as the load path does, on the rows staged above
            self._fill_link_dists(g)
        delete_slots = np.asarray(
            [g.id_to_slot[int(i)] for i in to_delete if int(i) in g.id_to_slot],
            dtype=np.int64,
        )
        return _BuildPlan(
            g=g,
            metadata=metadata,
            item_indices=item_indices,
            to_delete=to_delete,
            insert_slots=insert_slots,
            delete_slots=delete_slots,
            graph_reused=reused,
        )

    def _build_epilogue(
        self, plan: "_BuildPlan", opts: _builder.BuildOptions, stats: BuildStats
    ) -> BuildStats:
        """Steps 5-6 of a build: delete removed links, flush, metadata."""
        wtxn = self._database._wtxn()
        db = self._database._db
        g = plan.g
        metadata = plan.metadata
        to_delete = plan.to_delete

        # 5. delete links of removed items AFTER build (writer.rs:577-580),
        # by direct key: an item's links rows live at layers
        # 0..old max_level
        opts.progress.update(BuildStep.DELETING_THE_LINKS)
        if len(to_delete):
            old_max_level = metadata.max_level if metadata else 0
            for item in to_delete:
                for layer in range(old_max_level + 1):
                    db.delete(wtxn, Key.links(self._index, int(item), layer).to_bytes())
        for s in plan.delete_slots:
            g.release_slot(int(s))

        # 6. flush links + metadata + version (writer.rs:585-600)
        # Only rows the build touched are rewritten (hnsw.rs:192-213
        # flushes only the in-progress maps); an untouched large graph
        # costs nothing when a few items are appended.
        opts.progress.update(BuildStep.WRITING_THE_ITEMS)
        if plan.built:
            with span("flush_links", items=g.n_items, touched=len(stats.touched)):
                g.flush_links(db, wtxn, self._index, slots=stats.touched)
        opts.progress.update(BuildStep.WRITE_THE_METADATA)
        entry_ids = [int(g.ids[s]) for s in g.entry_slots]
        db.put(
            wtxn,
            Key.metadata(self._index).to_bytes(),
            Metadata(
                dimensions=self._dimensions,
                items=plan.item_indices,
                distance=self._metric.name,
                entry_points=entry_ids,
                max_level=g.max_level,
                m=self._m,
                m0=self._m0,
            ).to_bytes(),
        )
        db.put(wtxn, Key.version(self._index).to_bytes(), encode_version(CURRENT_VERSION))

        if not hasattr(wtxn, "_pending_graphs"):
            wtxn._pending_graphs = {}
        wtxn._pending_graphs[self._cache_key] = _CachedGraph(None, g, self._database._tier)
        stats.log()
        return stats

    def _force_rebuild(self, opts: _builder.BuildOptions, m=None, m0=None) -> BuildStats:
        """Drop all links and relink every indexed item (writer.rs:610-638)."""
        wtxn = self._database._wtxn()
        db = self._database._db
        md_bytes = db.get(wtxn, Key.metadata(self._index).to_bytes())
        if md_bytes is None:
            raise MissingMetadata(self._index)
        metadata = Metadata.from_bytes(md_bytes)
        for key, _ in list(db.prefix_iter(wtxn, Prefix.links(self._index))):
            db.delete(wtxn, key)
        for item in metadata.items:
            db.put(
                wtxn,
                Key.updated(self._index, int(item)).to_bytes(),
                encode_update_status(UpdateStatus.UPDATED),
            )
        self._drop_graphs()
        db.delete(wtxn, Key.metadata(self._index).to_bytes())
        return self._build(opts, m=m, m0=m0)

    def prepare_foreign_conversion(self) -> int:
        """Dumpless conversion of a foreign/legacy index sharing this key
        space (reference ``prepare_arroy_conversion``, writer.rs:292-354):
        keep every decodable item record with the right on-store width,
        journal it as Updated so the next build relinks it, and delete
        every other entry (stale links, foreign metadata, trees).

        Returns the number of items scheduled for (re)indexing.
        """
        wtxn = self._database._wtxn()
        db = self._database._db
        self._purge_staging(wtxn)
        codec = self._metric.codec
        on_disk = codecs.padded_dim(self._dimensions, codec)
        row_bytes = on_disk * 4 if codec == codecs.F32 else on_disk // 8
        n = 0
        for key, val in list(db.prefix_iter(wtxn, Prefix.all(self._index))):
            k = Key.from_bytes(key)
            keep = False
            if k.mode == NodeMode.ITEM:
                try:
                    _, vecb = decode_item(val)
                    keep = len(vecb) == row_bytes
                except Exception:
                    keep = False
            if keep:
                db.put(
                    wtxn,
                    Key.updated(self._index, k.item).to_bytes(),
                    encode_update_status(UpdateStatus.UPDATED),
                )
                n += 1
            else:
                db.delete(wtxn, key)
        self._drop_graphs()
        return n

    def prepare_changing_distance(self, new_metric: Metric) -> "Writer":
        """Re-own all items under a new metric (writer.rs:358-410); links
        survive only for the plain→binary-quantized fast path."""
        wtxn = self._database._wtxn()
        db = self._database._db
        self._purge_staging(wtxn)
        old = self._metric
        new = new_metric.distance
        if new.name != old.name:
            bq_fast_path = new.name == f"binary quantized {old.name}"
            if not bq_fast_path:
                for key, _ in list(db.prefix_iter(wtxn, Prefix.links(self._index))):
                    db.delete(wtxn, key)
                db.delete(wtxn, Key.metadata(self._index).to_bytes())
            for key, val in list(db.prefix_iter(wtxn, Prefix.item(self._index))):
                k = Key.from_bytes(key)
                _, vecb = decode_item(val)
                vec = codecs.unpack(
                    codecs.vector_from_bytes(vecb, old.codec)[None, :],
                    self._dimensions,
                    old.codec,
                )[0]
                packed = codecs.pack(vec[None, :], new.codec)
                norm = distances.np_norms(new, packed)[0]
                db.put(
                    wtxn,
                    key,
                    encode_item(
                        struct.pack("<f", float(norm)), codecs.vector_to_bytes(vec, new.codec)
                    ),
                )
                db.put(
                    wtxn,
                    Key.updated(self._index, k.item).to_bytes(),
                    encode_update_status(UpdateStatus.UPDATED),
                )
            self._drop_graphs()
        return Writer(
            self._database._with_metric(new_metric),
            self._index, self._dimensions, self._m, self._m0, self._ef_construction,
        )


class QueryBuilder:
    """Search options (reference ``QueryBuilder``, reader.rs:60-261)."""

    def __init__(self, reader: "Reader", count: int):
        self._reader = reader
        self._count = count
        self._ef = DEFAULT_EF_SEARCH
        self._candidates: Optional[IdSet] = None
        self._linear_below = DEFAULT_LINEAR_SCAN_THRESHOLD
        self._linear_below_ratio = DEFAULT_LINEAR_SCAN_THRESHOLD_RATIO
        self._ef_upper: Optional[int] = None

    def ef_search(self, ef: int) -> "QueryBuilder":
        self._ef = max(ef, self._count)
        return self

    def ef_upper(self, ef_upper: int) -> "QueryBuilder":
        """Width of the pooled layer-1 descent (an extension of both
        packages; the reference's walk_layer is always greedy ef=1,
        reader.rs:739-752). Default ``None`` = auto
        (``ops.beam.default_ef_upper``)."""
        self._ef_upper = max(1, int(ef_upper))
        return self

    def candidates(self, candidates) -> "QueryBuilder":
        """Only these item ids may be returned (a filter; the graph walk
        still passes through other items)."""
        self._candidates = candidates if isinstance(candidates, IdSet) else IdSet(candidates)
        return self

    def linear_below(self, threshold: int) -> "QueryBuilder":
        """Candidate sets smaller than this are answered by an exact scan."""
        self._linear_below = threshold
        return self

    def linear_below_ratio(self, ratio: float) -> "QueryBuilder":
        """... and only if they hold at most this share of the items."""
        if not 0.0 <= ratio <= 1.0:
            raise ValueError("linear scan threshold ratio must be between 0.0 and 1.0")
        self._linear_below_ratio = ratio
        return self

    def by_vector(self, vector: Sequence[float]) -> Searched:
        return self._reader._nns_by_vec(self, np.asarray(vector, dtype=np.float32))

    def by_vector_with_cancellation(self, vector: Sequence[float], cancel_fn: Callable[[], bool]) -> Searched:
        return self._reader._nns_by_vec(self, np.asarray(vector, dtype=np.float32), cancel_fn)

    def by_vectors(self, vectors) -> list[Searched]:
        """Batched search — every option (candidates filter, linear scan,
        ef) applies to each query exactly as the reference applies them
        per query (reader.rs:60-261); the batch rides one search on the
        device."""
        return self._reader._nns_by_vecs(self, np.asarray(vectors, dtype=np.float32))

    def by_vectors_with_cancellation(self, vectors, cancel_fn: Callable[[], bool]) -> list[Searched]:
        """``by_vectors`` with ``cancel_fn`` checked before the search,
        wherever its loops come back to the host, and after them; once it
        has returned True every row holds what its search had found then,
        with ``did_cancel=True`` (reader.rs:167-188 per query)."""
        return self._reader._nns_by_vecs(self, np.asarray(vectors, dtype=np.float32), cancel_fn)

    def by_item(self, item: int) -> Optional[Searched]:
        return self._reader._nns_by_item(self, int(item))

    def by_item_with_cancellation(self, item: int, cancel_fn: Callable[[], bool]) -> Optional[Searched]:
        return self._reader._nns_by_item(self, int(item), cancel_fn)

    def by_items(self, items) -> list[Optional[Searched]]:
        """Batched per-item lookup: each row runs the layer-0 beam seeded
        at its item's own slot, never returns the item itself, and honours
        every option; a missing item gives ``None`` at its position."""
        return self._reader._nns_by_items(self, items)

    def by_items_with_cancellation(self, items, cancel_fn: Callable[[], bool]) -> list[Optional[Searched]]:
        """``by_items`` with ``cancel_fn`` checked as in
        ``by_vectors_with_cancellation`` (reader.rs:263-280)."""
        return self._reader._nns_by_items(self, items, cancel_fn)


class Reader:
    """Query handle over a built index (reference ``Reader``,
    reader.rs:374-948). Holds its own read snapshot; the graph lives in
    the memory of the Database's device.
    """

    def __init__(self, database: Database, index: int, metadata: Metadata, version, graph):
        self._database = database
        self._index = index
        self._metadata = metadata
        self._version = version
        self._graph = graph
        # serve_only: readers never consult link distances — skip their upload
        with span("reader_to_device", items=len(metadata.items)):
            self._dev = _hnsw.to_device(graph, database._device, serve_only=True, tier=database._tier)
        self._rtxn = database._env.read_txn()
        self._metric = database.metric.distance

    @classmethod
    def open(cls, database: Database, index: int) -> "Reader":
        """Open + validate (reader.rs:387-431): metadata present, matching
        distance, clean journal."""
        with span("reader_open"):
            env = database._env
            rtxn = env.read_txn()
            db = database._db
            md_bytes = db.get(rtxn, Key.metadata(index).to_bytes())
            if md_bytes is None:
                raise MissingMetadata(index)
            metadata = Metadata.from_bytes(md_bytes)
            vb = db.get(rtxn, Key.version(index).to_bytes())
            version = decode_version(vb) if vb else None
            if version and version > CURRENT_VERSION:
                raise UnknownVersion(version, CURRENT_VERSION)
            metric = database.metric.distance
            if metric.name != metadata.distance:
                raise UnmatchingDistance(metadata.distance, metric.name)
            if next(iter(db.prefix_iter(rtxn, Prefix.updated(index))), None) is not None:
                raise NeedBuild(index)

            key = (db.name, index)
            cached = env._graph_cache.get(key)
            if cached is not None and cached.gen == env._gen.gen_id:
                graph = cached.graph
            else:
                with span("reader_load_graph", items=len(metadata.items)):
                    graph = HostGraph.load(db, rtxn, index, metric, metadata)
                env._graph_cache[key] = _CachedGraph(env._gen.gen_id, graph, None)
            return cls(database, index, metadata, version, graph)

    # -- introspection (reader.rs:545-606) ---------------------------------
    def dimensions(self) -> int:
        return self._metadata.dimensions

    def n_items(self) -> int:
        return len(self._metadata.items)

    def n_entrypoints(self) -> int:
        return len(self._metadata.entry_points)

    def item_ids(self) -> IdSet:
        return self._metadata.items

    def index(self) -> int:
        return self._index

    def version(self):
        return self._version

    def n_nodes(self) -> Optional[int]:
        """Total records in the store's key table — exactly the reference's
        ``database.len(rtxn)`` (reader.rs:576-578), which counts every
        record across *all* indexes sharing the database, not just this
        one. Use :meth:`n_items` for the per-index item count."""
        db = self._database._db
        n = db.len(self._rtxn)
        return int(n) or None

    def is_empty(self) -> bool:
        return len(self._metadata.items) == 0

    def contains_item(self, item: int) -> bool:
        return int(item) in self._metadata.items

    def item_vector(self, item: int) -> Optional[list[float]]:
        return _get_item_vector(
            self._database._db, self._rtxn, self._index, int(item), self._metric, self.dimensions()
        )

    def iter(self) -> Iterator[tuple[int, list[float]]]:
        return _item_iter(
            self._database._db, self._rtxn, self._index, self._metric, self.dimensions()
        )

    def nns(self, count: int) -> QueryBuilder:
        return QueryBuilder(self, count)

    # -- python.rs-style convenience -----------------------------------
    def by_vec(self, query: Sequence[float], n: int = 10, ef_search: int = 200):
        """(python.rs:378-397)"""
        return self.nns(n).ef_search(ef_search).by_vector(query).into_nns()

    def by_vecs(
        self, queries: np.ndarray, n: int = 10, ef_search: int = 200, candidates=None, cancel=None
    ) -> list[list[tuple[int, float]]]:
        """Batched search — the throughput path: the whole batch is one
        search on the device, ``candidates`` filters the results (and
        sends small sets to the exact linear scan), ``cancel`` can stop it
        early (each row keeps what it found), and deficient rows of a
        search that ran to its end get the degraded-search completion
        (reader.rs:771-795). For per-row ``Searched`` flags (did_cancel,
        truncated) use ``reader.nns(n).by_vectors(...)``."""
        qb = self.nns(n).ef_search(max(ef_search, n))
        if candidates is not None:
            qb = qb.candidates(candidates)
        if cancel is not None:
            return [s.nns for s in qb.by_vectors_with_cancellation(queries, cancel)]
        return [s.nns for s in qb.by_vectors(queries)]

    def by_items(
        self, items, n: int = 10, ef_search: int = 200, candidates=None, cancel=None
    ) -> list[Optional[list[tuple[int, float]]]]:
        """``by_vecs``' sibling for item ids: each row is seeded at its own
        item, never returns it, and honours ``candidates`` and ``cancel``;
        a missing item gives ``None`` at its position (the reference loops
        its by-item search per item, reader.rs:809-894)."""
        qb = self.nns(n).ef_search(max(ef_search, n))
        if candidates is not None:
            qb = qb.candidates(candidates)
        searched = qb.by_items_with_cancellation(items, cancel) if cancel is not None else qb.by_items(items)
        return [None if s is None else s.nns for s in searched]

    # -- internals ----------------------------------------------------------
    def _prep_queries(self, queries: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        queries = np.atleast_2d(queries)
        if queries.shape[1] != self.dimensions():
            raise InvalidVecDimension(self.dimensions(), queries.shape[1])
        packed = codecs.pack(queries, self._metric.codec)
        norms = distances.np_norms(self._metric, packed)
        device = self._database._device
        if self._metric.is_packed:
            packed = distances.as_lanes(packed)  # the device holds lanes as int32
        return (
            torch.from_numpy(np.ascontiguousarray(packed)).to(device),
            torch.from_numpy(np.ascontiguousarray(norms)).to(device),
        )

    def _collect(self, slots: np.ndarray, dists: np.ndarray, count: int) -> list[list[tuple[int, float]]]:
        """Host result rows → per query ``[(item id, distance), ...]``,
        empty and non-finite entries dropped."""
        slots = slots[:, :count]
        dists = dists[:, :count]
        ok = (slots >= 0) & np.isfinite(dists)
        ids = self._graph.ids[np.maximum(slots, 0)]
        return [
            list(zip(ids[b][ok[b]].tolist(), dists[b][ok[b]].tolist()))
            for b in range(slots.shape[0])
        ]

    def _to_host(self, dists: torch.Tensor, slots: torch.Tensor, *cols: torch.Tensor):
        """Device result rows → host (dists, slots, extra int32 columns) in
        one transfer: the distances as their bits beside the slots and any
        per-row columns."""
        k = slots.shape[1]
        packed = torch.cat(
            [dists.contiguous().view(torch.int32), slots.to(torch.int32), *(c.to(torch.int32)[:, None] for c in cols)],
            dim=1,
        ).cpu().numpy()
        return (np.ascontiguousarray(packed[:, :k]).view(np.float32), packed[:, k : 2 * k],
                *(packed[:, 2 * k + i] for i in range(len(cols))))

    def _candidate_mask(self, candidates: Optional[IdSet]) -> Optional[np.ndarray]:
        """[capacity] bool: the occupied slots whose item is a candidate —
        one sorted membership test over the slots' ids. Occupancy comes
        from the levels, not from the ids: item 0xFFFFFFFF is legal and is
        also the free-slot sentinel."""
        if candidates is None:
            return None
        g = self._graph
        return g.valid_mask() & candidates.contains_array(g.ids)

    def _should_linear_scan(self, opt: QueryBuilder) -> bool:
        """reader.rs:622-640: few candidates, and few of the items."""
        all_ids = self.item_ids()
        if not all_ids or opt._candidates is None:
            return False
        cand_len = all_ids.intersection_len(opt._candidates)
        return cand_len < opt._linear_below and cand_len / len(all_ids) <= opt._linear_below_ratio

    def _nothing_to_find(self, opt: QueryBuilder) -> bool:
        item_ids = self.item_ids()
        return not item_ids or (opt._candidates is not None and item_ids.isdisjoint(opt._candidates))

    def _nns_by_vec(self, opt: QueryBuilder, vector: np.ndarray, cancel=None) -> Searched:
        return self._nns_by_vecs(opt, vector[None, :], cancel)[0]

    def _nns_by_vecs(self, opt: QueryBuilder, vectors: np.ndarray, cancel=None) -> list[Searched]:
        """Batched QueryBuilder execution — one search on the device serves
        the whole batch; every option applies per query (reader.rs:60-261):
        an empty index or candidates disjoint from it give empty rows, a
        small candidate set the exact scan, any other the graph search.
        ``cancel``: the caller's cancel closure, or None."""
        with span("reader_query"):
            vectors = np.atleast_2d(vectors)
            if vectors.shape[-1] != self.dimensions():
                raise InvalidVecDimension(self.dimensions(), vectors.shape[-1])
            if self._nothing_to_find(opt):
                return [Searched([], False) for _ in range(vectors.shape[0])]
            with span("reader_prep"):
                q, qn = self._prep_queries(vectors)
            if self._should_linear_scan(opt):
                return self._brute_force(q, qn, opt._candidates, opt._count, cancel)
            return self._hnsw_search(q, qn, opt, cancel)

    def _nns_by_item(self, opt: QueryBuilder, item: int, cancel=None) -> Optional[Searched]:
        """Layer-0 search seeded at the item, excluding it
        (reader.rs:809-894): the batch of one of ``_nns_by_items``."""
        return self._nns_by_items(opt, [item], cancel)[0]

    def _nns_by_items(self, opt: QueryBuilder, items, cancel=None) -> list[Optional[Searched]]:
        """Batched per-item lookup (the reference loops reader.rs:809-894
        per item; here the batch rides one search).

        Each present row seeds the layer-0 beam (filtered when the builder
        has candidates) at its own slot —
        no descent, the item already lives where the search starts — with
        the pool one wider than ``count``, so that dropping the item itself
        on the host (reader.rs:839-842) still leaves ``count`` results. A
        small candidate set takes the exact scan over the candidates but
        the item. Missing items give ``None`` at their position; ``cancel``
        as in ``_hnsw_search``."""
        with span("reader_query"):
            items = [int(i) for i in items]
            out: list[Optional[Searched]] = [None] * len(items)
            if self._nothing_to_find(opt):
                return out
            present = [b for b, i in enumerate(items) if i in self._graph.id_to_slot]
            if not present:
                return out
            with span("reader_prep"):
                pslots = np.asarray([self._graph.id_to_slot[items[b]] for b in present], dtype=np.int32)
                pitems = [items[b] for b in present]
                device = self._database._device
                sel = torch.from_numpy(pslots).to(device)
                q, qn = self._dev.vectors[sel.long()], self._dev.norms[sel.long()]

            if self._should_linear_scan(opt):
                # exact scan per row over the candidates but the item (reader.rs:668-711)
                if cancel is not None and cancel():
                    for b in present:
                        out[b] = Searched([], True)
                    return out
                masks = np.broadcast_to(
                    self._candidate_mask(opt._candidates), (len(present), self._graph.capacity)
                ).copy()
                masks[np.arange(len(present)), pslots] = False
                rows = self._flat(q, qn, masks, opt._count)
                for r, b in enumerate(present):
                    out[b] = Searched(rows[r], False)
                return out

            cand = self._candidate_mask(opt._candidates)
            ef = max(opt._ef, opt._count + 1)  # the item may take one pool entry
            max_iters = 2 * ef + 16
            latch = _Latch(cancel) if cancel is not None else None
            if latch is not None and latch():
                for b in present:
                    out[b] = Searched([], True)
                return out
            with span("reader_search", queries=len(present), ef=ef) as sp:
                if cand is None:
                    # Without candidates the JAX package runs the filtered beam
                    # with every live item a candidate: its result pool then
                    # stays equal to its frontier, and its hop is the unfiltered
                    # beam's (link rows hold no repeated id), so the unfiltered
                    # beam gives its answers, on the card by the search kernel.
                    res = _beam.beam_search(self._dev, q, qn, sel[:, None], ef, max_iters=max_iters, cancel=latch)
                else:
                    res = _beam.beam_search_filtered(
                        self._dev, q, qn, sel[:, None], ef, torch.from_numpy(cand).to(device), max_iters=max_iters,
                        cancel=latch,
                    )
                k = min(opt._count + 1, ef)
                with span("search_to_host"):
                    dists, slots, active, iters = self._to_host(
                        res.dists[:, :k], res.slots[:, :k], res.active, res.iters.expand(len(present))
                    )
                hops = int(iters[0])
                sp.set(hops=hops)
            trunc = active.astype(bool) & (hops >= max_iters)
            cancelled = latch is not None and latch()  # the final check (JAX beam.py:565)
            with span("reader_collect"):
                rows = self._collect(slots, dists, opt._count + 1)
                searched = [
                    Searched([(i, d) for i, d in rows[r] if i != pitems[r]][: opt._count], cancelled, bool(trunc[r]))
                    for r in range(len(present))
                ]
            if not cancelled:
                with span("reader_top_up"):
                    searched = self._top_up(searched, q, qn, opt, exclude_rows=[{i} for i in pitems])
            for r, b in enumerate(present):
                out[b] = searched[r]
            return out

    def _flat(self, q: torch.Tensor, qn: torch.Tensor, mask: np.ndarray, count: int) -> list[list[tuple[int, float]]]:
        """Exact top-``count`` rows over the slots of ``mask`` ([capacity],
        or one row per query) through ``flat_topk``."""
        k = min(count, self._graph.capacity)
        d, s = flat_topk(
            self._metric.name, q, qn, self._dev.vectors, self._dev.norms,
            torch.from_numpy(np.ascontiguousarray(mask)).to(self._database._device), k,
        )
        dists, slots = self._to_host(d, s)
        return self._collect(slots, dists, count)

    def _brute_force(
        self, q: torch.Tensor, qn: torch.Tensor, candidates: IdSet, count: int, cancel=None
    ) -> list[Searched]:
        """reader.rs:668-711 — the exact scan over the candidate set,
        batched; a cancel that fires before it gives empty rows."""
        if cancel is not None and cancel():
            return [Searched([], True) for _ in range(int(q.shape[0]))]
        return [Searched(nns, False) for nns in self._flat(q, qn, self._candidate_mask(candidates), count)]

    def _hnsw_search(self, q: torch.Tensor, qn: torch.Tensor, opt: QueryBuilder, cancel=None) -> list[Searched]:
        """reader.rs:722-800: descent, layer-0 beam (filtered when the
        builder has candidates), degraded top-up — batched; every query in
        ``q`` rides the same search.

        ``cancel`` (reader.rs:263-280): checked before the search — firing
        there gives empty rows — then by the search's loops and once more
        after them. Once it has fired, every row holds the live items its
        pool held, sorted, with ``did_cancel=True`` and no top-up."""
        B = int(q.shape[0])
        if B == 0:
            return []
        latch = _Latch(cancel) if cancel is not None else None
        if latch is not None and latch():
            return [Searched([], True) for _ in range(B)]
        ef = max(opt._ef, opt._count)
        max_iters = 2 * ef + 16
        efu = (
            opt._ef_upper
            if opt._ef_upper is not None
            else _beam.default_ef_upper(self.n_items(), ef)
        )
        with span("reader_search", queries=B, ef=ef, ef_upper=efu) as sp:
            if opt._candidates is not None:
                mask = torch.from_numpy(self._candidate_mask(opt._candidates)).to(self._database._device)
                res = _beam.hnsw_search_filtered(
                    self._dev, q, qn, mask, ef, max_iters=max_iters, ef_upper=efu, cancel=latch
                )
            else:
                res = _beam.hnsw_search(self._dev, q, qn, ef, max_iters=max_iters, ef_upper=efu, cancel=latch)
            # one transfer to the host: the kept columns of dists (as their
            # bits) and slots, each row's active flag, and the iteration count
            k = min(opt._count, res.slots.shape[1])
            with span("search_to_host"):
                dists, slots, active, iters = self._to_host(
                    res.dists[:, :k], res.slots[:, :k], res.active, res.iters.expand(B)
                )
            hops = int(iters[0])  # the layer-0 beam's, set by its slowest row
            sp.set(hops=hops)
        # Per-row truncation: a row is truncated only if IT was still
        # improving when the iteration cap cut the loop — one slow query
        # does not stamp the whole batch.
        trunc = active.astype(bool) & (hops >= max_iters)
        cancelled = latch is not None and latch()  # the final check (JAX beam.py:772, 865)
        with span("reader_collect"):
            searched = [
                Searched(nns, cancelled, bool(trunc[b]))
                for b, nns in enumerate(self._collect(slots, dists, opt._count))
            ]
        if cancelled:
            return searched
        with span("reader_top_up"):
            return self._top_up(searched, q, qn, opt)

    def _top_up(
        self, searched: list[Searched], q: torch.Tensor, qn: torch.Tensor, opt: QueryBuilder,
        exclude_rows: Optional[list[set[int]]] = None,
    ) -> list[Searched]:
        """Degraded-search top-up (reader.rs:771-795): rows whose beam
        returned fewer than they could (trapped in a cyclic subgraph)
        finish with one batched exact scan over the unseen items — the
        exact scan *is* the restart-visits loop's fixed point, so we go
        straight there. Honours the candidates filter. ``exclude_rows``
        (one set of item ids per row) keeps those items out of their row:
        ``by_items`` excludes each row's own item."""
        short = [b for b, s in enumerate(searched) if len(s.nns) < opt._count]
        if not short:
            return searched
        item_ids = self.item_ids()
        cands = opt._candidates
        base_achievable = item_ids.intersection_len(cands) if cands is not None else self.n_items()

        def row_exclude(b: int):
            return exclude_rows[b] if exclude_rows is not None else ()

        def achievable(excl) -> int:
            return base_achievable - sum(
                1 for e in excl if int(e) in item_ids and (cands is None or int(e) in cands)
            )

        # a row is deficient when it holds fewer than it could: fewer than
        # count and fewer than the items its filter and exclusions leave
        deficient = [b for b in short if len(searched[b].nns) < achievable(row_exclude(b))]
        if not deficient:
            return searched
        base = self._candidate_mask(cands)
        if base is None:
            base = self._graph.valid_mask()
        masks = np.broadcast_to(base, (len(deficient), self._graph.capacity)).copy()
        for r, b in enumerate(deficient):
            for item in {i for i, _ in searched[b].nns} | set(row_exclude(b)):
                s = self._graph.id_to_slot.get(int(item))
                if s is not None:
                    masks[r, s] = False
        sel = torch.tensor(deficient, dtype=torch.long, device=self._database._device)
        extras = self._flat(q[sel], qn[sel], masks, opt._count)
        out = list(searched)
        for r, b in enumerate(deficient):
            merged = sorted(searched[b].nns + extras[r], key=lambda t: t[1])[: opt._count]
            out[b] = Searched(merged, searched[b].did_cancel, searched[b].truncated)
        return out

    def assert_validity(self) -> None:
        """Graph invariant checker (reference assert_validity,
        reader.rs:905-948). The links rows are decoded one by one, and
        their ids are held against the item set in one membership test."""
        self._graph.check_validity()
        db = self._database._db
        item_ids = IdSet(
            np.asarray(
                [Key.from_bytes(k).item for k, _ in db.prefix_iter(self._rtxn, Prefix.item(self._index))],
                dtype=np.uint32,
            )
        )
        assert item_ids == self._metadata.items
        link_owner_ids = set()
        linked = [np.empty(0, dtype=np.uint32)]
        for k, v in db.prefix_iter(self._rtxn, Prefix.links(self._index)):
            link_owner_ids.add(Key.from_bytes(k).item)
            linked.append(decode_links(v).to_array())
        assert item_ids.contains_array(np.concatenate(linked)).all(), "dangling edge to deleted item"
        assert link_owner_ids == set(item_ids), "every item must have links"
        for ep in self._metadata.entry_points:
            assert ep in item_ids


class _Latch:
    """A search's cancel closure, latched: once it has returned True the
    search stays cancelled, whatever the closure says later."""

    def __init__(self, fn: Callable[[], bool]):
        self._fn = fn
        self.fired = False

    def __call__(self) -> bool:
        if not self.fired:
            self.fired = bool(self._fn())
        return self.fired


# --------------------------------------------------------------------------
# Shared item helpers (reference item_iter.rs, reader.rs:951-976)
# --------------------------------------------------------------------------


def _get_item_vector(db, txn, index, item, metric, dimensions) -> Optional[list[float]]:
    val = db.get(txn, Key.item(index, item).to_bytes())
    if val is None:
        return None
    _, vecb = decode_item(val)
    row = codecs.vector_from_bytes(vecb, metric.codec)
    vec = codecs.unpack(row[None, :], dimensions, metric.codec)[0]
    return [float(x) for x in vec]


def _item_iter(db, txn, index, metric, dimensions):
    for key, val in db.prefix_iter(txn, Prefix.item(index)):
        k = Key.from_bytes(key)
        _, vecb = decode_item(val)
        row = codecs.vector_from_bytes(vecb, metric.codec)
        vec = codecs.unpack(row[None, :], dimensions, metric.codec)[0]
        yield k.item, [float(x) for x in vec]
