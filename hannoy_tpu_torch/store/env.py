"""Host-side persistent KV store with LMDB-like transaction semantics.

The replacement for the reference's LMDB/heed storage substrate (reference
``src/lib.rs:131``), a copy of ``hannoy_tpu/store/env.py`` with the same
on-disk format. The device serves queries from tensors in its memory; this
store is the durable source of truth that survives process restarts and
provides:

* **MVCC snapshots** — read transactions see an immutable committed
  generation while a writer mutates an overlay, matching LMDB's
  concurrent-readers-during-write guarantee the reference relies on
  (reference ``README.md:13``, ``src/parallel.rs:19-31``).
* **Crash consistency** — nothing persists until ``RwTxn.commit()``; a
  crashed build leaves the previous index plus the intact dirty journal,
  mirroring the reference's transactional build.
* **Prefix scans** over big-endian ordered keys (reference
  ``src/key.rs:86-127``).
* **Named databases** inside one environment (heed ``env.create_database``).

Two interchangeable backends exist: this pure-Python append-log backend and
the native C++ backend in ``store/native`` (see ``native_env.py``; the caller
of ``open_env`` chooses). Both persist an identical record format, which is
also the JAX package's: either package opens the other's directories.
"""

from __future__ import annotations

import fcntl
import io
import os
import struct
import threading
import time
from typing import Iterator, Optional

import numpy as np

from ..errors import DatabaseFull, StoreError

_MAGIC = b"HNYT"
_LOG_VERSION = 1
_OP_PUT = 1
_OP_DEL = 0


def _key_to_u64(key: bytes) -> int:
    """8-byte big-endian key → u64 preserving order."""
    return int.from_bytes(key, "big")


class _Generation:
    """One immutable committed snapshot of every named database."""

    __slots__ = ("tables", "_sorted", "_lock", "gen_id")

    def __init__(self, tables: dict[str, dict[bytes, bytes]], gen_id: int):
        self.tables = tables
        self._sorted: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self.gen_id = gen_id

    def sorted_keys(self, name: str) -> np.ndarray:
        """Lazily-computed sorted u64 view of a table's keys."""
        with self._lock:
            arr = self._sorted.get(name)
            if arr is None:
                table = self.tables.get(name, {})
                arr = np.fromiter(
                    (_key_to_u64(k) for k in table.keys()), dtype=np.uint64, count=len(table)
                )
                arr.sort()
                self._sorted[name] = arr
            return arr


class RoTxn:
    """A read snapshot. Cheap to create; holds no locks."""

    def __init__(self, gen: _Generation):
        self._gen = gen
        self.active = True

    def commit(self) -> None:  # parity with heed::RoTxn::commit
        self.active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.active = False


class RwTxn(RoTxn):
    """The single write transaction: an overlay on top of a snapshot.

    ``None`` values in the overlay are tombstones. Readers forked *from*
    this txn (the ``FrozenReader`` analogue, reference
    ``src/parallel.rs:19-31``) see overlay+snapshot at fork time — here we
    simply let builder code read through the live RwTxn, which is safe
    because the Python build orchestrator is single-threaded on host.
    """

    def __init__(self, env: "Env", gen: _Generation):
        super().__init__(gen)
        self._env = env
        # name -> {key: value | None}
        self.overlay: dict[str, dict[bytes, Optional[bytes]]] = {}
        self._bytes_written = 0

    def _table_overlay(self, name: str) -> dict[bytes, Optional[bytes]]:
        return self.overlay.setdefault(name, {})

    def commit(self) -> None:
        if not self.active:
            raise StoreError("transaction already closed")
        self._env._commit(self)
        self.active = False

    def abort(self) -> None:
        self.active = False
        self._env._release_writer(self)

    def __exit__(self, exc_type, *exc):
        if self.active:
            if exc_type is None:
                self.commit()
            else:
                self.abort()


class Database:
    """Handle to a named table inside an :class:`Env`.

    Loosely mirrors ``heed::Database`` — all methods take a transaction.
    """

    def __init__(self, env: "Env", name: str):
        self._env = env
        self.name = name

    # -- reads -------------------------------------------------------------
    def get(self, txn: RoTxn, key: bytes) -> Optional[bytes]:
        if isinstance(txn, RwTxn):
            ov = txn.overlay.get(self.name)
            if ov is not None and key in ov:
                return ov[key]
        return txn._gen.tables.get(self.name, {}).get(key)

    def prefix_iter(self, txn: RoTxn, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Yield (key, value) with key starting with ``prefix``, in key order."""
        lo = int.from_bytes(prefix + b"\x00" * (8 - len(prefix)), "big")
        hi = int.from_bytes(prefix + b"\xff" * (8 - len(prefix)), "big") + 1

        gen = txn._gen
        table = gen.tables.get(self.name, {})
        keys_u64 = gen.sorted_keys(self.name)
        i0, i1 = np.searchsorted(keys_u64, [lo, hi])
        base_keys = [int(k).to_bytes(8, "big") for k in keys_u64[i0:i1]]

        if isinstance(txn, RwTxn):
            ov = txn.overlay.get(self.name)
            if ov:
                ov_keys = sorted(k for k in ov if lo <= _key_to_u64(k) < hi)
                merged: dict[bytes, Optional[bytes]] = {}
                for k in base_keys:
                    merged[k] = table[k]
                for k in ov_keys:
                    v = ov[k]
                    if v is None:
                        merged.pop(k, None)
                    else:
                        merged[k] = v
                for k in sorted(merged):
                    yield k, merged[k]  # type: ignore[misc]
                return

        for k in base_keys:
            yield k, table[k]

    def len(self, txn: RoTxn) -> int:
        n = len(txn._gen.tables.get(self.name, {}))
        if isinstance(txn, RwTxn):
            ov = txn.overlay.get(self.name)
            if ov:
                table = txn._gen.tables.get(self.name, {})
                for k, v in ov.items():
                    present = k in table
                    if v is None and present:
                        n -= 1
                    elif v is not None and not present:
                        n += 1
        return n

    # -- writes ------------------------------------------------------------
    def put(self, txn: RwTxn, key: bytes, value: bytes) -> None:
        txn._bytes_written += len(key) + len(value) + 16
        if txn._bytes_written + self._env._live_bytes > self._env.map_size:
            raise DatabaseFull()
        txn._table_overlay(self.name)[key] = value

    def put_many(self, txn: RwTxn, keys: list[bytes], values: list[bytes]) -> None:
        """Batched put (API parity with the native backend's single-call
        path; here the overlay dict is the batch)."""
        ov = txn._table_overlay(self.name)
        for k, v in zip(keys, values):
            txn._bytes_written += len(k) + len(v) + 16
            ov[k] = v
        if txn._bytes_written + self._env._live_bytes > self._env.map_size:
            raise DatabaseFull()

    def put_many_raw(self, txn: RwTxn, kbuf: bytes, vbuf: bytes, offs) -> None:
        """Buffer-batched put (native-backend API parity: n concatenated
        8-byte keys + [n+1] u64 value offsets). The pure-Python overlay
        splits the buffers — correctness path only."""
        n = len(offs) - 1
        mv = memoryview(vbuf)
        self.put_many(
            txn,
            [bytes(kbuf[i * 8 : (i + 1) * 8]) for i in range(n)],
            [bytes(mv[int(offs[i]) : int(offs[i + 1])]) for i in range(n)],
        )

    def delete(self, txn: RwTxn, key: bytes) -> bool:
        existed = self.get(txn, key) is not None
        txn._table_overlay(self.name)[key] = None
        return existed

    def delete_many(self, txn: RwTxn, keys_u64) -> None:
        """Batched delete of u64-encoded keys (native-backend API parity;
        the overlay dict is the batch)."""
        ov = txn._table_overlay(self.name)
        for k in np.asarray(keys_u64, dtype=np.uint64).tolist():
            ov[int(k).to_bytes(8, "big")] = None

    def scan_fixed(self, txn, prefix: bytes, row_bytes: int):
        """Vectorized-shape range scan of fixed-width values (native API
        parity) → (keys u64 [n], rows uint8 [n, row_bytes])."""
        keys: list[int] = []
        rows: list[bytes] = []
        for k, v in self.prefix_iter(txn, prefix):
            if len(v) != row_bytes:
                raise StoreError(
                    f"scan_fixed: variable-width value in fixed scan "
                    f"(expected {row_bytes}, got {len(v)})"
                )
            keys.append(int.from_bytes(k, "big"))
            rows.append(v)
        if not keys:
            return np.empty(0, dtype=np.uint64), np.empty((0, row_bytes), dtype=np.uint8)
        return (
            np.asarray(keys, dtype=np.uint64),
            np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(len(keys), row_bytes),
        )


#: the fields of ``last_commit_stats``: the last commit's batch bytes and the
#: nanoseconds of its steps (serialize; log: write, flush and fsync;
#: publish: the copy of the committed tables, the merge and the swap)
COMMIT_STATS = ("batch_bytes", "serialize_ns", "log_ns", "publish_ns")


class Env:
    """A storage environment: one directory holding one append-only log.

    ``map_size`` bounds the live payload, mirroring LMDB's map size
    (the reference Python bindings default to 1 GiB,
    ``src/python.rs:15``).
    """

    def __init__(
        self,
        path: str | os.PathLike,
        map_size: int = 1024 * 1024 * 1024,
        readonly: bool = False,
    ):
        self.path = str(path)
        self.map_size = map_size
        self.readonly = readonly
        os.makedirs(self.path, exist_ok=True)
        self._log_path = os.path.join(self.path, "hannoy.log")
        self._write_lock = threading.Lock()
        self._writer: Optional[RwTxn] = None
        self._live_bytes = 0
        self._last_commit = dict.fromkeys(COMMIT_STATS, 0)
        if readonly:
            # Cross-process snapshot open (LMDB parity: other processes may
            # open the env read-only while one writes, reference
            # README.md:13 + parallel.rs:19-31). The append-only log makes
            # this lock-free: complete batches are immutable, so replaying
            # the longest valid prefix yields a consistent MVCC snapshot no
            # matter what the writer is appending concurrently (a
            # mid-append batch parses as a torn tail and is simply not part
            # of the snapshot). ``refresh()`` re-replays to pick up
            # later commits.
            self._lock_file = None
            self._log = None
            self._gen = self._replay()
            return
        # one owning WRITER process per environment: the append-only log has
        # no cross-process coordination (unlike LMDB's shared-memory locks),
        # so a second writer would interleave batches and corrupt the tail.
        # The lock lives on a sidecar file so compaction's atomic rename of
        # the log can never drop exclusivity (same file the C++ backend locks).
        self._lock_file = open(os.path.join(self.path, "hannoy.lock"), "ab")
        try:
            fcntl.flock(self._lock_file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            self._lock_file.close()
            raise StoreError(
                f"store at {self.path} is already open in another process"
            ) from e
        self._gen = self._replay()
        self._log = open(self._log_path, "ab")

    # -- txn management ----------------------------------------------------
    def read_txn(self) -> RoTxn:
        return RoTxn(self._gen)

    def write_txn(self) -> RwTxn:
        if self.readonly:
            raise StoreError(f"store at {self.path} is open read-only")
        self._write_lock.acquire()
        txn = RwTxn(self, self._gen)
        self._writer = txn
        return txn

    def refresh(self) -> bool:
        """Read-only envs: re-replay the log to adopt commits made by the
        owning writer process since open (the MVCC 'begin a new RoTxn'
        analogue). Returns True if the snapshot advanced."""
        if not self.readonly:
            return False
        old_gen = self._gen
        new_gen = self._replay()
        changed = new_gen.tables != old_gen.tables
        if changed:
            new_gen.gen_id = old_gen.gen_id + 1
            self._gen = new_gen
        return changed

    def create_database(self, txn: RoTxn | None, name: Optional[str]) -> Database:
        return Database(self, name or "__main__")

    # -- commit path -------------------------------------------------------
    def last_commit_stats(self) -> dict:
        """The last commit's ``COMMIT_STATS`` (zeros before the first)."""
        return dict(self._last_commit)

    def _commit(self, txn: RwTxn) -> None:
        try:
            t0 = time.perf_counter_ns()
            batch = self._serialize_batch(txn.overlay)
            t1 = time.perf_counter_ns()
            pre = self._log.seek(0, os.SEEK_END)
            try:
                self._log.write(batch)
                self._log.flush()
                os.fsync(self._log.fileno())
            except OSError:
                # roll the log back to the pre-batch offset so torn bytes
                # can't poison replay of later successful commits
                try:
                    self._log.truncate(pre)
                    self._log.seek(0, os.SEEK_END)
                except OSError:
                    pass
                raise

            t2 = time.perf_counter_ns()
            new_tables = {n: dict(t) for n, t in self._gen.tables.items()}
            for name, ov in txn.overlay.items():
                table = new_tables.setdefault(name, {})
                for k, v in ov.items():
                    if v is None:
                        old = table.pop(k, None)
                        if old is not None:
                            self._live_bytes -= len(k) + len(old) + 16
                    else:
                        old = table.get(k)
                        if old is not None:
                            self._live_bytes -= len(k) + len(old) + 16
                        table[k] = v
                        self._live_bytes += len(k) + len(v) + 16
            self._gen = _Generation(new_tables, self._gen.gen_id + 1)
            self._last_commit = dict(zip(COMMIT_STATS, (len(batch), t1 - t0, t2 - t1, time.perf_counter_ns() - t2)))
            self._maybe_compact()
        finally:
            self._release_writer(txn)

    def _release_writer(self, txn: RwTxn) -> None:
        if self._writer is txn:
            self._writer = None
            self._write_lock.release()

    # -- log format ---------------------------------------------------------
    @staticmethod
    def _serialize_batch(overlay: dict[str, dict[bytes, Optional[bytes]]]) -> bytes:
        buf = io.BytesIO()
        body = io.BytesIO()
        for name, ov in overlay.items():
            nb = name.encode("utf-8")
            for k, v in ov.items():
                if v is None:
                    body.write(struct.pack(">BH", _OP_DEL, len(nb)))
                    body.write(nb)
                    body.write(struct.pack(">H", len(k)))
                    body.write(k)
                else:
                    body.write(struct.pack(">BH", _OP_PUT, len(nb)))
                    body.write(nb)
                    body.write(struct.pack(">HI", len(k), len(v)))
                    body.write(k)
                    body.write(v)
        payload = body.getvalue()
        buf.write(_MAGIC)
        buf.write(struct.pack(">BI", _LOG_VERSION, len(payload)))
        buf.write(payload)
        return buf.getvalue()

    def _replay(self) -> _Generation:
        tables: dict[str, dict[bytes, bytes]] = {}
        self._live_bytes = 0
        if not os.path.exists(self._log_path):
            return _Generation(tables, 0)
        with open(self._log_path, "rb") as f:
            data = f.read()
        pos = 0
        valid_end = 0
        while pos + 9 <= len(data):
            if data[pos : pos + 4] != _MAGIC:
                break
            version, plen = struct.unpack_from(">BI", data, pos + 4)
            if version != _LOG_VERSION or pos + 9 + plen > len(data):
                break  # torn tail from a crash: ignore the partial batch
            end = pos + 9 + plen
            p = pos + 9
            while p < end:
                op, nlen = struct.unpack_from(">BH", data, p)
                p += 3
                name = data[p : p + nlen].decode("utf-8")
                p += nlen
                table = tables.setdefault(name, {})
                if op == _OP_PUT:
                    klen, vlen = struct.unpack_from(">HI", data, p)
                    p += 6
                    k = data[p : p + klen]
                    p += klen
                    v = data[p : p + vlen]
                    p += vlen
                    old = table.get(k)
                    if old is not None:
                        self._live_bytes -= len(k) + len(old) + 16
                    table[k] = v
                    self._live_bytes += len(k) + len(v) + 16
                else:
                    (klen,) = struct.unpack_from(">H", data, p)
                    p += 2
                    k = data[p : p + klen]
                    p += klen
                    old = table.pop(k, None)
                    if old is not None:
                        self._live_bytes -= len(k) + len(old) + 16
            valid_end = end
            pos = end
        if valid_end < len(data) and not self.readonly:
            # truncate a torn tail so future appends start clean. A
            # read-only open must NOT touch the file: the "torn tail" may
            # be the owning writer's in-flight append.
            with open(self._log_path, "r+b") as f:
                f.truncate(valid_end)
        return _Generation(tables, 0)

    def _maybe_compact(self) -> None:
        try:
            log_size = os.path.getsize(self._log_path)
        except OSError:
            return
        if log_size > 4 * max(self._live_bytes, 1 << 20):
            self.compact()

    def compact(self) -> None:
        """Rewrite the log with only the live entries (atomic rename)."""
        tmp = self._log_path + ".compact"
        overlay = {n: dict(t) for n, t in self._gen.tables.items()}
        with open(tmp, "wb") as f:
            f.write(self._serialize_batch(overlay))  # type: ignore[arg-type]
            f.flush()
            os.fsync(f.fileno())
        self._log.close()
        # a rewritten prefix invalidates the native backend's reopen
        # snapshot (hannoy.snap probes the old prefix) — drop it so a later
        # native open falls back to a full replay instead of a stale cache
        try:
            os.unlink(os.path.join(os.path.dirname(self._log_path), "hannoy.snap"))
        except FileNotFoundError:
            pass
        # exclusivity is held by the sidecar lock throughout the rename
        os.replace(tmp, self._log_path)
        self._log = open(self._log_path, "ab")

    def close(self) -> None:
        try:
            if self._log is not None:
                self._log.close()
        except Exception:
            pass
        try:
            if self._lock_file is not None:
                self._lock_file.close()
        except Exception:
            pass
