"""ctypes binding for the native C++ KV store (``native/kvstore.cpp``).

Counterpart of ``hannoy_tpu/store/native_env.py``. Drop-in replacement for
the pure-Python ``env.py`` backend — same method surface
(``create_database``, ``read_txn``, ``write_txn``, ``get``, ``put``,
``delete``, ``prefix_iter``, ``commit``, ``abort``, ``compact``) and the
*same on-disk format*, so either backend, of either package, opens the
other's files.

The shared library is compiled at first use with ``g++`` (a C ABI loaded
with ctypes) into ``hannoy_tpu_torch/_build/``, named by a hash of the
source; no binary is kept beside the source. The caller of ``open_env``
chooses the backend; a build that fails raises ``StoreError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..errors import DatabaseFull, StoreError
from .env import COMMIT_STATS
from .env import Env as PyEnv

SOURCE = Path(__file__).resolve().parent / "native" / "kvstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_BUILD_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where this version of the source is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhannoykv_{digest}.so"


def _build_so() -> str:
    with _BUILD_LOCK:
        so = library_path()
        if so.exists():
            return str(so)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # several processes may build at once: each compiles into its own
        # temporary, and the rename publishes a complete library
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise StoreError(f"native store build failed: {detail.decode()[:500]}") from e
        os.replace(tmp, so)
        return str(so)


def load_library():
    """Compile (if needed) and load the native library; cached."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(_build_so())
    lib.hny_open.restype = ctypes.c_void_p
    lib.hny_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.hny_close.argtypes = [ctypes.c_void_p]
    lib.hny_gen_id.restype = ctypes.c_uint64
    lib.hny_gen_id.argtypes = [ctypes.c_void_p]
    lib.hny_live_bytes.restype = ctypes.c_uint64
    lib.hny_live_bytes.argtypes = [ctypes.c_void_p]
    for f in ("hny_ro_begin", "hny_rw_begin"):
        getattr(lib, f).restype = ctypes.c_void_p
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.hny_ro_end.argtypes = [ctypes.c_void_p]
    lib.hny_rw_abort.argtypes = [ctypes.c_void_p]
    lib.hny_put.restype = ctypes.c_int
    lib.hny_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.hny_del.restype = ctypes.c_int
    lib.hny_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.hny_get.restype = ctypes.c_int64
    lib.hny_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.hny_scan_keys.restype = ctypes.c_int64
    lib.hny_scan_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.hny_put_many.restype = ctypes.c_int
    lib.hny_put_many.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.hny_scan_vals.restype = ctypes.c_int64
    lib.hny_scan_vals.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.hny_del_many.restype = ctypes.c_int
    lib.hny_del_many.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.hny_commit.restype = ctypes.c_int
    lib.hny_commit.argtypes = [ctypes.c_void_p]
    lib.hny_compact.restype = ctypes.c_int
    lib.hny_compact.argtypes = [ctypes.c_void_p]
    lib.hny_snapshot.restype = ctypes.c_int
    lib.hny_snapshot.argtypes = [ctypes.c_void_p]
    lib.hny_log_size.restype = ctypes.c_uint64
    lib.hny_log_size.argtypes = [ctypes.c_void_p]
    lib.hny_snap_covered.restype = ctypes.c_uint64
    lib.hny_snap_covered.argtypes = [ctypes.c_void_p]
    lib.hny_last_commit_stats.restype = None
    lib.hny_last_commit_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.hny_bulk_rows.restype = ctypes.c_int64
    lib.hny_bulk_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64,
    ]
    _LIB = lib
    return lib


def _range_from_prefix(prefix: bytes) -> tuple[int, int]:
    lo = int.from_bytes(prefix + b"\x00" * (8 - len(prefix)), "big")
    hi = int.from_bytes(prefix + b"\xff" * (8 - len(prefix)), "big") + 1
    # an empty prefix makes hi == 2**64, which the u64 ABI would wrap to 0;
    # the C scans define hi == 0 as "no upper bound", which is exactly that
    return lo, hi % (1 << 64)


class _GenShim:
    """Matches env.py's ``_gen.gen_id`` attribute used for cache stamps."""

    def __init__(self, env: "NativeEnv"):
        self._env = env

    @property
    def gen_id(self) -> int:
        return self._env._lib.hny_gen_id(self._env._ptr)


class NativeRoTxn:
    def __init__(self, env: "NativeEnv", ptr, writable: bool):
        self._env = env
        self._ptr = ptr
        self._writable = writable
        self.active = True

    def commit(self) -> None:
        if not self.active:
            raise StoreError("transaction already closed")
        self._env._lib.hny_ro_end(self._ptr)
        self.active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.active:
            self._env._lib.hny_ro_end(self._ptr)
            self.active = False

    def __del__(self):  # pragma: no cover - GC backstop
        if getattr(self, "active", False) and not self._writable:
            try:
                self._env._lib.hny_ro_end(self._ptr)
            except Exception:
                pass
            self.active = False


class NativeRwTxn(NativeRoTxn):
    def __init__(self, env: "NativeEnv", ptr):
        super().__init__(env, ptr, writable=True)
        self._dirty = False

    @property
    def overlay(self):
        """Truthiness mirrors env.py's overlay (non-empty == uncommitted
        writes); consumers only test this, never iterate it."""
        return {"dirty": True} if self._dirty else {}

    def commit(self) -> None:
        if not self.active:
            raise StoreError("transaction already closed")
        rc = self._env._lib.hny_commit(self._ptr)
        self.active = False
        if rc != 0:
            raise StoreError(f"commit failed (rc={rc})")

    def abort(self) -> None:
        if self.active:
            self._env._lib.hny_rw_abort(self._ptr)
            self.active = False

    def __exit__(self, exc_type, *exc):
        if self.active:
            if exc_type is None:
                self.commit()
            else:
                self.abort()

    def __del__(self):  # pragma: no cover
        if getattr(self, "active", False):
            try:
                self.abort()
            except Exception:
                pass


class NativeDatabase:
    def __init__(self, env: "NativeEnv", name: str):
        self._env = env
        self.name = name
        self._bname = name.encode("utf-8")

    def get(self, txn: NativeRoTxn, key: bytes) -> Optional[bytes]:
        lib = self._env._lib
        n = lib.hny_get(txn._ptr, self._bname, key, None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        lib.hny_get(txn._ptr, self._bname, key, buf, n)
        return buf.raw[:n]

    def put(self, txn: NativeRwTxn, key: bytes, value: bytes) -> None:
        rc = self._env._lib.hny_put(txn._ptr, self._bname, key, value, len(value))
        if rc == -1:
            raise DatabaseFull()
        if rc != 0:
            raise StoreError(f"put failed (rc={rc})")
        txn._dirty = True

    def put_many(self, txn: NativeRwTxn, keys: list[bytes], values: list[bytes]) -> None:
        """Batched put — one C call for n records (the link-flush hot path;
        replaces n ctypes round trips)."""
        n = len(keys)
        if n == 0:
            return
        kbuf = b"".join(keys)
        offs = np.zeros(n + 1, dtype=np.uint64)
        offs[1:] = np.cumsum(np.fromiter((len(v) for v in values), dtype=np.uint64, count=n))
        vbuf = b"".join(values)
        self.put_many_raw(txn, kbuf, vbuf, offs)

    def put_many_raw(
        self, txn: NativeRwTxn, kbuf: bytes, vbuf: bytes, offs: np.ndarray
    ) -> None:
        """Zero-copy batched put: ``kbuf`` is n concatenated 8-byte keys,
        ``vbuf`` the concatenated values, ``offs`` [n+1] u64 value offsets.
        The staging/flush path — callers assemble both buffers
        with vectorized numpy (schema.keys_bytes / items_payload /
        links_payload) so no per-record Python runs anywhere."""
        n = len(offs) - 1
        if n <= 0:
            return
        offs = np.ascontiguousarray(offs, dtype=np.uint64)
        rc = self._env._lib.hny_put_many(
            txn._ptr, self._bname, kbuf, vbuf,
            offs.ctypes.data_as(ctypes.c_void_p), n,
        )
        if rc == -1:
            raise DatabaseFull()
        if rc != 0:
            raise StoreError(f"put_many failed (rc={rc})")
        txn._dirty = True

    def delete(self, txn: NativeRwTxn, key: bytes) -> bool:
        existed = self._env._lib.hny_del(txn._ptr, self._bname, key)
        txn._dirty = True
        return bool(existed)

    def delete_many(self, txn: NativeRwTxn, keys_u64: np.ndarray) -> None:
        """Batched tombstones for u64-encoded keys (the journal-clear path
        — callers pass keys they just scanned, so no existence checks)."""
        keys_u64 = np.ascontiguousarray(keys_u64, dtype=np.uint64)
        n = len(keys_u64)
        if not n:
            return
        self._env._lib.hny_del_many(
            txn._ptr, self._bname,
            keys_u64.ctypes.data_as(ctypes.c_void_p), n,
        )
        txn._dirty = True

    def scan_fixed(
        self, txn: NativeRoTxn, prefix: bytes, row_bytes: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized range scan of fixed-width values → (keys u64 [n],
        rows uint8 [n, row_bytes]). Unlike ``bulk_rows`` this merges the
        write overlay (hny_scan_vals), so records written in the current
        transaction are visible — the journal-scan fast path."""
        lo, hi = _range_from_prefix(prefix)
        lib = self._env._lib
        cap = 1 << 16
        vals_cap = cap * max(row_bytes, 1)
        keys = np.empty(cap, dtype=np.uint64)
        lens = np.empty(cap, dtype=np.uint32)
        out_k: list[np.ndarray] = []
        out_v: list[np.ndarray] = []
        more = ctypes.c_int(1)
        while more.value:
            vbuf = np.empty(vals_cap, dtype=np.uint8)
            n = lib.hny_scan_vals(
                txn._ptr, self._bname, lo, hi,
                keys.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p),
                vbuf.ctypes.data_as(ctypes.c_void_p), vals_cap, cap,
                ctypes.byref(more),
            )
            if n == 0:
                if more.value:
                    raise StoreError("scan_fixed made no progress")
                break
            if not (lens[:n] == row_bytes).all():
                raise StoreError(
                    f"scan_fixed: variable-width value in fixed scan "
                    f"(expected {row_bytes})"
                )
            out_k.append(keys[:n].copy())
            out_v.append(vbuf[: n * row_bytes].reshape(n, row_bytes).copy())
            if more.value:
                lo = int(keys[n - 1]) + 1
        if not out_k:
            return np.empty(0, dtype=np.uint64), np.empty((0, row_bytes), dtype=np.uint8)
        return np.concatenate(out_k), np.concatenate(out_v)

    def scan_keys(self, txn: NativeRoTxn, prefix: bytes) -> np.ndarray:
        lo, hi = _range_from_prefix(prefix)
        lib = self._env._lib
        cap = 1 << 16
        out = []
        more = ctypes.c_int(1)
        while more.value:
            buf = np.empty(cap, dtype=np.uint64)
            n = lib.hny_scan_keys(
                txn._ptr, self._bname, lo, hi,
                buf.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(more),
            )
            out.append(buf[:n].copy())
            if more.value:
                if n == 0:
                    raise StoreError("scan made no progress")
                lo = int(buf[n - 1]) + 1
        return np.concatenate(out) if len(out) > 1 else out[0]

    def prefix_iter(self, txn: NativeRoTxn, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Streaming (key, value) range scan in key order — one C call per
        buffer-full instead of one per key."""
        lo, hi = _range_from_prefix(prefix)
        lib = self._env._lib
        cap = 1 << 14
        vals_cap = 1 << 22  # 4 MiB of values per C call
        keys = np.empty(cap, dtype=np.uint64)
        lens = np.empty(cap, dtype=np.uint32)
        more = ctypes.c_int(1)
        while more.value:
            vbuf = ctypes.create_string_buffer(vals_cap)
            n = lib.hny_scan_vals(
                txn._ptr, self._bname, lo, hi,
                keys.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p),
                vbuf, vals_cap, cap, ctypes.byref(more),
            )
            if n == 0 and more.value:
                # one value larger than the buffer: grow and retry
                vals_cap *= 4
                continue
            raw = vbuf.raw
            off = 0
            for i in range(n):
                ln = int(lens[i])
                yield int(keys[i]).to_bytes(8, "big"), raw[off : off + ln]
                off += ln
            if more.value:
                lo = int(keys[n - 1]) + 1

    def len(self, txn: NativeRoTxn) -> int:
        return int(self.scan_keys(txn, b"").size)

    def bulk_rows(
        self, txn: NativeRoTxn, prefix: bytes, skip: int, row_bytes: int, cap: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-width bulk value fetch → (keys u64 [n], rows uint8 [n, row_bytes])."""
        lo, hi = _range_from_prefix(prefix)
        rows = np.zeros((cap, row_bytes), dtype=np.uint8)
        keys = np.empty(cap, dtype=np.uint64)
        n = self._env._lib.hny_bulk_rows(
            txn._ptr, self._bname, lo, hi, skip,
            rows.ctypes.data_as(ctypes.c_void_p), row_bytes,
            keys.ctypes.data_as(ctypes.c_void_p), cap,
        )
        if n < 0:
            raise StoreError(f"bulk_rows failed (rc={n})")
        return keys[:n], rows[:n]


class NativeEnv:
    """Native environment with the env.py surface."""

    def __init__(self, path, map_size: int = 1024 * 1024 * 1024):
        self.path = str(path)
        self.map_size = map_size
        self._lib = load_library()
        os.makedirs(self.path, exist_ok=True)
        self._ptr = self._lib.hny_open(self.path.encode(), map_size)
        if not self._ptr:
            raise StoreError(f"failed to open native store at {self.path}")
        self._gen = _GenShim(self)
        self._log_path = os.path.join(self.path, "hannoy.log")

    def read_txn(self) -> NativeRoTxn:
        return NativeRoTxn(self, self._lib.hny_ro_begin(self._ptr), writable=False)

    def write_txn(self) -> NativeRwTxn:
        return NativeRwTxn(self, self._lib.hny_rw_begin(self._ptr))

    def create_database(self, txn, name: Optional[str]) -> NativeDatabase:
        return NativeDatabase(self, name or "__main__")

    def last_commit_stats(self) -> dict:
        """The last commit's ``COMMIT_STATS`` (zeros before the first)."""
        out = (ctypes.c_uint64 * len(COMMIT_STATS))()
        self._lib.hny_last_commit_stats(self._ptr, out)
        return dict(zip(COMMIT_STATS, out))

    def compact(self) -> None:
        rc = self._lib.hny_compact(self._ptr)
        if rc != 0:
            raise StoreError(f"compact failed (rc={rc})")

    def snapshot(self) -> None:
        """Write the reopen snapshot (hannoy.snap): the next open loads
        sorted tables directly and replays only log bytes appended after
        this point — replay-free reopen for large stores."""
        rc = self._lib.hny_snapshot(self._ptr)
        if rc != 0:
            raise StoreError(f"snapshot failed (rc={rc})")

    #: log bytes that may accumulate past the snapshot before close()
    #: rewrites it (16 MiB of suffix replays in negligible time)
    SNAPSHOT_SLACK = 16 * 1024 * 1024

    def close(self) -> None:
        if self._ptr:
            # keep reopen cheap: refresh the snapshot when enough new log
            # has accumulated since the covered point (best-effort)
            try:
                log = self._lib.hny_log_size(self._ptr)
                covered = self._lib.hny_snap_covered(self._ptr)
                if log > covered + self.SNAPSHOT_SLACK:
                    self._lib.hny_snapshot(self._ptr)
            except Exception:
                pass
            self._lib.hny_close(self._ptr)
            self._ptr = None


def open_env(
    path,
    map_size: int = 1024 * 1024 * 1024,
    backend: str = "native",
    readonly: bool = False,
):
    """Open a store environment with the backend the caller names.

    ``backend``: ``"native"`` (the C++ engine; ``StoreError`` if it does
    not build) or ``"python"``. Nothing switches from one to the other.
    ``readonly``: lock-free cross-process snapshot open (LMDB's concurrent
    readers, reference README.md:13). Served by the Python engine's replay
    whatever ``backend`` says — the backends share the on-disk format, so
    a read-only snapshot of a natively-written store is exact; the native
    writer keeps its exclusive flock untouched.
    """
    if backend not in ("native", "python"):
        raise ValueError(f"store backend must be 'native' or 'python', got {backend!r}")
    if readonly or backend == "python":
        return PyEnv(path, map_size, readonly=readonly)
    return NativeEnv(path, map_size)
