"""The port's host store against the JAX package's: the same operations
through ``hannoy_tpu.store`` and ``hannoy_tpu_torch.store`` give the same
scans and the same log files, each package opens the other's directories,
and the port's own build and backend rules hold (CPU only; no device).

Everything here is exact: the store moves bytes, so there is no tolerance.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hannoy_tpu import store as jax_store
from hannoy_tpu.store import schema as jax_schema
from hannoy_tpu.utils.idset import IdSet as JaxIdSet
from hannoy_tpu_torch import errors, store
from hannoy_tpu_torch.store import native_env, schema
from hannoy_tpu_torch.utils.idset import IdSet
from hannoy_tpu_torch.version import CURRENT_VERSION

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

REPO = Path(__file__).resolve().parents[1]
BACKENDS = ["python", "native"]
PACKAGES = {"jax": jax_store, "torch": store}


def _open(pkg: str, backend: str, path, **kw):
    mod = PACKAGES[pkg]
    return (mod.Env if backend == "python" else mod.NativeEnv)(path, **kw)


def _scan(env, name=None):
    db = env.create_database(None, name)
    return list(db.prefix_iter(env.read_txn(), b""))


def _workload(env, seed=7):
    """Puts, deletes, commits, an abort and a compaction, from a seed."""
    rng = np.random.default_rng(seed)
    main = env.create_database(None, None)
    other = env.create_database(None, "other")

    def val():
        return rng.integers(0, 256, size=int(rng.integers(1, 200)), dtype=np.uint8).tobytes()

    with env.write_txn() as w:
        for i in rng.permutation(300).tolist():
            main.put(w, schema.Key.item(0, i).to_bytes(), val())
        for i in range(40):
            other.put(w, schema.Key.links(1, i, 0).to_bytes(), val())
    with env.write_txn() as w:
        for i in range(0, 300, 3):
            assert main.delete(w, schema.Key.item(0, i).to_bytes())
        for i in range(100, 140):
            main.put(w, schema.Key.item(0, i).to_bytes(), val())
    w = env.write_txn()
    main.put(w, schema.Key.item(9, 9).to_bytes(), b"never committed")
    w.abort()
    env.compact()
    with env.write_txn() as w:
        keys = schema.keys_bytes(2, schema.NodeMode.ITEM, np.arange(50, dtype=np.uint32))
        rows = rng.integers(0, 256, size=(50, 12), dtype=np.uint8)
        vbuf, offs = schema.items_payload(rows[:, :4], rows[:, 4:])
        main.put_many_raw(w, keys.tobytes(), vbuf, offs)
        ku, _ = main.scan_fixed(w, schema.Prefix.item(2), 15)
        main.delete_many(w, ku[::5])


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_operations_same_scans_and_log(tmp_path, backend):
    scans, logs = {}, {}
    for pkg in PACKAGES:
        env = _open(pkg, backend, tmp_path / pkg)
        _workload(env)
        scans[pkg] = (_scan(env), _scan(env, "other"))
        env.close()
        logs[pkg] = (tmp_path / pkg / "hannoy.log").read_bytes()
    assert len(scans["torch"][0]) == 200 + 13 + 40 and len(scans["torch"][1]) == 40
    assert scans["torch"] == scans["jax"]
    # the log is a deterministic function of the committed batches
    assert logs["torch"] == logs["jax"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_each_package_reopens_the_others_directory(tmp_path, backend, writer, reader):
    env = _open(writer, backend, tmp_path / "db")
    _workload(env)
    want = (_scan(env), _scan(env, "other"))
    env.close()  # one exclusive lock per path
    for reopen_backend in BACKENDS:
        env2 = _open(reader, reopen_backend, tmp_path / "db")
        assert (_scan(env2), _scan(env2, "other")) == want
        env2.close()
    # and the reader's package can go on writing to it
    env3 = _open(reader, backend, tmp_path / "db")
    db = env3.create_database(None, None)
    with env3.write_txn() as w:
        db.put(w, schema.Key.item(7, 7).to_bytes(), b"appended")
    env3.close()
    env4 = _open(writer, backend, tmp_path / "db")
    assert env4.create_database(None, None).get(env4.read_txn(), schema.Key.item(7, 7).to_bytes()) == b"appended"
    env4.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_tail_is_truncated_on_reopen(tmp_path, backend):
    env = store.open_env(tmp_path / "db", backend=backend)
    db = env.create_database(None, None)
    with env.write_txn() as w:
        db.put(w, b"good::ok", b"1")
    env.close()
    log = tmp_path / "db" / "hannoy.log"
    size = log.stat().st_size
    with open(log, "ab") as f:
        f.write(b"HNYT\x01\x00\x00\x10\x00partial-garbage")
    env2 = store.open_env(tmp_path / "db", backend=backend)
    assert env2.create_database(None, None).get(env2.read_txn(), b"good::ok") == b"1"
    env2.close()
    assert log.stat().st_size == size


@pytest.mark.parametrize("backend", BACKENDS)
def test_database_full_then_clean_abort(tmp_path, backend):
    env = store.open_env(tmp_path / "small", map_size=4096, backend=backend)
    db = env.create_database(None, None)
    with env.write_txn() as w:
        db.put(w, schema.Key.item(0, 0).to_bytes(), b"kept")
    w = env.write_txn()
    with pytest.raises(errors.DatabaseFull):
        for i in range(1, 200):
            db.put(w, schema.Key.item(0, i).to_bytes(), b"x" * 64)
    w.abort()
    assert _scan(env) == [(schema.Key.item(0, 0).to_bytes(), b"kept")]
    with env.write_txn() as w:  # the environment is still usable
        db.put(w, schema.Key.item(0, 1).to_bytes(), b"after")
    env.close()
    env2 = store.open_env(tmp_path / "small", map_size=4096, backend=backend)
    assert len(_scan(env2)) == 2
    env2.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_readonly_snapshot_sees_later_commit_after_refresh(tmp_path, backend):
    env = store.open_env(tmp_path / "db", backend=backend)
    db = env.create_database(None, None)
    with env.write_txn() as w:
        db.put(w, schema.Key.item(0, 1).to_bytes(), b"first")
    # no lock is taken: the snapshot coexists with the live writer
    ro = store.open_env(tmp_path / "db", backend=backend, readonly=True)
    assert isinstance(ro, store.Env) and ro.readonly
    assert len(_scan(ro)) == 1
    with env.write_txn() as w:
        db.put(w, schema.Key.item(0, 2).to_bytes(), b"second")
    assert len(_scan(ro)) == 1  # the snapshot is stable
    assert ro.refresh() is True
    assert [v for _, v in _scan(ro)] == [b"first", b"second"]
    assert ro.refresh() is False
    with pytest.raises(errors.StoreError):
        ro.write_txn()
    ro.close()
    env.close()


def test_open_env_has_no_auto_backend(tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        store.open_env(tmp_path / "db", backend="auto")
    # a native build that fails raises; nothing switches to the Python engine
    monkeypatch.setattr(native_env, "_LIB", None)
    monkeypatch.setattr(native_env, "SOURCE", tmp_path / "missing.cpp")
    (tmp_path / "missing.cpp").write_text("this is not C++")
    monkeypatch.setattr(native_env, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(errors.StoreError):
        store.open_env(tmp_path / "db2")
    env = store.open_env(tmp_path / "db3", backend="python")
    assert isinstance(env, store.Env)
    env.close()


def test_native_library_builds_under_the_ports_build_dir(tmp_path):
    """In a process that imports only the port: the library is built from
    the port's source into ``hannoy_tpu_torch/_build/`` and nothing is
    loaded from the JAX package's tree."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hannoy_tpu'] = None\n"
        "from hannoy_tpu_torch.store import native_env, open_env\n"
        f"env = open_env({str(tmp_path / 'db')!r}, backend='native')\n"
        "db = env.create_database(None, None)\n"
        "with env.write_txn() as w: db.put(w, b'12345678', b'v')\n"
        "env.close()\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = sorted({l.split()[-1] for l in maps.splitlines() if 'hannoykv' in l})\n"
        "print(native_env.library_path()); print(*libs)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, check=True, timeout=300, capture_output=True, text=True
    ).stdout.split("\n")
    built, loaded = Path(out[0]), out[1].split()
    assert built.parent == REPO / "hannoy_tpu_torch" / "_build" and built.exists()
    assert loaded == [str(built)]
    assert not list((REPO / "hannoy_tpu_torch" / "store").rglob("*.so"))


def test_schema_codecs_byte_equal_on_seeded_inputs():
    rng = np.random.default_rng(11)
    items = np.unique(rng.integers(0, 2**32, size=500, dtype=np.uint64)).astype(np.uint32)
    for mode in schema.NodeMode:
        for layer in (0, 3):
            got = schema.keys_bytes(5, mode, items, layer=layer)
            want = jax_schema.keys_bytes(5, jax_schema.NodeMode(int(mode)), items, layer=layer)
            assert got.tobytes() == want.tobytes()
            assert got[0].tobytes() == jax_schema.Key(5, jax_schema.NodeMode(int(mode)), int(items[0]), layer).to_bytes()
    key = schema.Key.links(65535, 0xFFFFFFFF, 7)
    assert key.to_bytes() == jax_schema.Key.links(65535, 0xFFFFFFFF, 7).to_bytes()
    assert schema.Key.from_bytes(key.to_bytes()) == key
    for p in ("all", "item", "links", "updated"):
        assert getattr(schema.Prefix, p)(3) == getattr(jax_schema.Prefix, p)(3)

    headers = rng.integers(0, 256, size=(64, 4), dtype=np.uint8)
    rows = rng.integers(0, 256, size=(64, 128), dtype=np.uint8)
    (gv, go), (wv, wo) = schema.items_payload(headers, rows), jax_schema.items_payload(headers, rows)
    assert bytes(gv) == bytes(wv) and np.array_equal(go, wo)
    assert bytes(gv)[: int(go[1])] == jax_schema.encode_item(headers[0].tobytes(), rows[0].tobytes())
    assert schema.decode_item(bytes(gv)[: int(go[1])]) == (headers[0].tobytes(), rows[0].tobytes())

    table = np.where(rng.random((64, 16)) < 0.7, rng.integers(0, 2**32, size=(64, 16)), -1).astype(np.int64)
    (gv, go), (wv, wo) = schema.links_payload(table), jax_schema.links_payload(table)
    assert bytes(gv) == bytes(wv) and np.array_equal(go, wo)
    row0 = table[0][table[0] >= 0].astype(np.uint32)
    assert schema.encode_links(row0) == jax_schema.encode_links(row0)
    assert schema.decode_links(schema.encode_links(row0)).to_array().tolist() == sorted(set(row0.tolist()))

    ids = IdSet(np.concatenate([np.arange(1000, 5000), items]))
    md = schema.Metadata(
        dimensions=768, items=ids, distance="cosine", entry_points=[1, 0xFFFFFFFF], max_level=3, m=16, m0=32
    )
    want_md = jax_schema.Metadata(
        dimensions=768, items=JaxIdSet(ids.to_array()), distance="cosine",
        entry_points=[1, 0xFFFFFFFF], max_level=3, m=16, m0=32,
    )
    assert md.to_bytes() == want_md.to_bytes()
    back = schema.Metadata.from_bytes(want_md.to_bytes())
    assert back.items == ids and back.entry_points == [1, 0xFFFFFFFF] and back.m0 == 32
    for status in schema.UpdateStatus:
        enc = schema.encode_update_status(status)
        assert enc == jax_schema.encode_update_status(jax_schema.UpdateStatus(int(status)))
        assert schema.decode_update_status(enc) == status
    enc = schema.encode_version(CURRENT_VERSION)
    assert enc == jax_schema.encode_version(jax_schema.decode_version(enc))
    assert schema.decode_version(enc) == CURRENT_VERSION
