"""Deletions with repair in the port against the JAX package, on the CPU.

* ``repair_deleted_rows`` and ``clear_slots`` on device graphs both
  packages make from the same arrays, with the same owner block and
  deleted mask: link ids equal exactly, distances to 1e-5 absolute plus
  1e-6 relative (summation order);
* the Writers: both packages delete k items and add k from copies of one
  store (1500 x 32 cosine) and must leave equal records under every key —
  with k = 50, with a delete set that holds every entry point, and with
  every item deleted. The JAX package rounds reloaded link distances
  through bf16 (``models.hnsw._SYNC_BF16``); the tests switch that off,
  as the append parity tests do. Below 16,384 active items the insertion
  seeding is the reference's, so the builds agree row for row;
* the JAX package's own deletion cases (``tests/test_builder.py``,
  ``tests/test_api.py``, ``tests/test_snapshots.py``) run on the port.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hannoy_tpu
import hannoy_tpu.models.hnsw as jax_hnsw
from hannoy_tpu.build import wave_ops as jax_wave_ops
from hannoy_tpu.ops import distances as jax_distances
import hannoy_tpu_torch
from hannoy_tpu_torch import Database, Metric
from hannoy_tpu_torch.build import builder, wave_ops
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, codecs, distances
from hannoy_tpu_torch.store import schema

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, EF = 1500, 32, 8, 32
K_CHURN = 50


def _data(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _scan(db) -> list[tuple[bytes, bytes]]:
    return list(db._db.prefix_iter(db._env.read_txn(), b""))


def _open(pkg, path, **kw):
    if pkg is hannoy_tpu_torch:
        kw.setdefault("device", "cpu")
    return pkg.Database(path, pkg.Metric.COSINE, **kw)


def _jax_host(tg: hnsw.HostGraph) -> jax_hnsw.HostGraph:
    """The JAX package's ``HostGraph`` holding copies of the port's arrays."""
    return jax_hnsw.HostGraph(
        metric=jax_distances.by_name(tg.metric.name), dimensions=tg.dimensions, m=tg.m, m0=tg.m0,
        ids=tg.ids.copy(), levels=tg.levels.copy(), vectors=tg.vectors.copy(), norms=tg.norms.copy(),
        links0=tg.links0.copy(), dists0=tg.dists0.copy(),
        upper_links=[a.copy() for a in tg.upper_links], upper_dists=[a.copy() for a in tg.upper_dists],
        slot_rows=[a.copy() for a in tg.slot_rows], upper_row_count=list(tg.upper_row_count),
        entry_slots=list(tg.entry_slots), max_level=tg.max_level, id_to_slot=dict(tg.id_to_slot),
        free_slots=list(tg.free_slots), next_fresh=tg.next_fresh,
    )


def _device_state(jdev) -> dict:
    return {
        f: np.asarray(getattr(jdev, f))
        for f in ("vectors", "norms", "links0", "dists0", "upper_links", "upper_dists", "slot_rows", "entry_slots", "valid")
    } | {"metric_name": jdev.metric_name, "max_level": jdev.max_level}


def _stage(data, name="cosine", m=M, m0=2 * M):
    metric = distances.by_name(name)
    n = len(data)
    g = hnsw.HostGraph.empty(metric, data.shape[1], m, m0, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(metric, data)
    return g, np.arange(n, dtype=np.int64)


def _opts(**kw):
    return builder.BuildOptions(ef_construction=EF, wave_size=128, bulk=False, **kw)


def _assert_close(got, want):
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-5)


# --------------------------------------------------------------------------
# (a) the device steps
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """A port wave build of 1500 x 32 cosine, and 150 slots to delete that
    include every entry point."""
    g, slots = _stage(_data())
    builder.build_graph(g, slots, np.empty(0, np.int64), _opts(), device="cpu")
    rng = np.random.default_rng(3)
    doomed = np.union1d(rng.choice(N, 150, replace=False), g.entry_slots).astype(np.int64)
    return g, doomed


def _owners(g, level: int, deleted: np.ndarray) -> np.ndarray:
    """Owners at ``level`` whose row links a deleted slot (the JAX
    package's host scan)."""
    if level == 0:
        table, owners = g.links0, np.arange(g.capacity)
    else:
        table = g.upper_links[level - 1]
        owners = np.full(table.shape[0], -1, dtype=np.int64)
        rows = g.slot_rows[level - 1]
        own = np.nonzero(rows >= 0)[0]
        owners[rows[own]] = own
    hit = ((table >= 0) & deleted[np.maximum(table, 0)]).any(axis=1)
    out = owners[np.nonzero(hit)[0]]
    return out[(out >= 0) & ~deleted[np.maximum(out, 0)]]


@pytest.mark.parametrize("level", [0, 1])
def test_repair_deleted_rows_and_clear_slots_match_jax(built, level):
    g, doomed = built
    assert g.max_level >= 1
    jg = _jax_host(g)
    deleted = np.zeros(g.capacity, dtype=bool)
    deleted[doomed] = True
    owners = _owners(g, level, deleted)
    assert len(owners) >= (100 if level == 0 else 10)
    block = np.full(builder.REPAIR_BLOCK, -1, dtype=np.int32)
    block[: min(len(owners), builder.REPAIR_BLOCK)] = owners[: builder.REPAIR_BLOCK]
    cap = g.m0 if level == 0 else g.m

    jdev = jax_hnsw.to_device(jg, cache=False)
    state = _device_state(jdev)
    jdev = jax_wave_ops.repair_deleted_rows(
        jdev, jnp.asarray(block), jnp.asarray(deleted), jnp.int32(level), is_level0=(level == 0), cap=cap, alpha=1.0
    )
    tdev = hnsw.device_graph_from_arrays("cpu", **state)
    wave_ops.repair_deleted_rows(tdev, torch.from_numpy(block), torch.from_numpy(deleted), level, cap=cap, alpha=1.0)

    np.testing.assert_array_equal(tdev.links0.numpy(), np.asarray(jdev.links0))
    np.testing.assert_array_equal(tdev.upper_links.numpy(), np.asarray(jdev.upper_links))
    _assert_close(tdev.dists0.numpy(), np.asarray(jdev.dists0))
    _assert_close(tdev.upper_dists.numpy(), np.asarray(jdev.upper_dists))
    # the repaired rows lost every deleted id
    repaired = torch.from_numpy(block[block >= 0].astype(np.int64))
    rows = beam.links_at(tdev, level, repaired.to(torch.int32)).numpy()
    assert not deleted[rows[rows >= 0]].any()

    doomed32 = doomed.astype(np.int32)
    jdev = jax_wave_ops.clear_slots(jdev, jnp.asarray(doomed32))
    wave_ops.clear_slots(tdev, torch.from_numpy(doomed32))
    np.testing.assert_array_equal(tdev.valid.numpy(), np.asarray(jdev.valid))
    np.testing.assert_array_equal(tdev.links0.numpy(), np.asarray(jdev.links0))
    _assert_close(tdev.dists0.numpy(), np.asarray(jdev.dists0))


def test_repair_splices_through_the_deleted_rows_kernel_shape(built):
    """The spliced candidates' distances are one gather-distance call of
    [REPAIR_BLOCK, ext_cap] per block (the kernel's shape on the card)."""
    from hannoy_tpu_torch.ops import beam_cuda

    g, doomed = built
    deleted = np.zeros(g.capacity, dtype=bool)
    deleted[doomed] = True
    block = np.full(builder.REPAIR_BLOCK, -1, dtype=np.int32)
    owners = _owners(g, 0, deleted)[: builder.REPAIR_BLOCK]
    block[: len(owners)] = owners
    shapes = []
    real = beam_cuda.gathered_distances

    def spy(metric, vectors, norms, q, qn, idx):
        shapes.append(tuple(idx.shape))
        return real(metric, vectors, norms, q, qn, idx)

    mp = pytest.MonkeyPatch()
    mp.setattr(beam_cuda, "gathered_distances", spy)
    try:
        wave_ops.repair_deleted_rows(
            hnsw.to_device(g, "cpu"), torch.from_numpy(block), torch.from_numpy(deleted), 0, cap=g.m0, alpha=1.0
        )
    finally:
        mp.undo()
    assert shapes == [(builder.REPAIR_BLOCK, 64)]


# --------------------------------------------------------------------------
# (b) both Writers: delete + add from copies of one store
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_store(tmp_path_factory):
    """A committed 1500 x 32 cosine store (the port's Writer writes the
    JAX Writer's bytes, tests/test_torch_api.py) and its entry points."""
    path = tmp_path_factory.mktemp("base")
    db = _open(hannoy_tpu_torch, path)
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    eps = schema.Metadata.from_bytes(db._db.get(db._env.read_txn(), schema.Key.metadata(0).to_bytes())).entry_points
    db.close()
    return path, [int(e) for e in eps]


def _churn(case: str, eps: list[int]) -> tuple[list[int], np.ndarray, np.ndarray]:
    """(ids to delete, ids to add, their vectors) of a Writer case."""
    rng = np.random.default_rng(44)
    if case == "everything":
        doomed = list(range(N))
    else:
        doomed = sorted({int(i) for i in rng.choice(N, K_CHURN, replace=False)} | (set(eps) if case == "entry_points" else set()))
    new_ids = np.arange(N, N + K_CHURN)
    return doomed, new_ids, _data(K_CHURN, seed=45)


@pytest.mark.parametrize("case", ["k50", "entry_points", "everything"])
def test_delete_and_add_write_the_jax_writers_records(tmp_path, base_store, monkeypatch, case):
    monkeypatch.setattr(jax_hnsw, "_SYNC_BF16", False)
    path0, eps = base_store
    doomed, new_ids, vecs = _churn(case, eps)
    scans = {}
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        path = shutil.copytree(path0, tmp_path / pkg.__name__)
        db = _open(pkg, path)
        w = db.writer(D, m=M, ef=EF)
        assert all(w.del_item(i) for i in doomed)
        w.add_items(new_ids, vecs)
        stats = w.builder(seed=42).build()
        assert db.commit_rw_txn()
        scans[pkg] = _scan(db)
        if pkg is hannoy_tpu_torch:
            r = db.reader()
            r.assert_validity()
            assert r.n_items() == N - len(doomed) + K_CHURN
            assert not set(doomed) & {int(i) for i in r.item_ids()}
            assert not set(doomed) & set(r._metadata.entry_points)
            touched_ids = {int(r._graph.ids[s]) for s in stats.touched}
            assert not touched_ids & set(doomed)
            hits = [row[0][0] for row in r.by_vecs(vecs, n=1, ef_search=64)]
            assert hits == new_ids.tolist()
        db.close()
    got, want = scans[hannoy_tpu_torch], scans[hannoy_tpu]
    assert [k for k, _ in got] == [k for k, _ in want]
    differing = [schema.Key.from_bytes(k) for (k, g_), (_, w_) in zip(got, want) if g_ != w_]
    assert not differing, (len(differing), len(want), differing[:5])


def test_delete_everything_writes_the_jax_writers_records(tmp_path, base_store):
    """Everything deleted and nothing added: both Writers leave the same
    empty index (no links, no items, no entry points)."""
    path0, _ = base_store
    scans = {}
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        db = _open(pkg, shutil.copytree(path0, tmp_path / pkg.__name__))
        w = db.writer(D, m=M, ef=EF)
        for i in range(N):
            w.del_item(i)
        w.builder(seed=42).build()
        db.commit_rw_txn()
        scans[pkg] = _scan(db)
        r = db.reader()
        assert r.is_empty() and r.by_vec(np.zeros(D, np.float32), n=5) == []
        db.close()
    assert scans[hannoy_tpu_torch] == scans[hannoy_tpu]
    keys = {schema.Key.from_bytes(k) for k, _ in scans[hannoy_tpu_torch]}
    assert keys == {schema.Key.metadata(0), schema.Key.version(0)}  # no items, no links, no journal


# --------------------------------------------------------------------------
# (c) the JAX package's deletion cases on the port
# --------------------------------------------------------------------------


def _recall(g, queries, k=10, ef=100):
    metric = g.metric
    dev = hnsw.to_device(g, "cpu", serve_only=True)
    packed = codecs.pack(queries, metric.codec)
    qn = distances.np_norms(metric, packed)
    res = beam.hnsw_search(dev, torch.from_numpy(packed), torch.from_numpy(qn), ef)
    live = np.nonzero(g.valid_mask())[0]
    exact = distances.np_pairwise(metric, packed, qn, g.vectors[live], g.norms[live])
    kth = np.sort(exact, axis=1)[:, k - 1 : k] + 1e-5
    return float((res.dists.numpy()[:, :k] <= kth).mean())


def _build(g, insert, deleted, wave=128):
    return builder.build_graph(g, np.asarray(insert, np.int64), np.asarray(deleted, np.int64),
                               builder.BuildOptions(wave_size=wave), device="cpu")


def test_delete_then_build_repairs():
    """tests/test_builder.py:123 — no link to a deleted slot survives
    anywhere, and recall holds after the repair."""
    rng = np.random.default_rng(42)
    n, d = 1000, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    g, slots = _stage(data, "euclidean", m=12, m0=24)
    _build(g, slots, [])
    doomed = slots[rng.choice(n, size=200, replace=False)]
    stats = _build(g, [], doomed)
    assert len(stats.touched) and not set(stats.touched.tolist()) & set(doomed.tolist())
    for s in doomed:
        g.release_slot(int(s))
    g.check_validity()
    doomed_set = {int(x) for x in doomed}
    assert not set(g.entry_slots) & doomed_set
    for s in np.nonzero(g.valid_mask())[0]:
        for level in range(int(g.levels[s]) + 1):
            assert not set(g.links_of(int(s), level).tolist()) & doomed_set
    rec = _recall(g, rng.standard_normal((16, d)).astype(np.float32))
    assert rec >= 0.9, f"post-delete recall {rec}"


def test_delete_entry_points():
    """tests/test_builder.py:147 — deleting every entry point replaces
    them from the layers below."""
    rng = np.random.default_rng(42)
    data = rng.standard_normal((500, 16)).astype(np.float32)
    g, slots = _stage(data, "euclidean", m=12, m0=24)
    _build(g, slots, [])
    doomed = np.asarray(sorted(g.entry_slots), dtype=np.int64)
    _build(g, [], doomed)
    for s in doomed:
        g.release_slot(int(s))
    g.check_validity()
    assert g.entry_slots and not set(g.entry_slots) & set(doomed.tolist())


def test_delete_everything():
    """tests/test_builder.py:162 — delete-all leaves an empty, consistent
    graph of height 0."""
    rng = np.random.default_rng(42)
    data = rng.standard_normal((200, 8)).astype(np.float32)
    g, slots = _stage(data, "euclidean", m=4, m0=8)
    _build(g, slots, [], wave=64)
    _build(g, [], slots, wave=64)
    for s in slots:
        g.release_slot(int(s))
    assert g.n_items == 0 and g.max_level == 0


@pytest.fixture
def db(tmp_path):
    d = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    yield d
    d.close()


def _fill(db, n, d, seed=0, m=8):
    data = _data(n, d, seed)
    with db.writer(d, m=m, ef=48) as w:
        w.add_items(range(n), data)
    return data


def test_delete_items(db):
    """tests/test_api.py:137."""
    data = _fill(db, 200, 8)
    w = db.writer(8, m=8, ef=48)
    for i in range(50):
        assert w.del_item(i)
    assert not w.del_item(12345)
    w.builder().build()
    db.commit_rw_txn()
    reader = db.reader()
    reader.assert_validity()  # no dangling edge to a deleted item
    assert reader.n_items() == 150 and not reader.contains_item(3)
    assert all(i >= 50 for i, _ in reader.by_vec(data[7], n=5, ef_search=64))


def test_delete_everything_then_search(db):
    """tests/test_api.py:153."""
    _fill(db, 60, 8)
    w = db.writer(8, m=8)
    for i in range(60):
        w.del_item(i)
    w.builder().build()
    db.commit_rw_txn()
    reader = db.reader()
    assert reader.n_items() == 0 and reader.is_empty()
    assert reader.by_vec(np.zeros(8, np.float32), n=5) == []


def test_delete_all_then_reinsert(db):
    """tests/test_api.py:167."""
    _fill(db, 60, 8)
    w = db.writer(8, m=8)
    for i in range(60):
        w.del_item(i)
    data = _data(30, 8, seed=1)
    w.add_items(range(100, 130), data)
    w.builder().build()
    db.commit_rw_txn()
    reader = db.reader()
    reader.assert_validity()
    assert reader.n_items() == 30
    assert reader.by_vec(data[3], n=1)[0][0] == 103


def test_incremental_insert_with_deleted_descent_hub(tmp_path):
    """tests/test_api.py:747 — inserts whose descent settles near deleted
    slots still get forward links and stay searchable."""
    rng = np.random.default_rng(42)
    d = 32
    db = Database(tmp_path / "ddh", Metric.EUCLIDEAN, device="cpu")
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    data = (centers[rng.integers(0, 8, 1200)] + rng.standard_normal((1200, d))).astype(np.float32)
    with db.writer(dimensions=d, m=8, ef=48) as w:
        w.add_items(range(1200), data)
    near = np.argsort((data**2).sum(1))[:40]
    extra = (rng.standard_normal((16, d)) * 0.5).astype(np.float32)
    with db.writer(dimensions=d, m=8, ef=48) as w:
        w.add_items(range(1200, 1216), extra)
        for i in near:
            w.del_item(int(i))
    r = db.reader()
    rows = r.by_vecs(extra, n=3, ef_search=128)
    miss = [j for j, row in enumerate(rows) if (1200 + j) not in [t[0] for t in row]]
    assert not miss, f"unreachable inserts {miss}"
    g = r._graph
    live = np.nonzero(g.levels >= 0)[0]
    lr = g.links0[live]
    assert ((lr >= 0).sum(axis=1) > 0).all(), "live row with empty forward links"
    assert (np.bincount(lr[lr >= 0], minlength=g.capacity)[live] > 0).all()
    db.close()


def _state(db) -> tuple[schema.Metadata, dict[tuple[int, int], set[int]], set[int]]:
    """(metadata, links per (item, layer), item ids) of index 0."""
    txn = db._env.read_txn()
    md = schema.Metadata.from_bytes(db._db.get(txn, schema.Key.metadata(0).to_bytes()))
    links, items = {}, set()
    for k, v in db._db.prefix_iter(txn, schema.Prefix.all(0)):
        key = schema.Key.from_bytes(k)
        if key.mode == schema.NodeMode.LINKS:
            links[(key.item, key.layer)] = set(schema.decode_links(v).to_array().tolist())
        elif key.mode == schema.NodeMode.ITEM:
            items.add(key.item)
    return md, links, items


def _referencing(links, item: int) -> list:
    return [k for k, ids in links.items() if item in ids]


def test_delete_one_item_in_a_one_item_db(tmp_path):
    """tests/test_snapshots.py:163."""
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    with db.writer(3, m=4, ef=16) as w:
        w.add_item(0, [0.0, 1.0, 2.0])
    with db.writer(3, m=4, ef=16) as w:
        assert w.del_item(0)
    md, links, items = _state(db)
    assert not len(md.items) and md.entry_points == [] and not links and not items
    assert db.reader().is_empty()
    db.close()


def test_delete_document_in_an_empty_index_74(tmp_path):
    """tests/test_snapshots.py:177 — deleting from an empty index."""
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    with db.writer(3, m=4, ef=16) as w:
        assert not w.del_item(42)
    md, _, _ = _state(db)
    assert not len(md.items)
    with db.writer(3, m=4, ef=16) as w:
        w.add_item(1, [1.0, 0.0, 0.0])
    assert db.reader().by_vec([1.0, 0.0, 0.0], n=1)[0][0] == 1
    db.close()


def test_delete_all_but_one_item_and_build(tmp_path):
    """tests/test_snapshots.py:192 — mass deletion down to one item."""
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    data = _data(25, 4, seed=2)
    with db.writer(4, m=4, ef=16) as w:
        w.add_items(range(25), data)
    with db.writer(4, m=4, ef=16) as w:
        for i in range(1, 25):
            assert w.del_item(i)
    md, links, items = _state(db)
    assert list(md.items) == [0] and md.entry_points == [0] and items == {0}
    assert all(not _referencing(links, i) for i in range(1, 25))
    db.reader().assert_validity()
    assert [i for i, _ in db.reader().by_vec(data[0], n=5)] == [0]
    db.close()


def test_delete_one_item_cascades(tmp_path):
    """tests/test_snapshots.py:253 — the deleted item leaves every row,
    and two identical runs write identical stores."""

    def run(p):
        db = Database(p, Metric.EUCLIDEAN, device="cpu")
        data = _data(40, 4, seed=3)
        with db.writer(4, m=4, ef=24) as w:
            w.add_items(range(40), data)
        _, pre, _ = _state(db)
        assert _referencing(pre, 3)
        with db.writer(4, m=4, ef=24) as w:
            assert w.del_item(3)
        db.reader().assert_validity()
        post = _scan(db)
        md, links, items = _state(db)
        db.close()
        return post, links, items

    a, links, items = run(tmp_path / "a")
    b, _, _ = run(tmp_path / "b")
    assert a == b
    assert 3 not in items and not _referencing(links, 3) and not any(k[0] == 3 for k in links)


def test_delete_items_one_by_one(tmp_path):
    """tests/test_snapshots.py:279 — one build per deletion; every
    intermediate index stays valid and loses the deleted id."""
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    n = 12
    with db.writer(4, m=4, ef=16) as w:
        w.add_items(range(n), _data(n, 4, seed=4))
    for i in range(n):
        with db.writer(4, m=4, ef=16) as w:
            assert w.del_item(i)
        _, links, items = _state(db)
        assert i not in items and not _referencing(links, i)
        r = db.reader()
        assert r.n_items() == n - 1 - i
        if not r.is_empty():
            r.assert_validity()
    assert db.reader().is_empty()
    db.close()
