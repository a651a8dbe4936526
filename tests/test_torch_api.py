"""The port's Database / Writer / Reader against the JAX package's, on the
CPU (``device="cpu"``), at 1500 x 32 with inputs made from numpy seeds.

The store is the artefact the two packages share, so parity is held on
it: the same ``add_items`` + ``build()`` through both Writers must leave
equal records under every key (items, links, metadata, version), fresh
and after close -> reopen -> append, and either Reader must answer from a
store the other package wrote.

Tolerances. Builds at this size agree record for record (near-ties of f32
sums taken in another order could flip a link, and none does on these
seeds), so the store comparisons are exact. Search distances agree to
1e-5 absolute (cosine distances are unit-scale) plus 1e-6 relative (the
squared euclidean distances here are near 40, where one f32 ulp is
3.8e-6), ids and flags exactly. The JAX
package rounds link distances through bf16 whenever it downloads them
(``models.hnsw._SYNC_BF16``, also after ``fill_link_dists`` on the reopen
route), and the port keeps f32: the append comparisons switch that
rounding off in the JAX package, and one test holds an append inside the
building transaction by validity and recall instead.
"""

import inspect
import shutil

import numpy as np
import pytest
import torch

import hannoy_tpu
import hannoy_tpu.models.hnsw as jax_hnsw
import hannoy_tpu_torch
from hannoy_tpu_torch import Database, Metric, api, errors
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import distances
from hannoy_tpu_torch.store import schema
from hannoy_tpu_torch.utils import tracing

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, EF = 1500, 32, 8, 32
N_APPEND = 200
BACKENDS = ["native", "python"]


def _data(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _scan(db) -> list[tuple[bytes, bytes]]:
    """Every committed record of a Database handle of either package."""
    return list(db._db.prefix_iter(db._env.read_txn(), b""))


def _by_mode(scan, mode: schema.NodeMode) -> dict[bytes, bytes]:
    return {k: v for k, v in scan if schema.Key.from_bytes(k).mode == mode}


def _open(pkg, path, name, **kw):
    if pkg is hannoy_tpu_torch:
        kw.setdefault("device", "cpu")
    return pkg.Database(path, pkg.Metric(name), **kw)


def _write(pkg, path, name, ids, vectors, bulk=None, **kw):
    """add_items + build + commit through ``pkg``'s Writer; the Database
    is left open."""
    db = _open(pkg, path, name, **kw)
    w = db.writer(D, m=M, ef=EF)
    w.add_items(ids, vectors)
    stats = w.builder(seed=42).bulk(bulk).build()
    assert db.commit_rw_txn()
    return db, stats


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """(name, n) -> (closed directory the JAX Writer built, its full scan)."""
    made = {}

    def get(name, n=N):
        if (name, n) not in made:
            path = tmp_path_factory.mktemp(f"jax_{name}_{n}")
            db, _ = _write(hannoy_tpu, path, name, np.arange(n), _data(n))
            made[name, n] = (path, _scan(db))
            db.close()
        return made[name, n]

    return get


@pytest.fixture
def f32_link_dists(monkeypatch):
    monkeypatch.setattr(jax_hnsw, "_SYNC_BF16", False)


# --------------------------------------------------------------------------
# (a) fresh build: equal records under every key
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name, backend, n",
    [("cosine", "native", N), ("cosine", "python", N), ("euclidean", "native", 300), ("manhattan", "python", 300)],
)
def test_fresh_build_writes_the_jax_writers_records(tmp_path, jax_store, name, backend, n):
    """Cosine at full size; the other two metrics at 300 items (the exact
    bootstrap candidates only), where the JAX package compiles far fewer
    programs — whole wave builds of all three are held in test_torch_build."""
    _, want = jax_store(name, n)
    db, stats = _write(hannoy_tpu_torch, tmp_path / "t", name, np.arange(n), _data(n), backend=backend)
    got = _scan(db)
    db.reader().assert_validity()
    db.close()
    assert len(stats.touched) == n
    for mode in schema.NodeMode:
        g, w = _by_mode(got, mode), _by_mode(want, mode)
        assert g.keys() == w.keys(), mode
        differing = [k for k in w if g[k] != w[k]]
        assert not differing, (mode, len(differing), len(w))
    assert len(_by_mode(got, schema.NodeMode.LINKS)) > n  # upper layers too
    assert not _by_mode(got, schema.NodeMode.UPDATED)


# --------------------------------------------------------------------------
# (b) either Reader on a store the other package wrote
# --------------------------------------------------------------------------


def _searched_both(path, name, queries, count=10, ef=64):
    out = []
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        db = _open(pkg, path, name)
        r = db.reader()
        assert r.n_items() == N and r.dimensions() == D
        out.append(r.nns(count).ef_search(ef).by_vectors(queries))
        db.close()  # one exclusive lock per path
    return out


def _assert_searched_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [i for i, _ in g.nns] == [i for i, _ in w.nns]
        np.testing.assert_allclose([d for _, d in g.nns], [d for _, d in w.nns], rtol=1e-6, atol=1e-5)
        assert (g.did_cancel, g.truncated) == (w.did_cancel, w.truncated)


def test_both_readers_agree_on_a_store_the_jax_writer_wrote(tmp_path, jax_store, name="cosine"):
    path = shutil.copytree(jax_store(name)[0], tmp_path / "copy")
    queries = _data(24, seed=5)
    want, got = _searched_both(path, name, queries)
    assert all(len(s.nns) == 10 for s in got)
    _assert_searched_equal(got, want)
    # by_vec / by_vecs are the same search
    db = _open(hannoy_tpu_torch, path, name)
    r = db.reader()
    rows = r.by_vecs(queries, n=10, ef_search=64)
    assert rows == [s.nns for s in got]
    assert r.by_vec(queries[3], n=10, ef_search=64) == rows[3]
    assert r.item_vector(7) == pytest.approx(_data()[7].tolist())
    db.close()


def test_jax_reader_answers_from_a_store_the_port_wrote(tmp_path):
    db, _ = _write(hannoy_tpu_torch, tmp_path / "t", "cosine", np.arange(N), _data())
    db.close()
    want, got = _searched_both(tmp_path / "t", "cosine", _data(24, seed=6))
    _assert_searched_equal(got, want)
    jdb = _open(hannoy_tpu, tmp_path / "t", "cosine")
    jdb.reader().assert_validity()
    jdb.close()


# --------------------------------------------------------------------------
# (c) close -> reopen -> append -> build
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_reopen_append_writes_the_jax_writers_records(tmp_path, jax_store, f32_link_dists, backend):
    """Both packages append to a copy of the same store: ``HostGraph.load``
    -> ``fill_link_dists`` -> incremental build -> flush of the touched
    rows only."""
    extra = _data(N_APPEND, seed=9)
    ids = np.arange(N, N + N_APPEND)
    scans = {}
    for pkg, kw in ((hannoy_tpu, {}), (hannoy_tpu_torch, {"backend": backend})):
        path = shutil.copytree(jax_store("cosine")[0], tmp_path / pkg.__name__)
        db, stats = _write(pkg, path, "cosine", ids, extra, **kw)
        scans[pkg] = _scan(db)
        if pkg is hannoy_tpu_torch:
            assert 0 < len(stats.touched) < N + N_APPEND
            r = db.reader()
            r.assert_validity()
            assert r.n_items() == N + N_APPEND
            hits = [row[0][0] for row in r.by_vecs(extra, n=1, ef_search=64)]
            assert hits == ids.tolist()
        db.close()
    got, want = scans[hannoy_tpu_torch], scans[hannoy_tpu]
    assert [k for k, _ in got] == [k for k, _ in want]
    differing = [k for (k, g), (_, w) in zip(got, want) if g != w]
    assert not differing, (len(differing), len(want))


def test_fill_link_dists_matches_jax(jax_store):
    """The reopen route's device step alone: both packages load the same
    store and recompute the link distances; rows come back sorted."""
    from hannoy_tpu.build import wave_ops as jax_wave_ops
    from hannoy_tpu_torch.build import wave_ops

    path = jax_store("cosine")[0]
    jdb = _open(hannoy_tpu, path, "cosine")
    jr = jdb.reader()
    jg = jr._graph
    jdev = jax_wave_ops.fill_link_dists(jax_hnsw.to_device(jg, cache=False), jg)
    want0, want_up = np.asarray(jdev.dists0), np.asarray(jdev.upper_dists)
    want_l0, want_lup = np.asarray(jdev.links0), np.asarray(jdev.upper_links)
    jdb.close()

    db = _open(hannoy_tpu_torch, path, "cosine")
    g = db.reader()._graph
    db.close()
    assert np.isnan(g.dists0[g.links0 >= 0]).all()  # loaded rows carry ids only
    dev = wave_ops.fill_link_dists(hnsw.to_device(g, "cpu"), g)
    np.testing.assert_array_equal(dev.links0.numpy(), want_l0)
    np.testing.assert_array_equal(dev.upper_links.numpy(), want_lup)
    np.testing.assert_allclose(dev.dists0.numpy(), want0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev.upper_dists.numpy(), want_up, rtol=0, atol=1e-5)
    d0 = dev.dists0.numpy()[:N]
    assert (d0[:, 1:] >= d0[:, :-1]).all() and np.isfinite(d0[:, 0]).all()


def test_append_in_the_same_transaction_is_valid_and_finds_the_new_items(tmp_path):
    """On an index this process has built and committed, a second build
    inside one transaction starts from the first one's graph (the
    transaction's pending graph), which keeps its f32 link distances; the
    JAX package's are bf16-rounded there, so this route is held by validity
    and recall, not record for record."""
    data, extra = _data(), _data(N_APPEND, seed=9)
    half = N_APPEND // 2
    db, _ = _write(hannoy_tpu_torch, tmp_path / "t", "cosine", np.arange(N), data)
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N, N + half), extra[:half])
    with tracing.record() as spans:
        w.builder(seed=42).build()
    assert "load_graph" in {s.name for s in spans}  # a dirty transaction reloads
    w.add_items(np.arange(N + half, N + N_APPEND), extra[half:])
    with tracing.record() as spans:
        stats = w.builder(seed=42).build()
    db.commit_rw_txn()
    assert "load_graph" not in {s.name for s in spans}  # the pending graph served
    assert len(stats.touched) < N + N_APPEND
    r = db.reader()
    r.assert_validity()
    allv = np.concatenate([data, extra])
    queries = _data(64, seed=3)
    exact = distances.np_pairwise(
        distances.COSINE, queries, distances.np_norms(distances.COSINE, queries),
        allv, distances.np_norms(distances.COSINE, allv),
    )
    truth = np.argsort(exact, axis=1)[:, :10]
    rows = r.by_vecs(queries, n=10, ef_search=64)
    recall = np.mean([len(set(truth[b]) & {i for i, _ in rows[b]}) / 10 for b in range(64)])
    assert recall >= 0.95, recall
    assert [row[0][0] for row in r.by_vecs(extra, n=1, ef_search=64)] == list(range(N, N + N_APPEND))
    db.close()


# --------------------------------------------------------------------------
# (d) the bulk path through the Writer
# --------------------------------------------------------------------------


def test_bulk_build_through_both_writers(tmp_path):
    n = 3000
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, 16, size=n)] + rng.standard_normal((n, D))).astype(np.float32)
    jdb, _ = _write(hannoy_tpu, tmp_path / "j", "cosine", np.arange(n), data, bulk=True)
    want = _by_mode(_scan(jdb), schema.NodeMode.LINKS)
    jdb.close()
    with tracing.record() as spans:
        db, stats = _write(hannoy_tpu_torch, tmp_path / "t", "cosine", np.arange(n), data, bulk=True)
    assert "bulk_build" in {s.name for s in spans}
    assert len(stats.touched) == n  # every row the bulk path wrote is flushed
    got = _by_mode(_scan(db), schema.NodeMode.LINKS)
    db.close()
    db = _open(hannoy_tpu_torch, tmp_path / "t", "cosine")  # validity of what reached the disk
    db.reader().assert_validity()
    db.close()
    assert got.keys() == want.keys()
    share = np.mean([got[k] == want[k] for k in want])
    print(f"bulk build through the Writers: identical links records {share:.4f} of {len(want)}")
    assert share >= 0.999


# --------------------------------------------------------------------------
# (e) behaviour
# --------------------------------------------------------------------------


@pytest.fixture
def db(tmp_path):
    d = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    yield d
    d.close()


def _fill(db, n, d, seed=0, index=0, m=8, start_id=0):
    data = _data(n, d, seed)
    with db.writer(d, index=index, m=m, ef=48) as w:
        w.add_items(range(start_id, start_id + n), data)
    return data


def test_database_defaults_to_cuda_and_keeps_the_device(tmp_path):
    assert inspect.signature(Database.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(Database.__init__).parameters["backend"].default == "native"
    d = Database(tmp_path / "x", Metric.COSINE, device=torch.device("cpu"))
    assert d.device == torch.device("cpu")
    with d.writer(2, m=4, ef=10) as w:
        w.add_item(0, [1.0, 0.0])
        w.add_item(1, [0.0, 1.0])
    r = d.reader()
    assert r._dev.vectors.device.type == "cpu"
    assert r.by_vec([1.0, 0.1], n=1)[0][0] == 0
    with pytest.raises(ValueError):
        Database(tmp_path / "x", Metric.COSINE, device="cpu", backend="python")  # open as native
    d.close()
    assert {"Database", "Writer", "Reader", "Metric", "Version", "CURRENT_VERSION", "errors"} <= set(hannoy_tpu_torch.__all__)
    assert [m.value for m in Metric] == [m.value for m in hannoy_tpu.Metric]
    assert [m.distance.name for m in Metric] == [m.distance.name for m in hannoy_tpu.Metric]


def test_unported_names_are_absent():
    for cls, names in ((api.Writer, ["release_device_cache"]),):
        assert not [n for n in names if hasattr(cls, n)]
    # cancellation is ported (tests/test_torch_cancel.py holds it against the JAX Reader and Writer)
    assert all(hasattr(api.QueryBuilder, n) for n in ("by_vector_with_cancellation", "by_vectors_with_cancellation",
                                                      "by_item_with_cancellation", "by_items_with_cancellation"))
    assert hasattr(api.HannoyBuilder, "cancel")
    # the conversions between metrics are ported (tests/test_torch_packed.py holds them against the JAX Writer)
    assert all(hasattr(api.Writer, n) for n in ("prepare_changing_distance", "prepare_foreign_conversion"))
    # filtered and by-item search are ported (tests/test_torch_filter.py holds them against the JAX Reader)
    assert all(hasattr(api.Reader, n) for n in ("by_items", "_brute_force", "_candidate_mask", "_should_linear_scan"))
    assert all(hasattr(api.QueryBuilder, n) for n in ("candidates", "linear_below", "linear_below_ratio", "by_item", "by_items"))
    assert list(inspect.signature(api.Reader.by_vecs).parameters) == ["self", "queries", "n", "ef_search", "candidates", "cancel"]
    assert "cancel" in inspect.signature(api.Reader.by_items).parameters


def test_reader_errors(db, tmp_path):
    with pytest.raises(errors.MissingMetadata):
        db.reader()
    w = db.writer(4, m=4)
    assert w.need_build() and w.is_empty()
    w.add_item(0, [1, 2, 3, 4])
    assert w.need_build() and w.contains_item(0) and not w.contains_item(1)
    w.builder().build()
    assert not w.need_build()
    db.commit_rw_txn()
    w.add_item(1, [4, 3, 2, 1])
    db.commit_rw_txn()  # journaled, not built
    with pytest.raises(errors.NeedBuild):
        db.reader()
    w.builder().build()
    db.commit_rw_txn()
    assert db.reader().n_items() == 2
    db.close()
    other = Database(tmp_path / "db", Metric.COSINE, device="cpu")
    with pytest.raises(errors.UnmatchingDistance):
        other.reader()
    other.close()


def test_invalid_inputs(db):
    w = db.writer(4, m=4)
    with pytest.raises(errors.InvalidVecDimension):
        w.add_item(0, [1, 2, 3])
    with pytest.raises(errors.InvalidVecDimension):
        w.add_items([0, 1], np.zeros((2, 5), np.float32))
    for bad in (-1, 2**32):
        with pytest.raises(errors.InvalidItemAppend):
            w.add_item(bad, [1, 2, 3, 4])
        with pytest.raises(errors.InvalidItemAppend):
            w.add_items([0, bad], np.zeros((2, 4), np.float32))
    for m, m0 in ((0, 8), (256, 300), (8, 4), (8, 256)):
        with pytest.raises(errors.InvalidConfig):
            db.writer(4, m=m, m0=m0)
    with pytest.raises(errors.InvalidConfig):
        db.writer(0)
    _fill(db, 20, 4, m=4)
    with pytest.raises(errors.InvalidVecDimension):
        db.reader().by_vecs(np.zeros((2, 5), np.float32))


def test_abort_discards_and_context_manager_aborts_on_error(db):
    w = db.writer(4, m=4)
    w.add_item(0, [1, 2, 3, 4])
    w.builder().build()
    assert db.abort_rw_txn() and not db.abort_rw_txn() and not db.commit_rw_txn()
    with pytest.raises(errors.MissingMetadata):
        db.reader()
    with pytest.raises(RuntimeError):
        with db.writer(4, m=4) as w:
            w.add_item(0, [1, 2, 3, 4])
            raise RuntimeError("boom")
    assert db.writer(4, m=4).is_empty()


def test_multi_index_isolation_and_u32_max_id(db):
    a = _fill(db, 60, 8, seed=1, index=0)
    _fill(db, 40, 8, seed=2, index=1, start_id=1000)
    w = db.writer(8, index=2, m=4)
    w.add_item(2**32 - 1, np.arange(8))
    w.add_item(0, np.arange(8)[::-1])
    w.builder().build()
    db.commit_rw_txn()
    r0, r1, r2 = db.reader(0), db.reader(1), db.reader(2)
    assert (r0.n_items(), r1.n_items(), r2.n_items()) == (60, 40, 2)
    assert all(i < 60 for i, _ in r0.by_vec(a[3], n=10))
    assert all(i >= 1000 for i, _ in r1.by_vec(a[3], n=10))
    assert r2.by_vec(np.arange(8), n=1)[0][0] == 2**32 - 1
    assert r0.n_nodes() == r1.n_nodes() > 100  # every record of the database
    for r in (r0, r1, r2):
        r.assert_validity()
    assert sorted(i for i, _ in r1.iter()) == list(range(1000, 1040))


def test_overwrite_rewires_the_item(db):
    data = _fill(db, 200, 8, seed=3)
    moved = data[150] + 0.001
    with db.writer(8, m=8, ef=48) as w:
        w.add_item(5, moved)
    r = db.reader()
    r.assert_validity()
    assert r.n_items() == 200
    assert r.item_vector(5) == pytest.approx(moved.tolist())
    assert {i for i, _ in r.by_vec(data[150], n=2)} == {5, 150}


def test_top_up_on_an_index_smaller_than_count(db):
    with db.writer(8, m=4, ef=16) as w:
        for i in range(3):
            v = np.zeros(8, np.float32)
            v[i] = 1.0
            w.add_item(i, v)
    reader = db.reader()
    q = np.zeros((2, 8), np.float32)
    q[0, 0] = 1.0
    q[1, 1] = 1.0
    rows = reader.by_vecs(q, n=10)
    assert all(len(r) == 3 for r in rows)
    single = reader.nns(10).by_vector(q[0])
    assert [i for i, _ in rows[0]] == [i for i, _ in single.nns] and len(single.nns) == 3
    # a row whose beam comes back short finishes with the exact scan
    g = reader._graph
    g.links0[:] = -1
    reader._dev = hnsw.to_device(g, "cpu", serve_only=True)
    rows = reader.by_vecs(q, n=3)
    assert [[i for i, _ in r] for r in rows] == [[0, 1, 2], [1, 0, 2]]


def test_truncated_flag_is_per_row(db):
    """One trapped query must not stamp every row of the batch: a path
    graph (worst case for beam termination) swapped into an open Reader."""
    n, d = 200, 8
    data = np.zeros((n, d), np.float32)
    data[:, 0] = np.arange(n, dtype=np.float32)
    with db.writer(d) as w:
        w.add_items(range(n), data)
    r = db.reader()
    g = hnsw.HostGraph.empty(distances.EUCLIDEAN, d, 4, 8, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
        nbs = [j for j in (i - 1, i + 1) if 0 <= j < n]
        g.links0[i, : len(nbs)] = nbs
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(distances.EUCLIDEAN, data)
    g.levels[:n] = 0
    g.entry_slots = [0]
    r._graph, r._dev = g, hnsw.to_device(g, "cpu", serve_only=True)
    qs = np.zeros((2, d), np.float32)
    qs[0, 0] = float(n - 1)  # hard: the beam walks the chain and hits max_iters
    searched = r.nns(5).ef_search(5).by_vectors(qs)
    assert searched[0].truncated and not searched[1].truncated
    assert len(searched[0].nns) == 5 and len(searched[1].nns) == 5
    assert not any(s.did_cancel for s in searched)


def test_incremental_build_flushes_only_touched_rows(db):
    n = 1200
    data = _fill(db, n, 16, seed=4)
    before = dict(_scan(db))
    w = db.writer(16, m=8, ef=48)
    w.add_items(range(n, n + 10), _data(10, 16, seed=5))
    inner, rows = db._db, []
    orig = inner.put_many_raw

    def counting(txn, kbuf, vbuf, offs):
        rows.append(len(offs) - 1)
        return orig(txn, kbuf, vbuf, offs)

    inner.put_many_raw = counting
    try:
        stats = w.build()
    finally:
        del inner.put_many_raw
    db.commit_rw_txn()
    # 10 inserted rows + their reverse-link destinations, far below n
    assert sum(rows) < n // 2 and len(stats.touched) < n // 2
    after = dict(_scan(db))
    links = lambda s: {k: v for k, v in s.items() if schema.Key.from_bytes(k).mode == schema.NodeMode.LINKS}
    changed = {k for k, v in links(after).items() if before.get(k) != v}
    touched_ids = {int(db.reader()._graph.ids[s]) for s in stats.touched}
    assert {schema.Key.from_bytes(k).item for k in changed} <= touched_ids
    r = db.reader()
    r.assert_validity()
    assert r.nns(3).by_vector(data[5]).nns[0][0] == 5


def test_deleting_a_built_item_and_an_unbuilt_one(db):
    data = _fill(db, 50, 8, seed=6)
    w = db.writer(8, m=8, ef=48)
    w.add_item(900, np.ones(8))
    assert w.del_item(900) and not w.del_item(901)  # never built: no slot to repair
    w.builder().build()
    db.commit_rw_txn()
    r = db.reader()
    assert r.n_items() == 50 and not r.contains_item(900)
    r.assert_validity()
    assert w.del_item(3)
    w.builder().build()
    db.commit_rw_txn()
    r = db.reader()
    r.assert_validity()  # no dangling edge to the deleted item
    assert r.n_items() == 49 and not r.contains_item(3) and r.item_vector(3) is None
    assert not [i for row in r.by_vecs(data, n=10, ef_search=32) for i, _ in row if i == 3]


def test_force_rebuild_and_clear(db):
    data = _fill(db, 300, 8, seed=7)
    before = db.reader().by_vecs(data[:8], n=5, ef_search=32)
    w = db.writer(8, m=8, ef=48)
    w.builder(seed=42).force_rebuild()
    db.commit_rw_txn()
    r = db.reader()
    r.assert_validity()
    assert r.by_vecs(data[:8], n=5, ef_search=32) == before  # same seed, same graph
    w.clear()
    db.commit_rw_txn()
    assert w.is_empty() and not _scan(db)
    with pytest.raises(errors.MissingMetadata):
        w.builder().force_rebuild()
    db.abort_rw_txn()


def test_readonly_database_sees_commits_after_refresh(tmp_path):
    live = Database(tmp_path / "db", Metric.COSINE, device="cpu")
    data = _fill(live, 100, 8, seed=8)
    ro = Database(tmp_path / "db", Metric.COSINE, readonly=True, device="cpu")
    assert ro.reader().n_items() == 100
    _fill(live, 20, 8, seed=9, start_id=100)
    assert ro.reader().n_items() == 100  # the snapshot is stable
    assert ro.refresh() and not ro.refresh() and not live.refresh()
    r = ro.reader()
    assert r.n_items() == 120 and r.by_vec(data[7], n=1)[0][0] == 7
    with pytest.raises(errors.StoreError):
        ro.writer(8).add_item(0, np.zeros(8))
    ro.close()
    live.close()
    live.close()  # closing twice is harmless
