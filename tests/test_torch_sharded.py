"""Sharded build and serving (``hannoy_tpu_torch.parallel``) against the
JAX package's ``hannoy_tpu.parallel``, on the CPU: the port's shards run
on ``devices=["cpu"] * S``, the JAX package's on its virtual CPU mesh.

* ``partition_round_robin``, ``shard_of`` and ``pad_to_common_shapes``
  equal the JAX package's;
* ``ShardedIndex.search`` on the same per-shard graphs (port wave builds
  of 800 items in 4 shards: cosine and euclidean at D=32, BQ cosine at
  D=64) gives the JAX package's ids exactly and its distances to 1e-5
  absolute plus 1e-6 relative (BQ cosine: 1.2e-7 absolute), also when
  every row is short and the exact sharded scan answers it;
* store-backed builds leave records equal to the JAX package's under
  every key (the JAX package's bf16 link-distance download switched off,
  as in the other store tests): the sequential ``ShardedWriter`` build,
  the lockstep build against the JAX package's SPMD build per shard at the
  sizes of ``tests/test_spmd_build.py``, and ``reshard`` grow and shrink;
* the JAX package's own cases (``tests/test_sharded.py``, 8, and
  ``tests/test_spmd_build.py``, 3) on the port.
"""

import copy

import numpy as np
import pytest
import torch

import hannoy_tpu
import hannoy_tpu.parallel as jax_parallel
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import distances as jax_distances
import hannoy_tpu_torch
import hannoy_tpu_torch.parallel as parallel
from hannoy_tpu_torch import Database, Metric, Reader
from hannoy_tpu_torch.build import builder
from hannoy_tpu_torch.build.builder import BuildOptions
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import codecs, distances
from hannoy_tpu_torch.ops.distances import COSINE, EUCLIDEAN
from hannoy_tpu_torch.parallel import ShardedReader, ShardedWriter, build_sharded, reshard, sharded_insert_wave

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)


def _cpus(n):
    return ["cpu"] * n


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


def _shard_graphs(name, n, d, S, seed=1, m=8):
    """Port wave builds of the round-robin shards of ``n`` random items."""
    metric = distances.by_name(name)
    data = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    graphs = []
    for part in parallel.partition_round_robin(n, S):
        g = hnsw.HostGraph.empty(metric, d, m, 2 * m, capacity=hnsw.slot_capacity(len(part)))
        for i in part:
            g.alloc_slot(int(i))
        g.vectors[: len(part)] = codecs.pack(data[part], metric.codec)
        g.norms[: len(part)] = distances.np_norms(metric, g.vectors[: len(part)])
        builder.build_graph(g, np.arange(len(part), dtype=np.int64), np.empty(0, np.int64),
                            BuildOptions(ef_construction=32, wave_size=128, bulk=False, seed=seed + len(graphs)),
                            device="cpu")
        graphs.append(g)
    return graphs


def _graph_arrays(g):
    return [g.ids, g.levels, g.vectors, g.norms, g.links0, g.dists0, *g.upper_links, *g.upper_dists, *g.slot_rows,
            np.asarray(g.entry_slots), np.asarray(g.upper_row_count)]


# --------------------------------------------------------------------------
# (a) the host helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n, S", [(10, 3), (2000, 8), (7, 8), (1, 1)])
def test_partition_and_routing_match_jax(n, S):
    got, want = parallel.partition_round_robin(n, S), jax_parallel.partition_round_robin(n, S)
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    ids = [0, 1, S, 7 * S + 3, 2**32 - 1]
    assert [parallel.shard_of(i, S) for i in ids] == [jax_parallel.shard_of(i, S) for i in ids]


def test_pad_to_common_shapes_matches_jax():
    """Shards of different sizes and heights (300, 700 and 1200 items)
    padded by both packages: every array of every shard equal."""
    graphs = []
    for n, seed in ((300, 3), (700, 4), (1200, 5)):
        graphs += _shard_graphs("euclidean", n, 8, 1, seed=seed)
    assert len({g.capacity for g in graphs}) > 1 and len({g.max_level for g in graphs}) > 1
    jgraphs = [_jax_host(g) for g in graphs]
    parallel.sharded.pad_to_common_shapes(graphs)
    jax_parallel.sharded.pad_to_common_shapes(jgraphs)
    for g, jg in zip(graphs, jgraphs):
        for a, b in zip(_graph_arrays(g), _graph_arrays(jg), strict=True):
            np.testing.assert_array_equal(a, b)
        assert g.max_level == jg.max_level


# --------------------------------------------------------------------------
# (b) fan-out search on the same per-shard graphs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_graphs():
    """metric name -> the port's 4 shard graphs of 800 items (built once)."""
    cache = {}

    def get(name, d):
        if name not in cache:
            cache[name] = _shard_graphs(name, 800, d, 4)
        return copy.deepcopy(cache[name])

    return get


@pytest.mark.parametrize("rows", ["graph", "short"])
@pytest.mark.parametrize("name, d", [("cosine", 32), ("euclidean", 32), ("binary quantized cosine", 64)])
def test_sharded_search_matches_jax(shard_graphs, name, d, rows):
    """``short``: every link cut, so each shard's beam finds its seeds only
    and every row is answered by the exact sharded scan."""
    S, k, ef = 4, 10, 32
    graphs = shard_graphs(name, d)
    if rows == "short":
        for g in graphs:
            g.links0[:] = -1
            for a in g.upper_links:
                a[:] = -1
    jgraphs = [_jax_host(g) for g in graphs]
    parallel.sharded.pad_to_common_shapes(graphs)
    jax_parallel.sharded.pad_to_common_shapes(jgraphs)
    index = parallel.ShardedIndex.from_host_graphs(graphs, _cpus(S))
    jindex = jax_parallel.ShardedIndex.from_host_graphs(jgraphs, mesh=jax_parallel.make_mesh(S))
    queries = np.random.default_rng(7).standard_normal((24, d)).astype(np.float32)
    ids, dists = index.search(queries, k=k, ef=ef)
    jids, jdists = jindex.search(queries, k=k, ef=ef)
    assert ids.dtype == np.uint32 and ids.shape == (24, k)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    tol = dict(rtol=0, atol=1.2e-7) if name.startswith("binary") else dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(dists, np.asarray(jdists), **tol)
    assert (np.diff(dists, axis=1) >= 0).all() and (ids != hnsw.INVALID_ID).all()


# --------------------------------------------------------------------------
# (c) store-backed builds: equal records in both packages' stores
# --------------------------------------------------------------------------


def _records(db):
    return dict(db._db.prefix_iter(db._env.read_txn(), b""))


def _clustered(rng, n, d, k=12):
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


def _open(pkg, path, metric):
    kw = {"device": "cpu"} if pkg is hannoy_tpu_torch else {}
    return pkg.Database(path, getattr(pkg.Metric, metric), **kw)


def _layout(pkg, S, lockstep):
    """The ShardedWriter / reshard keyword that picks the build path."""
    if not lockstep:
        return {}
    return {"devices": _cpus(S)} if pkg is hannoy_tpu_torch else {"mesh": jax_parallel.make_mesh(S)}


def _both_stores(tmp_path, monkeypatch, metric, drive):
    """``drive(pkg, db)`` on a fresh store of each package → (JAX records,
    port records)."""
    monkeypatch.setattr(jax_hnsw, "_SYNC_BF16", False)
    out = []
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        db = _open(pkg, tmp_path / pkg.__name__, metric)
        drive(pkg, db)
        out.append(_records(db))
        db.close()
    return out


def _assert_records_equal(want, got):
    assert want.keys() == got.keys()
    differ = sorted(k for k in want if want[k] != got[k])
    assert not differ, f"{len(differ)} of {len(want)} records differ, first {differ[:3]}"


@pytest.mark.parametrize("lockstep", [False, True], ids=["sequential", "lockstep"])
def test_sharded_writer_records_match_jax(tmp_path, monkeypatch, lockstep):
    """800 x 16 euclidean in S shards: the sequential build (S = 4)
    against the JAX package's; the lockstep build (S = 8,
    ``tests/test_spmd_build.py:38``) against its SPMD build, then 24 added
    and 16 deleted in one more lockstep build."""
    rng = np.random.default_rng(1)
    data, fresh = _clustered(rng, 800, 16), _clustered(rng, 24, 16)
    S = 8 if lockstep else 4

    def drive(pkg, db):
        P = jax_parallel if pkg is hannoy_tpu else parallel
        w = P.ShardedWriter(db, 16, n_shards=S, m=8, ef=48, **_layout(pkg, S, lockstep))
        w.add_items(range(800), data)
        w.build(spmd=lockstep)
        db.commit_rw_txn()
        if not lockstep:
            return
        w = P.ShardedWriter(db, 16, n_shards=S, m=8, ef=48, **_layout(pkg, S, lockstep))
        w.add_items(range(800, 824), fresh)
        for i in range(16):
            assert w.del_item(i)
        w.build(spmd=lockstep)
        db.commit_rw_txn()

    _assert_records_equal(*_both_stores(tmp_path, monkeypatch, "EUCLIDEAN", drive))


@pytest.mark.parametrize("n, d, metric", [(400, 8, "COSINE"), (320, 8, "EUCLIDEAN")])
def test_lockstep_build_matches_jax_spmd(tmp_path, monkeypatch, n, d, metric):
    """The other two sizes of ``tests/test_spmd_build.py`` (:73, :93),
    fresh lockstep builds in 8 shards, record for record."""
    data = _clustered(np.random.default_rng(2), n, d)

    def drive(pkg, db):
        P = jax_parallel if pkg is hannoy_tpu else parallel
        with P.ShardedWriter(db, d, n_shards=8, m=8, ef=32, **_layout(pkg, 8, True)) as w:
            w.add_items(range(n), data)

    _assert_records_equal(*_both_stores(tmp_path, monkeypatch, metric, drive))


@pytest.mark.parametrize("change", ["grow", "shrink"])
def test_reshard_records_match_jax(tmp_path, monkeypatch, change):
    """2 → 4 shards in place, and 4 → 2 at a new base with pending adds
    and a delete, by sequential builds (the lockstep builds are held to the
    JAX package's above)."""
    rng = np.random.default_rng(3)
    data, extra = rng.standard_normal((300, 16)).astype(np.float32), rng.standard_normal((2, 16)).astype(np.float32)
    old, new = (2, 4) if change == "grow" else (4, 2)

    def drive(pkg, db):
        P = jax_parallel if pkg is hannoy_tpu else parallel
        with P.ShardedWriter(db, 16, n_shards=old, m=8, ef=48) as w:
            w.add_items(range(300), data)
            w.build(spmd=False)
        if change == "grow":
            P.reshard(db, old, new, m=8, ef=48, spmd=False)
        else:
            w = P.ShardedWriter(db, 16, n_shards=old, m=8, ef=48)
            assert w.del_item(7)
            w.add_items([300, 301], extra)
            P.reshard(db, old, new, new_base_index=100, m=8, ef=48, spmd=False)
        db.commit_rw_txn()

    _assert_records_equal(*_both_stores(tmp_path, monkeypatch, "EUCLIDEAN", drive))


# --------------------------------------------------------------------------
# (d) the JAX package's own cases on the port
# --------------------------------------------------------------------------


def test_jax_case_sharded_search_recall(rng):
    """``tests/test_sharded.py:18``."""
    n, d, k = 2000, 16, 10
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = build_sharded(EUCLIDEAN, data, np.arange(n), m=8, m0=16, n_shards=8,
                        opts=BuildOptions(ef_construction=48, wave_size=128), devices=_cpus(8))
    queries = rng.standard_normal((8, d)).astype(np.float32)
    ids, dists = idx.search(queries, k=k, ef=48)
    assert ids.shape == (8, k)
    exact = np.sort(((data[None] - queries[:, None]) ** 2).sum(-1), axis=1)[:, :k]
    rec = float((dists <= exact[:, k - 1 : k] + 1e-5).mean())
    assert rec >= 0.9, f"sharded recall {rec}"
    assert (np.diff(dists, axis=1) >= -1e-6).all()


def test_jax_case_sharded_results_are_replicated_consistent(rng):
    """``tests/test_sharded.py:34``."""
    n, d = 800, 8
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = build_sharded(COSINE, data, np.arange(n), m=8, m0=16, n_shards=8,
                        opts=BuildOptions(ef_construction=32, wave_size=64), devices=_cpus(8))
    q = data[:4]
    ids1, d1 = idx.search(q, k=5, ef=32)
    ids2, d2 = idx.search(q, k=5, ef=32)
    assert np.array_equal(ids1, ids2) and np.array_equal(d1, d2)
    assert ids1[0, 0] == 0  # query at an item finds that exact item first


def test_jax_case_sharded_insert_wave_inserts_searchable_items(rng):
    """``tests/test_sharded.py:49``: items staged into free slots and
    inserted only through ``sharded_insert_wave`` come back from the
    sharded search."""
    n, d, S = 800, 8, 8
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = build_sharded(EUCLIDEAN, data, np.arange(n), m=8, m0=16, n_shards=S,
                        opts=BuildOptions(ef_construction=32, wave_size=64), devices=_cpus(S))
    per = n // S
    extra = rng.standard_normal((S, 4, d)).astype(np.float32) + 10.0  # far cluster
    wave = np.zeros((S, 4), dtype=np.int32)
    new_ids = np.zeros((S, 4), dtype=np.uint32)
    for s in range(S):
        for j in range(4):
            slot, gid = per + j, n + s * 4 + j
            wave[s, j], new_ids[s, j] = slot, gid
            idx.graphs[s].vectors[slot] = torch.from_numpy(extra[s, j])
            idx.ids[s][slot] = gid
    out = sharded_insert_wave(idx, wave, ef=32, cap=16)
    assert all(g.links0.shape == (ids.shape[0], 16) for g, ids in zip(out.graphs, out.ids))
    got, gd = out.search(extra.reshape(-1, d), k=1, ef=32)
    assert np.array_equal(got[:, 0], new_ids.reshape(-1))
    assert (gd[:, 0] < 1e-5).all()
    # the new far cluster must also be reachable from ordinary queries
    probe = extra.reshape(-1, d)[:3] + 0.01
    got2, _ = out.search(probe, k=3, ef=32)
    assert set(got2[:, 0].tolist()) <= set(new_ids.reshape(-1).tolist())


def test_jax_case_store_backed_sharded_deployment(tmp_path, rng):
    """``tests/test_sharded.py:87`` (its writers build in lockstep: the
    JAX package's auto choice on an 8-device mesh)."""
    n, d = 600, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    db = Database(tmp_path / "sharded", Metric.EUCLIDEAN, device="cpu")
    with ShardedWriter(db, d, n_shards=8, m=8, ef=48, devices=_cpus(8)) as w:
        w.add_items(range(n), data)
    reader = ShardedReader(db, n_shards=8, devices=_cpus(8))
    reader.assert_validity()
    assert reader.n_items() == n
    got = reader.search(data[:6], n=3, ef_search=48)
    for i, row in enumerate(got):
        assert row[0][0] == i and row[0][1] < 1e-5
    w2 = ShardedWriter(db, d, n_shards=8, m=8, ef=48, devices=_cpus(8))
    for i in range(16):
        assert w2.del_item(i)
    w2.build()
    db.commit_rw_txn()
    r2 = ShardedReader(db, n_shards=8, devices=_cpus(8))
    r2.assert_validity()
    assert r2.n_items() == n - 16
    got = r2.search(data[3], n=5, ef_search=48)
    assert all(i >= 16 for i, _ in got[0])
    db.close()


def test_jax_case_reshard_in_place_grow(tmp_path, rng):
    """``tests/test_sharded.py:120``."""
    n, d = 500, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    db = Database(tmp_path / "grow", Metric.EUCLIDEAN, device="cpu")
    with ShardedWriter(db, d, n_shards=2, m=8, ef=48, devices=_cpus(2)) as w:
        w.add_items(range(n), data)
    reshard(db, 2, 4, m=8, ef=48, devices=_cpus(4))
    db.commit_rw_txn()
    total = 0
    for t in range(4):
        r = Reader.open(db, t)
        r.assert_validity()
        ids = r.item_ids().to_array()
        assert (ids % 4 == t).all(), "item routed to the wrong shard"
        total += len(ids)
        for item in ids[:5].tolist():  # moved records are byte-identical
            np.testing.assert_array_equal(np.asarray(r.item_vector(item), dtype=np.float32)[:d], data[item])
    assert total == n
    reader = ShardedReader(db, n_shards=4, devices=_cpus(4))
    got = reader.search(data[:8], n=3, ef_search=48)
    for i, row in enumerate(got):
        assert row[0][0] == i and row[0][1] < 1e-5
    db.close()


def test_jax_case_reshard_new_base_and_shrink(tmp_path, rng):
    """``tests/test_sharded.py:157``: old indexes end up empty, pending
    journal adds migrate too, deletes stay deleted."""
    from hannoy_tpu_torch.store.schema import Prefix

    n, d = 300, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    db = Database(tmp_path / "shrink", Metric.EUCLIDEAN, device="cpu")
    with ShardedWriter(db, d, n_shards=4, m=8, ef=48, devices=_cpus(4)) as w:
        w.add_items(range(n), data)
    w2 = ShardedWriter(db, d, n_shards=4, m=8, ef=48)
    assert w2.del_item(7)
    extra = rng.standard_normal((2, d)).astype(np.float32)
    w2.add_items([n, n + 1], extra)
    reshard(db, 4, 2, new_base_index=100, m=8, ef=48, devices=_cpus(2))
    db.commit_rw_txn()
    wtxn = db._wtxn()
    for s in range(4):
        assert next(db._db.prefix_iter(wtxn, Prefix.all(s)), None) is None, "old shard not cleared"
    db.abort_rw_txn()
    seen = set()
    for t in range(2):
        r = Reader.open(db, 100 + t)
        r.assert_validity()
        seen.update(int(i) for i in r.item_ids().to_array())
    assert seen == (set(range(n)) | {n, n + 1}) - {7}
    db.close()


def test_jax_case_reshard_overlap_rejected(tmp_path):
    """``tests/test_sharded.py:193``."""
    d = 8
    db = Database(tmp_path / "olap", Metric.EUCLIDEAN, device="cpu")
    with ShardedWriter(db, d, n_shards=2, m=8, ef=48) as w:
        w.add_items(range(64), np.random.default_rng(0).standard_normal((64, d)).astype(np.float32))
    with pytest.raises(ValueError):
        reshard(db, 2, 4, new_base_index=1)
    db.close()


@pytest.mark.slow
def test_jax_case_sharded_recall_parity_vs_single_graph(rng):
    """``tests/test_sharded.py:205``: on 16384 x 32 clustered items the
    sharded search matches a single graph's recall at equal ef. About 50 s
    on the CPU (the single graph's bulk build alone 33 s), past the tier-1
    budget of the new files: ``-m slow`` runs it."""
    from hannoy_tpu_torch.ops import beam

    n, d, k, ef = 16384, 32, 10, 64
    centers = rng.standard_normal((64, d)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, 64, size=n)] + rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, 64, size=128)] + rng.standard_normal((128, d))).astype(np.float32)
    thresh = np.sort(((data[None] - queries[:, None]) ** 2).sum(-1), axis=1)[:, k - 1 : k] + 1e-5
    opts = BuildOptions(ef_construction=48, wave_size=1024)
    g = hnsw.HostGraph.empty(EUCLIDEAN, d, 8, 16, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(EUCLIDEAN, data)
    builder.build_graph(g, np.arange(n, dtype=np.int64), np.empty(0, np.int64), opts, device="cpu")
    dev = hnsw.to_device(g, "cpu")
    res = beam.hnsw_search(dev, torch.from_numpy(queries), torch.from_numpy(distances.np_norms(EUCLIDEAN, queries)),
                           ef, ef_upper=beam.default_ef_upper(n, ef))
    rec_single = float((res.dists.numpy()[:, :k] <= thresh).mean())
    idx = build_sharded(EUCLIDEAN, data, np.arange(n), m=8, m0=16, n_shards=8, opts=opts, devices=_cpus(8))
    _, dists = idx.search(queries, k=k, ef=ef)
    rec_sharded = float((dists <= thresh).mean())
    assert rec_sharded >= rec_single - 0.02, f"sharded {rec_sharded:.4f} vs single {rec_single:.4f}"
    assert rec_single >= 0.9, f"oracle recall {rec_single}"


def test_jax_case_spmd_store_build_fresh_and_incremental(tmp_path, rng):
    """``tests/test_spmd_build.py:33``."""
    n, d, S = 800, 16, 8
    data = _clustered(rng, n, d)
    db = Database(tmp_path / "spmd", Metric.EUCLIDEAN, device="cpu")
    w = ShardedWriter(db, d, n_shards=S, m=8, ef=48, devices=_cpus(S))
    w.add_items(range(n), data)
    w.build()
    db.commit_rw_txn()
    r = ShardedReader(db, n_shards=S, devices=_cpus(S))
    r.assert_validity()
    assert r.n_items() == n
    got = r.search(data[:8], n=3, ef_search=48)
    for i, row in enumerate(got):
        assert row[0][0] == i and row[0][1] < 1e-5
    w2 = ShardedWriter(db, d, n_shards=S, m=8, ef=48, devices=_cpus(S))
    fresh = _clustered(rng, 24, d)
    w2.add_items(range(n, n + 24), fresh)
    for i in range(16):
        assert w2.del_item(i)
    w2.build()
    db.commit_rw_txn()
    w3 = ShardedWriter(db, d, n_shards=S, m=8, ef=48, devices=_cpus(S))
    assert not any(wr.need_build() for wr in w3._writers)  # journal fully consumed
    r2 = ShardedReader(db, n_shards=S, devices=_cpus(S))
    r2.assert_validity()
    assert r2.n_items() == n - 16 + 24
    got = r2.search(fresh, n=1, ef_search=48)
    assert [row[0][0] for row in got] == list(range(n, n + 24))
    got = r2.search(data[:16], n=5, ef_search=64)
    for i, row in enumerate(got):
        assert all(item != i for item, _ in row)
    db.close()


def test_jax_case_spmd_build_survives_reopen(tmp_path, rng):
    """``tests/test_spmd_build.py:73``."""
    n, d, S = 400, 8, 8
    data = _clustered(rng, n, d)
    db = Database(tmp_path / "re", Metric.COSINE, device="cpu")
    with ShardedWriter(db, d, n_shards=S, m=8, ef=32, devices=_cpus(S)) as w:
        w.add_items(range(n), data)
    before = ShardedReader(db, n_shards=S, devices=_cpus(S)).search(data[:5], n=4, ef_search=32)
    db.close()
    db2 = Database(tmp_path / "re", Metric.COSINE, device="cpu")
    r2 = ShardedReader(db2, n_shards=S, devices=_cpus(S))
    r2.assert_validity()
    assert r2.search(data[:5], n=4, ef_search=32) == before
    db2.close()


def test_jax_case_spmd_matches_sequential_semantics(tmp_path, rng):
    """``tests/test_spmd_build.py:93``: lockstep and sequential builds
    expose the same item set and exact self-search."""
    n, d, S = 320, 8, 8
    data = _clustered(rng, n, d)
    dbs = Database(tmp_path / "seq", Metric.EUCLIDEAN, device="cpu")
    ws = ShardedWriter(dbs, d, n_shards=S, m=8, ef=32)
    ws.add_items(range(n), data)
    ws.build(spmd=False)
    dbs.commit_rw_txn()
    dbp = Database(tmp_path / "par", Metric.EUCLIDEAN, device="cpu")
    wp = ShardedWriter(dbp, d, n_shards=S, m=8, ef=32, devices=_cpus(S))
    wp.add_items(range(n), data)
    wp.build()
    dbp.commit_rw_txn()
    rs = ShardedReader(dbs, n_shards=S, devices=_cpus(S))
    rp = ShardedReader(dbp, n_shards=S, devices=_cpus(S))
    rs.assert_validity()
    rp.assert_validity()
    assert rs.n_items() == rp.n_items() == n
    for q in data[::40]:
        a = rs.search(q, n=1, ef_search=32)[0][0]
        b = rp.search(q, n=1, ef_search=32)[0][0]
        assert a[0] == b[0] and abs(a[1] - b[1]) < 1e-5
    dbs.close()
    dbp.close()


# --------------------------------------------------------------------------
# (e) cancellation of the lockstep build, and a per-shard Reader after padding
# --------------------------------------------------------------------------


def test_cancelled_lockstep_build_aborts_cleanly(tmp_path):
    """A lockstep build whose cancel fires at its 2nd check raises
    ``BuildCancelled``; after the abort the store is as it was, and the
    build without a cancel then succeeds."""
    rng = np.random.default_rng(5)
    data = _clustered(rng, 400, 8)
    db = Database(tmp_path / "c", Metric.EUCLIDEAN, device="cpu")
    with ShardedWriter(db, 8, n_shards=4, m=8, ef=32, devices=_cpus(4)) as w:
        w.add_items(range(400), data)
    before = _records(db)
    w = ShardedWriter(db, 8, n_shards=4, m=8, ef=32, devices=_cpus(4))
    w.add_items(range(400, 440), _clustered(rng, 40, 8))
    for i in range(0, 40, 4):
        w.del_item(i)
    calls = [0]

    def cancel():
        calls[0] += 1
        return calls[0] == 2

    with pytest.raises(hannoy_tpu_torch.errors.BuildCancelled):
        w.build(opts=BuildOptions(cancel=cancel))
    assert db.abort_rw_txn() and _records(db) == before
    r = ShardedReader(db, n_shards=4, devices=_cpus(4))
    assert r.n_items() == 400
    r.assert_validity()
    w = ShardedWriter(db, 8, n_shards=4, m=8, ef=32, devices=_cpus(4))
    w.add_items(range(400, 440), _clustered(rng, 40, 8))
    w.build()
    db.commit_rw_txn()
    assert ShardedReader(db, n_shards=4, devices=_cpus(4)).n_items() == 440
    # the padding the ShardedReader did on the cached graphs leaves a
    # per-shard Reader working
    for s in range(4):
        r = db.reader(s)
        r.assert_validity()
        got = r.by_vecs(data[s : s + 1], n=1)
        assert got[0][0][0] % 4 == s
    db.close()


def test_lockstep_build_after_deleting_every_entry_point_keeps_the_graph_reachable(tmp_path):
    """Each shard's only entry point, alone at its top level, is deleted:
    its replacement is re-inserted at the top by a beam wave (2,500 items a
    shard: past the exact bootstrap), where it is alone. The JAX package's
    SPMD wave seeds its next level with its empty pruned set, so it loses
    every link and the answers hold the appended items only; the port hands
    the level's seeds down (ROADMAP.md §3), and recall@10 stays >= 0.95."""
    rng = np.random.default_rng(3)
    n, d, S = 5000, 8, 2
    data, extra = rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal((100, d)).astype(np.float32)
    queries = rng.standard_normal((64, d)).astype(np.float32)
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    w = ShardedWriter(db, d, n_shards=S, m=8, ef=32, devices=_cpus(S))
    w.add_items(range(n), data)
    w.build(spmd=False)
    db.commit_rw_txn()
    eps = [list(db.reader(s)._metadata.entry_points) for s in range(S)]
    assert all(len(e) == 1 for e in eps)  # the case: one entry point a shard
    w.add_items(range(n, n + 100), extra)
    for (e,) in eps:
        assert w.del_item(e)
    w.build()
    db.commit_rw_txn()
    r = ShardedReader(db, n_shards=S, devices=_cpus(S))
    r.assert_validity()
    live = np.concatenate([np.delete(data, [e for (e,) in eps], axis=0), extra])
    kth = np.sort(((live[None] - queries[:, None]) ** 2).sum(-1), axis=1)[:, 9] + 1e-5
    got = r.search(queries, n=10, ef_search=48)
    recall = float(np.mean([[x <= kth[b] for _, x in row] for b, row in enumerate(got)]))
    print(f"after deleting every entry point: lockstep recall@10 {recall:.4f}")
    assert recall >= 0.95
    db.close()
