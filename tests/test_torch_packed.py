"""The packed metrics (hamming, binary quantized cosine / euclidean /
manhattan) of the port against the JAX package, on the CPU, with inputs
made from numpy seeds and fed to both.

Tolerances. Packed distances are functions of an integer popcount, taken
here by XOR + SWAR or by products of {0, 1} floats that are exact in f32,
so hamming, BQ euclidean and BQ manhattan must agree with the JAX package
bit for bit (``array_equal``). The BQ cosine epilogue divides and scales
in f32 (``(1 - dot/(|p||q|))/2``), which XLA and PyTorch round in
different places: 1.2e-7 absolute, one f32 ulp at 1.0 (numpy's oracle
takes it in f64). Wave builds on such distances give the JAX build's link
rows row for row. The bulk build's k-means sums continuous centroids in
another order, so near-tied assignments may flip: 95% of its ``links0``
rows must equal the JAX build's, as for the f32 metrics, and its recall
is held as ``tests/test_bulk.py`` holds the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hannoy_tpu
import hannoy_tpu_torch
from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.build import bulk as jax_bulk
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import codecs as jax_codecs
from hannoy_tpu.ops import distances as jax_distances
from hannoy_tpu.ops import prune as jax_prune
from hannoy_tpu_torch import Database, Metric, errors
from hannoy_tpu_torch.build import builder, bulk
from hannoy_tpu_torch.models import flat, hnsw
from hannoy_tpu_torch.ops import beam, beam_cuda, codecs, distances, prune
from hannoy_tpu_torch.store import schema
from hannoy_tpu_torch.utils import tracing

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

ALL = [m.name for m in distances.ALL_METRICS]
PACKED = [m.name for m in distances.ALL_METRICS if m.is_packed]


def _packed(seed, n, d, name):
    """Random vectors packed by the metric's codec → (rng, lanes uint32
    [n, W], headers [n]); some rows are all zeros or all ones."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0
    metric = distances.by_name(name)
    lanes = codecs.pack(x, metric.codec)
    return rng, lanes, distances.np_norms(metric, lanes)


def _t(lanes):
    return torch.from_numpy(distances.as_lanes(lanes))


def _assert_same(name, got, want):
    """Exact, but for the rounding of the BQ cosine epilogue."""
    if name == "binary quantized cosine":
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ALL)
def test_np_norms_and_np_pairwise_equal_jax(name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 70)).astype(np.float32)
    metric, jm = distances.by_name(name), jax_distances.by_name(name)
    assert (metric.name, metric.codec, metric.is_packed) == (jm.name, jm.codec, jm.is_packed)
    rows = codecs.pack(x, metric.codec)
    np.testing.assert_array_equal(rows, jax_codecs.pack(x, jm.codec))
    nrm = distances.np_norms(metric, rows)
    np.testing.assert_array_equal(nrm, jax_distances.np_norms(jm, rows))
    np.testing.assert_array_equal(
        distances.np_pairwise(metric, rows[:12], nrm[:12], rows, nrm),
        jax_distances.np_pairwise(jm, rows[:12], nrm[:12], rows, nrm),
    )
    assert distances.device_dtype(metric) == (torch.int32 if metric.is_packed else torch.float32)


def test_unpack_bits_and_popcount_bit_for_bit():
    rng = np.random.default_rng(2)
    lanes = rng.integers(0, 2**32, (50, 5), dtype=np.uint64).astype(np.uint32)
    lanes[0], lanes[1], lanes[2] = 0, 0xFFFFFFFF, 0x80000001  # sign bit set in the int32 view
    want = np.asarray(jax_distances.unpack_bits(jnp.asarray(lanes)).astype(jnp.float32))
    got = distances.unpack_bits(_t(lanes))
    assert got.dtype == torch.float32 and got.shape == (50, 160)
    np.testing.assert_array_equal(got.numpy(), want)
    # LSB first within a lane: bit i of lane w is column 32·w + i
    np.testing.assert_array_equal(got.numpy()[2, :32], np.r_[1.0, np.zeros(30), 1.0])
    np.testing.assert_array_equal(
        distances.popcount(_t(lanes)).sum(-1).numpy(), distances._np_popcount_rows(lanes)
    )
    np.testing.assert_array_equal(
        distances._row_popcounts(_t(lanes)).numpy(), np.asarray(jax_distances._row_popcounts(jnp.asarray(lanes)))
    )


@pytest.mark.parametrize("name", PACKED)
def test_packed_gathered_distances_match_jax_exactly(name):
    """The plain twin of the kernel, through ``beam_cuda`` as the beam
    calls it (CPU tensors never reach the kernel), with -1 entries."""
    rng, lanes, nrm = _packed(3, 300, 130, name)
    metric, jm = distances.by_name(name), jax_distances.by_name(name)
    B, K = 11, 9
    idx = rng.integers(0, 300, (B, K)).astype(np.int32)
    idx[::3, ::4] = -1
    safe = np.maximum(idx, 0)
    want = np.asarray(jax_distances.gathered_distances(
        jm, jnp.asarray(lanes[:B]), jnp.asarray(nrm[:B]), jnp.asarray(lanes[safe]), jnp.asarray(nrm[safe])))
    before = beam_cuda.KERNEL.launches
    got = beam_cuda.gathered_distances(
        metric, _t(lanes), torch.from_numpy(nrm), _t(lanes[:B]), torch.from_numpy(nrm[:B]), torch.from_numpy(idx))
    assert beam_cuda.KERNEL.launches == before
    _assert_same(name, got.numpy(), want)
    oracle = np.stack([distances.np_pairwise(metric, lanes[b : b + 1], nrm[b : b + 1], lanes[safe[b]], nrm[safe[b]])[0]
                       for b in range(B)])
    _assert_same(name, got.numpy(), oracle)
    assert beam_cuda.form_of(metric, torch.int32) == ("packed", "popcount")


@pytest.mark.parametrize("name", PACKED)
def test_packed_matrix_distances_match_jax_exactly(name, monkeypatch):
    _, lanes, nrm = _packed(4, 200, 100, name)
    metric, jm = distances.by_name(name), jax_distances.by_name(name)
    q, qn = lanes[:16], nrm[:16]
    want = np.asarray(jax_distances.matrix_distances(jm, *map(jnp.asarray, (q, qn, lanes, nrm))))
    args = (_t(q), torch.from_numpy(qn), _t(lanes), torch.from_numpy(nrm))
    got = distances.matrix_distances(metric, *args).numpy()
    _assert_same(name, got, want)
    monkeypatch.setattr(distances, "PACKED_CHUNK_ELEMS", 3 * 200 * 4)  # three queries a step
    np.testing.assert_array_equal(distances.matrix_distances(metric, *args).numpy(), got)
    # the product form gives the same popcounts
    mxu = distances.packed_matrix_mxu(metric, *args).numpy()
    np.testing.assert_array_equal(mxu, got)
    _assert_same(name, mxu, np.asarray(jax_distances.packed_matrix_mxu(jm, *map(jnp.asarray, (q, qn, lanes, nrm)))))


@pytest.mark.parametrize("name", PACKED)
def test_packed_block_and_pairwise_match_jax_exactly(name, monkeypatch):
    _, lanes, nrm = _packed(5, 3 * 70, 96, name)
    metric, jm = distances.by_name(name), jax_distances.by_name(name)
    c, cn = lanes.reshape(3, 70, -1), nrm.reshape(3, 70)
    q, qn = c[:, :20], cn[:, :20]
    want = np.asarray(jax_distances.block_distances(jm, *map(jnp.asarray, (q, qn, c, cn))))
    got = distances.block_distances(metric, _t(q), torch.from_numpy(qn), _t(c), torch.from_numpy(cn))
    _assert_same(name, got.numpy(), want)

    want = np.asarray(jax_prune.pairwise_block(jm, jnp.asarray(q), jnp.asarray(qn)))
    got = prune.pairwise_block(metric, _t(q), torch.from_numpy(qn)).numpy()
    _assert_same(name, got, want)
    monkeypatch.setattr(distances, "PACKED_CHUNK_ELEMS", 2 * 20 * 20 * 3)  # two rows a step
    np.testing.assert_array_equal(prune.pairwise_block(metric, _t(q), torch.from_numpy(qn)).numpy(), got)


@pytest.mark.parametrize("name", ["hamming", "binary quantized cosine"])
def test_packed_flat_topk_and_prune_match_jax(name):
    from hannoy_tpu.models import flat as jax_flat

    rng, lanes, nrm = _packed(6, 400, 64, name)
    lanes[200:210] = lanes[100:110]  # exact duplicates: ties break toward the lower slot
    metric, jm = distances.by_name(name), jax_distances.by_name(name)
    q, qn = lanes[95:111], nrm[95:111]
    mask = rng.random(400) < 0.8
    want_d, want_s = jax_flat.flat_topk(name, *map(jnp.asarray, (q, qn, lanes, nrm, mask)), 10)
    got_d, got_s = flat.flat_topk(name, _t(q), torch.from_numpy(qn), _t(lanes), torch.from_numpy(nrm), torch.from_numpy(mask), 10)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    _assert_same(name, got_d.numpy(), np.asarray(want_d))

    B, K, cap = 32, 24, 8
    cand = np.stack([rng.choice(400, K, replace=False) for _ in range(B)]).astype(np.int32)
    cd = np.take_along_axis(distances.np_pairwise(metric, lanes[:B], nrm[:B], lanes, nrm), cand, axis=1)
    order = np.argsort(cd, axis=1, kind="stable")
    cand, cd = np.take_along_axis(cand, order, 1), np.take_along_axis(cd, order, 1)
    j_ids, j_d = jax_prune.robust_prune(jm, *map(jnp.asarray, (lanes, nrm, cand, cd)), cap, 1.1)
    t_ids, t_d = prune.robust_prune(metric, _t(lanes), torch.from_numpy(nrm), torch.from_numpy(cand), torch.from_numpy(cd), cap, 1.1)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    _assert_same(name, t_d.numpy(), np.asarray(j_d))


# --------------------------------------------------------------------------
# Builds
# --------------------------------------------------------------------------

N, D, M, M0, EFC, WAVE = 1500, 64, 8, 16, 32, 128


def _clustered(n, d, seed=42, n_queries=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(16, n // 256), d)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, len(centers), size=n)] + rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, len(centers), n_queries)] + rng.standard_normal((n_queries, d))).astype(np.float32)
    return data, queries


def _stage(mod, data, name):
    """The staged (unbuilt) host graph of either package under ``name``."""
    dist = jax_distances if mod is jax_hnsw else distances
    metric = dist.by_name(name)
    n, d = data.shape
    g = mod.HostGraph.empty(metric, d, M, M0, capacity=jax_hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    rows = codecs.pack(data, metric.codec)
    g.vectors[:n] = rows
    g.norms[:n] = distances.np_norms(distances.by_name(name), rows)
    return g


def _recall(g, data, queries, name, ef=64, k=10):
    """Tie-aware recall@k of the port's search on ``g`` (a host graph of
    either package: its arrays are handed over)."""
    metric = distances.by_name(name)
    state = {f.name: getattr(g, f.name) for f in dataclasses.fields(g) if f.name != "dev_cache"}
    state["metric"] = name
    dev = hnsw.to_device(hnsw.host_graph_from_arrays(**state), "cpu", serve_only=True)
    rows, q = codecs.pack(data, metric.codec), codecs.pack(queries, metric.codec)
    nrm, qn = distances.np_norms(metric, rows), distances.np_norms(metric, q)
    res = beam.hnsw_search(dev, _t(q), torch.from_numpy(qn), ef)
    kth = np.sort(distances.np_pairwise(metric, q, qn, rows, nrm), axis=1)[:, k - 1 : k]
    return float((res.dists.numpy()[:, :k] <= kth + 1e-6).mean())


@pytest.mark.parametrize("name", ["hamming", "binary quantized cosine"])
def test_packed_wave_build_matches_jax_row_for_row(name):
    data, queries = _clustered(N, D, seed=7)
    n = np.arange(N, dtype=np.int64)
    jg = _stage(jax_hnsw, data, name)
    jax_builder.build_graph(jg, n, np.empty(0, np.int64),
                            jax_builder.BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False))
    tg = _stage(hnsw, data, name)
    assert tg.vectors.dtype == np.uint32
    stats = builder.build_graph(tg, n, np.empty(0, np.int64),
                                builder.BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False), device="cpu")
    tg.check_validity()
    assert stats.links_added > 0 and tg.max_level == jg.max_level >= 1
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_slots == jg.entry_slots
    np.testing.assert_array_equal(tg.links0, jg.links0)
    for a, b in zip(tg.upper_links, jg.upper_links):
        np.testing.assert_array_equal(a, b)
    rec = _recall(tg, data, queries, name)
    print(f"packed wave build {name}: recall@10 {rec:.4f}")
    assert rec >= 0.9


N_BULK = 6000


@pytest.fixture(scope="module")
def bulk_data():
    return _clustered(N_BULK, D)


@pytest.mark.parametrize("name", ["hamming", "binary quantized cosine"])
def test_packed_bulk_build_holds_recall(bulk_data, name, monkeypatch):
    """As ``tests/test_bulk.py::test_bulk_packed_metrics`` holds the JAX
    package: the k-means path, validity, recall >= min(0.93, wave - 0.02)."""
    monkeypatch.setattr(bulk, "BRUTE_MAX", 1024)
    data, queries = bulk_data
    metric = distances.by_name(name)
    assert bulk.eligible(metric, 0, 0, 10_000, builder.BuildOptions())
    n = np.arange(N_BULK, dtype=np.int64)
    recalls = {}
    for use_bulk in (True, False):
        g = _stage(hnsw, data, name)
        with tracing.record() as spans:
            builder.build_graph(g, n, np.empty(0, np.int64),
                                builder.BuildOptions(ef_construction=EFC, bulk=use_bulk, bulk_cluster_size=256),
                                device="cpu")
        g.check_validity()
        names = {s.name for s in spans}
        assert ({"bulk_kmeans", "bulk_candidates", "bulk_cross_links"} <= names) == use_bulk
        recalls[use_bulk] = _recall(g, data, queries, name)
    print(f"packed bulk build {name}: recall@10 bulk {recalls[True]:.4f} wave {recalls[False]:.4f}")
    assert recalls[True] >= min(0.93, recalls[False] - 0.02)


def test_packed_bulk_build_matches_jax(bulk_data, monkeypatch):
    """Both packages' BQ cosine ``bulk=True`` builds on the k-means path."""
    name = "binary quantized cosine"
    monkeypatch.setattr(jax_bulk, "BRUTE_MAX", 1024)
    monkeypatch.setattr(bulk, "BRUTE_MAX", 1024)
    data, queries = bulk_data
    n = np.arange(N_BULK, dtype=np.int64)
    jg = _stage(jax_hnsw, data, name)
    jax_builder.build_graph(jg, n, np.empty(0, np.int64),
                            jax_builder.BuildOptions(ef_construction=EFC, bulk=True, bulk_cluster_size=256))
    tg = _stage(hnsw, data, name)
    builder.build_graph(tg, n, np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=EFC, bulk=True, bulk_cluster_size=256), device="cpu")
    tg.check_validity()
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_slots == jg.entry_slots
    live = tg.valid_mask()
    share = float(np.mean(np.all(tg.links0[live] == jg.links0[live], axis=1)))
    t_rec, j_rec = _recall(tg, data, queries, name), _recall(jg, data, queries, name)
    print(f"packed bulk build: identical links0 rows {share:.4f}; recall@10 port {t_rec:.4f} jax {j_rec:.4f}")
    assert share >= 0.95 and t_rec >= j_rec - 0.02


def test_packed_kmeans_partition_matches_jax(bulk_data, monkeypatch):
    """k-means over unpacked bits: the maxmin picks are integer arithmetic
    (identical), the Lloyd sums are not (99.5% of assignments)."""
    data, _ = bulk_data
    jg = _stage(jax_hnsw, data[:3000], "hamming")
    jdev = jax_hnsw.to_device(jg, cache=False)
    tdev = hnsw.to_device(_stage(hnsw, data[:3000], "hamming"), "cpu")
    np.testing.assert_array_equal(tdev.vectors.numpy().view(np.uint32), np.asarray(jdev.vectors))
    geom = distances.unpack_bits(tdev.vectors[:1000])
    np.testing.assert_array_equal(
        bulk._maxmin_indices(geom, 20).numpy(), np.asarray(jax_bulk._maxmin_indices(jnp.asarray(geom.numpy()), 20)))
    members = np.arange(3000, dtype=np.int64)
    want = jax_bulk.kmeans_partition(jdev, members, 12, 3, np.random.default_rng(5), init="maxmin", init_sample=2048)
    got = bulk.kmeans_partition(tdev, members, 12, 3, np.random.default_rng(5), init="maxmin", init_sample=2048)
    share = float((got == want).mean())
    print(f"packed kmeans_partition: equal assignments {share:.4f}")
    assert share >= 0.995
    j_cent = jax_bulk._segment_centroids(jdev, members, want, 12)
    t_cent = bulk._segment_centroids(tdev, members, want, 12)
    assert t_cent.shape == (12, 64)
    np.testing.assert_allclose(t_cent.numpy(), np.asarray(j_cent), rtol=0, atol=1e-6)
    parent = np.arange(12)
    np.testing.assert_array_equal(
        bulk._cluster_adjacency(distances.HAMMING, t_cent, parent, 4),
        np.array(jax_bulk._cluster_adjacency_jit(j_cent, jnp.asarray(parent.astype(np.int32)), metric_name="hamming", A=4)),
    )


# --------------------------------------------------------------------------
# The API on packed metrics and the conversions between metrics
# --------------------------------------------------------------------------

N_API, D_API = 400, 48


def _data(n=N_API, d=D_API, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _open(pkg, path, metric_value, **kw):
    if pkg is hannoy_tpu_torch:
        kw.setdefault("device", "cpu")
    return pkg.Database(path, pkg.Metric(metric_value), **kw)


def _scan(db) -> dict[bytes, bytes]:
    return dict(db._db.prefix_iter(db._env.read_txn(), b""))


def _fill(pkg, path, metric_value, data, m=8, ef=32):
    db = _open(pkg, path, metric_value)
    w = db.writer(data.shape[1], m=m, ef=ef)
    w.add_items(range(len(data)), data)
    w.builder(seed=42).build()
    assert db.commit_rw_txn()
    return db


def _assert_same_records(got: dict, want: dict):
    for mode in schema.NodeMode:
        g = {k: v for k, v in got.items() if schema.Key.from_bytes(k).mode == mode}
        w = {k: v for k, v in want.items() if schema.Key.from_bytes(k).mode == mode}
        assert g.keys() == w.keys(), mode
        differing = [k for k in w if g[k] != w[k]]
        assert not differing, (mode, len(differing), len(w))


@pytest.mark.parametrize("metric_value", ["hamming", "bq_cosine", "bq_euclidean", "bq_manhattan"])
def test_packed_store_parity_and_cross_package_readers(tmp_path, metric_value):
    """The same add_items + build through both Writers leaves equal
    records under every key, and either Reader answers from the store the
    other package wrote (ids and distances exactly: packed distances are
    exact)."""
    data = _data()
    queries = _data(16, seed=1)
    scans, answers = {}, {}
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        db = _fill(pkg, tmp_path / pkg.__name__, metric_value, data)
        scans[pkg] = _scan(db)
        db.reader().assert_validity()
        db.close()
    _assert_same_records(scans[hannoy_tpu_torch], scans[hannoy_tpu])
    for writer_pkg in (hannoy_tpu, hannoy_tpu_torch):
        for reader_pkg in (hannoy_tpu, hannoy_tpu_torch):
            db = _open(reader_pkg, tmp_path / writer_pkg.__name__, metric_value)
            r = db.reader()
            assert r.n_items() == N_API and r.dimensions() == D_API
            answers[writer_pkg, reader_pkg] = [s.nns for s in r.nns(5).ef_search(32).by_vectors(queries)]
            db.close()
    first = answers[hannoy_tpu, hannoy_tpu]
    assert all(len(row) == 5 for row in first)
    for key, got in answers.items():
        assert got == first, key


def test_reader_checks_the_metric_of_a_packed_store(tmp_path):
    _fill(hannoy_tpu, tmp_path / "s", "bq_cosine", _data(60)).close()
    db = Database(tmp_path / "s", Metric.COSINE, device="cpu")
    with pytest.raises(errors.UnmatchingDistance):
        db.reader()
    db.close()
    db = Database(tmp_path / "s", Metric.BQ_COSINE, device="cpu", tier="int8")  # packed metrics ignore the tier
    r = db.reader()
    assert r._dev.vectors.dtype == torch.int32 and len(r.by_vec(_data(1, seed=2)[0], n=3)) == 3
    db.close()


@pytest.mark.parametrize("pkg", [hannoy_tpu, hannoy_tpu_torch], ids=["jax", "torch"])
def test_item_vector_roundtrip_packed(tmp_path, pkg):
    """BQ vectors come back truncated to the dimensions as ±1, binary
    ones as 0/1 (the case of tests/test_api.py)."""
    for metric_value, want in (("bq_cosine", [1.0, -1.0, 1.0]), ("hamming", [1.0, 0.0, 1.0])):
        db = _open(pkg, tmp_path / metric_value, metric_value)
        w = db.writer(3, m=4)
        w.add_item(0, [1.0, -1.5, 2.0])
        w.builder().build()
        db.commit_rw_txn()
        reader = db.reader()
        assert reader.item_vector(0) == want and w.item_vector(0) == want
        assert reader.item_vector(99) is None
        assert [v for _, v in reader.iter()] == [want]
        db.close()


def _converted(pkg, path, old, new, data):
    """fill under ``old`` → prepare_changing_distance(new) → (records after
    the prepare, records after build + commit, links records before)."""
    db = _fill(pkg, path, old, data)
    links_before = {k for k in _scan(db) if schema.Key.from_bytes(k).mode == schema.NodeMode.LINKS}
    w = db.writer(data.shape[1], m=8, ef=32)
    w2 = w.prepare_changing_distance(pkg.Metric(new))
    wtxn = db._wtxn()
    prepared = dict(db._db.prefix_iter(wtxn, b""))
    w2.builder(seed=42).build()
    w2._database.commit_rw_txn()
    built = _scan(db)
    db.close()
    return prepared, built, links_before


@pytest.mark.parametrize(
    "old, new, keeps_links",
    [("cosine", "bq_cosine", True), ("euclidean", "bq_euclidean", True), ("cosine", "bq_euclidean", False),
     ("bq_cosine", "hamming", False), ("euclidean", "cosine", False), ("cosine", "cosine", True)],
)
def test_prepare_changing_distance_leaves_the_jax_writers_records(tmp_path, old, new, keeps_links):
    """The plain → "binary quantized <same>" fast path keeps the links
    records and the metadata; every other change drops them; the same
    metric is a no-op. Equal records after the prepare and after the
    rebuild, through both Writers."""
    data = _data(300)
    j_prep, j_built, _ = _converted(hannoy_tpu, tmp_path / "j", old, new, data)
    t_prep, t_built, links_before = _converted(hannoy_tpu_torch, tmp_path / "t", old, new, data)
    _assert_same_records(t_prep, j_prep)
    _assert_same_records(t_built, j_built)
    links_after = {k for k in t_prep if schema.Key.from_bytes(k).mode == schema.NodeMode.LINKS}
    assert (links_after == links_before) == keeps_links and (not keeps_links) == (not links_after)
    journal = [k for k in t_prep if schema.Key.from_bytes(k).mode == schema.NodeMode.UPDATED]
    assert len(journal) == (0 if old == new else 300)
    db = Database(tmp_path / "t", Metric(new), device="cpu")
    r = db.reader()
    r.assert_validity()
    assert r.n_items() == 300
    codec = Metric(new).distance.codec
    want = codecs.unpack(codecs.pack(codecs.unpack(codecs.pack(data[5:6], Metric(old).distance.codec), D_API, Metric(old).distance.codec), codec), D_API, codec)[0]
    assert r.item_vector(5) == [float(x) for x in want]
    hit = r.by_vec(data[7], n=1, ef_search=48)[0]
    assert hit[0] == 7 or new != "cosine"  # quantised metrics tie; the plain one finds itself
    db.close()


def test_bq_migration_fast_path(tmp_path):
    """tests/test_api.py's case on the port: cosine → BQ cosine keeps the
    graph, and the new Reader serves ±1 vectors."""
    data = np.random.default_rng(3).standard_normal((120, 64)).astype(np.float32)
    db = Database(tmp_path / "m", Metric.COSINE, device="cpu", tier="bf16")
    with db.writer(64, m=8, ef=48) as w:
        w.add_items(range(120), data)
    w2 = db.writer(64, m=8, ef=48).prepare_changing_distance(Metric.BQ_COSINE)
    assert w2._database.device == db.device and w2._database.tier == "bf16" and w2._database.metric is Metric.BQ_COSINE
    w2.builder().build()
    w2._database.commit_rw_txn()
    db.close()
    db_bq = Database(tmp_path / "m", Metric.BQ_COSINE, device="cpu")
    reader = db_bq.reader()
    reader.assert_validity()
    assert reader.n_items() == 120
    assert reader.item_vector(5) == [1.0 if x > 0 else -1.0 for x in data[5]]
    assert reader.n_nodes() is not None
    db_bq.close()


@pytest.mark.parametrize("metric_value", ["cosine", "bq_cosine"])
def test_prepare_foreign_conversion_leaves_the_jax_writers_records(tmp_path, metric_value):
    """Foreign junk in the key space (a bogus links row, a truncated item
    record) goes, well-formed items are journaled and relinked."""
    data = _data(80, 8)
    out = {}
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        key = pkg.store.schema.Key
        db = _fill(pkg, tmp_path / pkg.__name__, metric_value, data)
        w = db.writer(8, m=8, ef=32)
        wtxn = db._wtxn()
        db._db.put(wtxn, key.links(0, 9999, 7).to_bytes(), b"\x01garbage")
        db._db.put(wtxn, key.item(0, 5000).to_bytes(), b"\x00\x00\x04HDRshort")
        assert w.prepare_foreign_conversion() == 80
        prepared = dict(db._db.prefix_iter(wtxn, b""))
        w.builder(seed=42).build()
        db.commit_rw_txn()
        reader = db.reader()
        reader.assert_validity()
        assert reader.n_items() == 80 and not reader.contains_item(5000)
        out[pkg] = (prepared, _scan(db))
        db.close()
    _assert_same_records(out[hannoy_tpu_torch][0], out[hannoy_tpu][0])
    _assert_same_records(out[hannoy_tpu_torch][1], out[hannoy_tpu][1])
    modes = {schema.Key.from_bytes(k).mode for k in out[hannoy_tpu_torch][0]}
    assert modes == {schema.NodeMode.ITEM, schema.NodeMode.UPDATED}


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_every_metric_builds_commits_reopens_and_searches(tmp_path, metric):
    data = _data(300, 40, seed=4)
    db = Database(tmp_path / "d", metric, device="cpu")
    w = db.writer(40, m=8, ef=32)
    w.add_items(range(300), data)
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    db = Database(tmp_path / "d", metric, device="cpu")
    r = db.reader()
    r.assert_validity()
    assert r._dev.vectors.dtype == distances.device_dtype(metric.distance)
    rows = r.by_vecs(data[:20], n=5, ef_search=48)
    assert all(len(row) == 5 and row[0][1] <= row[-1][1] for row in rows)
    # each vector's own distance is the least there is (0 but for rounding)
    assert all(row[0][1] <= 1e-5 for row in rows)
    db.close()
