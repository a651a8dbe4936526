"""The bf16 and int8 storage tiers of the port against the JAX package, on
the CPU, with inputs made from numpy seeds and fed to both.

The JAX package selects a tier by ``HANNOY_TPU_BF16`` / ``HANNOY_TPU_INT8``
when ``to_device`` runs; the port takes ``tier=`` as an argument. The
tests set the variable with ``monkeypatch``, read the JAX device rows back
as numpy and hold the port's encoders to them bit for bit.

Tolerances. Both packages compute on the same rounded rows, so distances
differ by the order of their f32 sums only: 1e-5 relative (cosine, a
unit-scale quantity: 1e-5 absolute; the euclidean norm expansion
``|q|²+|p|²-2qp`` cancels, so it is held at 1e-5 of ``|q|²+|p|²``). A wave
build on tier rows must reproduce the JAX build's levels and entry points
and 98% of its ``links0`` rows (near-ties may flip). Recall of a tier is
taken against the exact f32 neighbours by id, so that the quantisation
itself is under test, as ``tests/test_builder.py`` does (its bars).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.build import bulk as jax_bulk
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import distances as jax_distances
from hannoy_tpu.ops import prune as jax_prune
from hannoy_tpu_torch import Database, Metric, errors
from hannoy_tpu_torch.build import builder, bulk
from hannoy_tpu_torch.models import flat, hnsw
from hannoy_tpu_torch.ops import beam, beam_cuda, distances, prune

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

F32 = ["cosine", "euclidean", "manhattan"]
TIERS = ["bf16", "int8"]
ENV = {"bf16": "HANNOY_TPU_BF16", "int8": "HANNOY_TPU_INT8"}
M, M0 = 8, 16


def _stage(mod, data, name):
    dist = jax_distances if mod is jax_hnsw else distances
    n, d = data.shape
    g = mod.HostGraph.empty(dist.by_name(name), d, M, M0, capacity=jax_hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(distances.by_name(name), data)
    return g


def _jax_dev(monkeypatch, g, tier, **kw):
    """The JAX package's upload of ``g`` under ``tier``."""
    with monkeypatch.context() as mp:
        if tier != "raw":
            mp.setenv(ENV[tier], "1")
        return jax_hnsw.to_device(g, cache=False, **kw)


def _bits(a) -> np.ndarray:
    """Device rows of either package as integers of their bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * rng.uniform(0.2, 3.0, (n, 1))).astype(np.float32)
    x[3] = 0.0  # a zero row: header 0, distance 0 under cosine
    return rng, x


@pytest.mark.parametrize("tier", ["raw"] + TIERS)
@pytest.mark.parametrize("name", F32)
def test_tier_encoders_bit_equal_jax(monkeypatch, name, tier):
    _, x = _data(1, 300, 40)
    jdev = _jax_dev(monkeypatch, _stage(jax_hnsw, x, name), tier)
    tdev = hnsw.to_device(_stage(hnsw, x, name), "cpu", tier=tier)
    want_dtype = {"raw": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[tier]
    assert tdev.vectors.dtype == want_dtype and str(jdev.vectors.dtype) == str(want_dtype).split(".")[1]
    np.testing.assert_array_equal(_bits(tdev.vectors), _bits(jdev.vectors))
    np.testing.assert_array_equal(tdev.norms.numpy(), np.asarray(jdev.norms))
    if tier == "int8":
        assert tdev.norms[3] == 0 and (tdev.vectors[3] == 0).all()
        # every euclidean / manhattan row reaches 127; a cosine row has length 127
        peak = tdev.vectors[:3].abs().amax(-1)
        assert (peak == 127).all() if name != "cosine" else (peak < 127).all()
    # the JAX package's arrays, handed over as they are, give the same rows
    state = {f: np.asarray(getattr(jdev, f)) for f in
             ("vectors", "norms", "links0", "dists0", "upper_links", "upper_dists", "slot_rows", "entry_slots", "valid")}
    copy = hnsw.device_graph_from_arrays("cpu", **state, metric_name=name, max_level=0)
    assert copy.vectors.dtype == want_dtype
    np.testing.assert_array_equal(_bits(copy.vectors), _bits(tdev.vectors))


def test_packed_metrics_ignore_the_tier_and_bad_tiers_raise(tmp_path):
    from hannoy_tpu_torch.ops import codecs

    x = np.random.default_rng(2).standard_normal((50, 70)).astype(np.float32)
    g = hnsw.HostGraph.empty(distances.HAMMING, 70, M, M0)
    lanes = codecs.pack(x, distances.HAMMING.codec)
    g.vectors[:50] = lanes
    dev = hnsw.to_device(g, "cpu", tier="int8")
    assert dev.vectors.dtype == torch.int32
    np.testing.assert_array_equal(dev.vectors[:50].numpy().view(np.uint32), lanes)
    with pytest.raises(ValueError):
        hnsw.to_device(g, "cpu", tier="fp8")
    with pytest.raises(errors.InvalidConfig):
        Database(tmp_path / "x", Metric.COSINE, device="cpu", tier="fp8")


def _tier_rows(monkeypatch, x, name, tier):
    """Rows and headers of ``x`` under ``tier`` for both packages."""
    jdev = _jax_dev(monkeypatch, _stage(jax_hnsw, x, name), tier)
    tdev = hnsw.to_device(_stage(hnsw, x, name), "cpu", tier=tier)
    n = len(x)
    return (jdev.vectors[:n], jdev.norms[:n]), (tdev.vectors[:n], tdev.norms[:n])


def _close(name, got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    if name == "cosine":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    elif scale is not None:
        assert np.all(np.abs(got - want) <= 1e-5 * np.asarray(scale) + 1e-6), float(np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("query", ["search", "build"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", F32)
def test_tier_gathered_distances_match_jax(monkeypatch, name, tier, query):
    """A search's queries are f32 with ``np_norms`` headers; a build's are
    rows gathered from the tier store with their headers (int8: scales)."""
    rng, x = _data(3, 300, 40)
    (jv, jn), (tv, tn) = _tier_rows(monkeypatch, x, name, tier)
    B, K = 10, 12
    idx = rng.integers(0, 300, (B, K)).astype(np.int32)
    idx[::3, ::5] = -1
    safe = np.maximum(idx, 0)
    if query == "search":
        q = x[:B] + 0.1
        qn = distances.np_norms(distances.by_name(name), q)
        jq, jqn, tq, tqn = jnp.asarray(q), jnp.asarray(qn), torch.from_numpy(q), torch.from_numpy(qn)
    else:
        jq, jqn, tq, tqn = jv[:B], jn[:B], tv[:B], tn[:B]
    want = jax_distances.gathered_distances(jax_distances.by_name(name), jq, jqn, jv[safe], jn[safe])
    before = beam_cuda.KERNEL.launches
    got = beam_cuda.gathered_distances(distances.by_name(name), tv, tn, tq, tqn, torch.from_numpy(idx))
    assert beam_cuda.KERNEL.launches == before and got.dtype == torch.float32
    _close(name, got.numpy(), want)
    assert beam_cuda.form_of(distances.by_name(name), tv.dtype) == (tier, "dot" if name == "cosine" else "difference")


@pytest.mark.parametrize("query", ["search", "build"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", F32)
def test_tier_matrix_distances_and_flat_topk_match_jax(monkeypatch, name, tier, query):
    from hannoy_tpu.models import flat as jax_flat

    _, x = _data(4, 200, 24)
    (jv, jn), (tv, tn) = _tier_rows(monkeypatch, x, name, tier)
    if query == "search":
        q = x[:16] + 0.1
        qn = distances.np_norms(distances.by_name(name), q)
        jq, jqn, tq, tqn = jnp.asarray(q), jnp.asarray(qn), torch.from_numpy(q), torch.from_numpy(qn)
    else:
        jq, jqn, tq, tqn = jv[:16], jn[:16], tv[:16], tn[:16]
    want = np.asarray(jax_distances.matrix_distances(jax_distances.by_name(name), jq, jqn, jv, jn))
    got = distances.matrix_distances(distances.by_name(name), tq, tqn, tv, tn).numpy()
    sq = (x * x).sum(-1)
    scale = (x[:16] ** 2).sum(-1)[:, None] + 1.0 + sq[None, :] if name == "euclidean" else None
    _close(name, got, want, scale)
    if query == "search":
        mask = np.ones(200, bool)
        want_d, want_s = jax_flat.flat_topk(name, jq, jqn, jv, jn, jnp.asarray(mask), 5)
        got_d, got_s = flat.flat_topk(name, tq, tqn, tv, tn, torch.from_numpy(mask), 5)
        assert float((got_s.numpy() == np.asarray(want_s)).mean()) >= 0.98
        assert got_d.dtype == torch.float32


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", F32)
def test_tier_pairwise_and_block_distances_match_jax(monkeypatch, name, tier):
    _, x = _data(5, 3 * 60, 32)
    (jv, jn), (tv, tn) = _tier_rows(monkeypatch, x, name, tier)
    jc, jcn, tc, tcn = jv.reshape(3, 60, -1), jn.reshape(3, 60), tv.reshape(3, 60, -1), tn.reshape(3, 60)
    sq = (x * x).sum(-1).reshape(3, 60)
    want = jax_prune.pairwise_block(jax_distances.by_name(name), jc[:, :20], jcn[:, :20])
    got = prune.pairwise_block(distances.by_name(name), tc[:, :20], tcn[:, :20])
    scale = sq[:, :20, None] + sq[:, None, :20] if name == "euclidean" else None
    _close(name, got.numpy(), want, scale)
    if name == "manhattan":
        with pytest.raises(ValueError):
            distances.block_distances(distances.MANHATTAN, tc[:, :20], tcn[:, :20], tc, tcn)
        return
    want = jax_distances.block_distances(jax_distances.by_name(name), jc[:, :20], jcn[:, :20], jc, jcn)
    got = distances.block_distances(distances.by_name(name), tc[:, :20], tcn[:, :20], tc, tcn)
    scale = sq[:, :20, None] + sq[:, None, :] if name == "euclidean" else None
    _close(name, got.numpy(), want, scale)


# --------------------------------------------------------------------------
# Builds and the API on tier rows
# --------------------------------------------------------------------------

N, D, EFC, WAVE = 1500, 32, 32, 128


def _clustered(n, d, seed=7, n_queries=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2.0
    data = (centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, n_queries)] + rng.standard_normal((n_queries, d))).astype(np.float32)
    return data, queries


def _exact_ids(name, data, queries, k=10):
    m = distances.by_name(name)
    exact = distances.np_pairwise(m, queries, distances.np_norms(m, queries), data, distances.np_norms(m, data))
    return np.argsort(exact, axis=1, kind="stable")[:, :k]


def _id_recall(found, exact) -> float:
    return float(np.mean([len(set(f.tolist()) & set(e.tolist())) for f, e in zip(found, exact)])) / exact.shape[1]


def test_tier_wave_build_matches_jax(monkeypatch):
    """``build_graph(tier="int8")`` uploads through the same ``to_device``
    as the JAX build under ``HANNOY_TPU_INT8=1``: it builds on int8 rows."""
    data, queries = _clustered(N, D)
    n = np.arange(N, dtype=np.int64)
    jg = _stage(jax_hnsw, data, "cosine")
    with monkeypatch.context() as mp:
        mp.setenv("HANNOY_TPU_INT8", "1")
        jax_builder.build_graph(jg, n, np.empty(0, np.int64),
                                jax_builder.BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False))
    tg = _stage(hnsw, data, "cosine")
    seen = []
    real = hnsw.to_device
    monkeypatch.setattr(hnsw, "to_device", lambda *a, **k: seen.append(k.get("tier")) or real(*a, **k))
    builder.build_graph(tg, n, np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False), device="cpu", tier="int8")
    assert seen == ["int8"] and tg.vectors.dtype == np.float32  # the host copy stays f32
    tg.check_validity()
    np.testing.assert_array_equal(tg.levels, jg.levels)
    assert tg.entry_slots == jg.entry_slots
    share = float(np.mean(np.all(tg.links0[:N] == jg.links0[:N], axis=1)))
    print(f"int8 cosine wave build: identical links0 rows {share:.4f}")
    assert share >= 0.98
    dev = real(tg, "cpu", serve_only=True, tier="int8")
    q = torch.from_numpy(queries)
    res = beam.hnsw_search(dev, q, torch.from_numpy(distances.np_norms(distances.COSINE, queries)), 64)
    rec = _id_recall(res.slots.numpy()[:, :10], _exact_ids("cosine", data, queries))
    print(f"int8 cosine wave build: recall@10 against exact f32 {rec:.4f}")
    assert rec >= 0.9


@pytest.mark.parametrize("name, tier", [("cosine", "bf16"), ("cosine", "int8"), ("euclidean", "int8"), ("manhattan", "bf16")])
def test_database_tier_builds_searches_and_reopens(tmp_path, name, tier):
    """The tier goes from the Database to its Writers' builds and its
    Readers' uploads; the files on disk are those of the raw tier."""
    data, queries = _clustered(1000, D)
    scans = {}
    for t in ("raw", tier):
        db = Database(tmp_path / t, Metric(name), device="cpu", tier=t)
        assert db.tier == t
        w = db.writer(D, m=M, ef=48)
        w.add_items(range(1000), data)
        w.builder(seed=42).build()
        db.commit_rw_txn()
        scans[t] = {k: v for k, v in db._db.prefix_iter(db._env.read_txn(), b"") if k[2] == 0}  # item records
        db.close()
    assert scans[tier] == scans["raw"]
    db = Database(tmp_path / tier, Metric(name), device="cpu", tier=tier)
    r = db.reader()
    r.assert_validity()
    assert r._dev.vectors.dtype == {"bf16": torch.bfloat16, "int8": torch.int8}[tier]
    rows = r.by_vecs(queries, n=10, ef_search=100)
    found = np.asarray([[i for i, _ in row] for row in rows])
    rec = _id_recall(found, _exact_ids(name, data, queries))
    print(f"{name} {tier}: recall@10 against exact f32 {rec:.4f}")
    assert rec >= 0.9
    assert r.item_vector(5) == [float(v) for v in data[5]]  # the store holds f32
    # append through HostGraph.load + fill_link_dists on tier rows
    w = db.writer(D, m=M, ef=48)
    w.add_items(range(1000, 1050), data[:50] + 0.01)
    w.builder(seed=42).build()
    db.commit_rw_txn()
    r = db.reader()
    r.assert_validity()
    assert r.n_items() == 1050
    db.close()


def test_tier_bulk_build_and_its_adjacency(monkeypatch):
    """A ``bulk=True`` build on int8 euclidean rows (the k-means path) is
    valid and holds the tier's recall. Its cluster adjacency compares f32
    centroids; the JAX package casts them to int8 and dequantises them by
    their header, which is 0 for a centroid, so there every cluster gets
    the same neighbours (the divergence ROADMAP.md records)."""
    monkeypatch.setattr(bulk, "BRUTE_MAX", 512)
    monkeypatch.setattr(bulk, "CLUSTER_SIZE", 256)
    data, queries = _clustered(3000, D)
    tg = _stage(hnsw, data, "euclidean")
    builder.build_graph(tg, np.arange(3000, dtype=np.int64), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=EFC, bulk=True), device="cpu", tier="int8")
    tg.check_validity()
    dev = hnsw.to_device(tg, "cpu", serve_only=True, tier="int8")
    res = beam.hnsw_search(dev, torch.from_numpy(queries), torch.zeros(len(queries)), 64)
    rec = _id_recall(res.slots.numpy()[:, :10], _exact_ids("euclidean", data, queries))
    print(f"int8 euclidean bulk build: recall@10 against exact f32 {rec:.4f}")
    assert rec >= 0.9

    members = np.arange(3000, dtype=np.int64)
    assign = np.random.default_rng(0).integers(0, 11, 3000)
    t_cent = bulk._segment_centroids(dev, members, assign, 11)
    assert t_cent.dtype == torch.float32
    adj = bulk._cluster_adjacency(distances.EUCLIDEAN, t_cent, np.arange(11), 4)
    np.testing.assert_array_equal(adj[:, 0], np.arange(11))  # each cluster is its own nearest
    jdev = _jax_dev(monkeypatch, _stage(jax_hnsw, data, "euclidean"), "int8")
    j_cent = jax_bulk._segment_centroids(jdev, members, assign, 11)
    assert str(j_cent.dtype) == "int8"
    j_adj = np.array(jax_bulk._cluster_adjacency_jit(j_cent, jnp.arange(11, dtype=jnp.int32), metric_name="euclidean", A=4))
    assert (j_adj == np.arange(4)[None, :]).all()
