"""Filtered and by-item search in the port against the JAX package, on
the CPU.

* ``beam_search_filtered`` and ``hnsw_search_filtered`` on device graphs
  both packages make from the same arrays (1500 x 32 cosine, 1500 x 64 BQ
  cosine), with a sparse and a dense candidate mask: ids, the iteration
  count and the per-row ``active`` flags equal exactly, distances to 1e-5
  absolute plus 1e-6 relative (cosine; BQ cosine is one f32 ulp apart);
* the Readers: both packages answer on one store the JAX Writer wrote
  (and on that store after deletions), with equal ``Searched`` rows —
  ids, distances to the tolerance above, ``truncated`` — on the linear
  side (200 candidates), the graph side (1,200 candidates with
  ``linear_below(100)``), disjoint candidates, a count above the
  candidate set, and ``by_items`` with an absent id;
* the JAX package's own cases (``tests/test_api.py:196-371`` but
  cancellation, ``tests/test_beam.py:88``) run on the port.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hannoy_tpu
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import beam as jax_beam
from hannoy_tpu.ops import distances as jax_distances
import hannoy_tpu_torch
from hannoy_tpu_torch import Database, Metric
from hannoy_tpu_torch.build import builder
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.models.flat import flat_topk
from hannoy_tpu_torch.ops import beam, codecs, distances

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, EF = 1500, 32, 8, 32
N_QUERIES = 24


def _data(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


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


# --------------------------------------------------------------------------
# (a) the filtered beam on graphs made from the same arrays
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    """name -> (port HostGraph, packed queries, their headers): port wave
    builds of 1500 x 32 cosine and 1500 x 64 BQ cosine."""
    out = {}
    for name, d in (("cosine", 32), ("binary quantized cosine", 64)):
        metric = distances.by_name(name)
        data = _data(N, d, seed=1)
        g = hnsw.HostGraph.empty(metric, d, M, 2 * M, capacity=hnsw.slot_capacity(N))
        for i in range(N):
            g.alloc_slot(i)
        g.vectors[:N] = codecs.pack(data, metric.codec)
        g.norms[:N] = distances.np_norms(metric, g.vectors[:N])
        builder.build_graph(g, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=EF, wave_size=128, bulk=False), device="cpu")
        queries = codecs.pack(_data(N_QUERIES, d, seed=2), metric.codec)
        out[name] = (g, queries, distances.np_norms(metric, queries))
    return out


def _mask(g, share: float) -> np.ndarray:
    rng = np.random.default_rng(int(share * 1000))
    mask = np.zeros(g.capacity, dtype=bool)
    mask[rng.choice(N, int(share * N), replace=False)] = True
    return mask


def _assert_dists(name, got, want):
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    if name == "binary quantized cosine":
        np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1.2e-7)
    else:
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("runner", ["beam_search_filtered", "hnsw_search_filtered"])
@pytest.mark.parametrize("share", [0.05, 0.6], ids=["sparse", "dense"])
@pytest.mark.parametrize("name", ["cosine", "binary quantized cosine"])
def test_filtered_search_matches_jax(graphs, name, share, runner):
    g, queries, qn = graphs[name]
    mask = _mask(g, share)
    ef = 48
    tdev = hnsw.to_device(g, "cpu", serve_only=True)
    jdev = jax_hnsw.to_device(_jax_host(g), cache=False, serve_only=True)
    tq = torch.from_numpy(distances.as_lanes(queries) if g.metric.is_packed else queries)
    tqn = torch.from_numpy(qn)
    if runner == "beam_search_filtered":
        start = beam._descend_start(tdev, tq, tqn).to(torch.int32)
        got = beam.beam_search_filtered(tdev, tq, tqn, start, ef, torch.from_numpy(mask))
        want = jax_beam.beam_search_filtered(
            jdev, jnp.asarray(queries), jnp.asarray(qn), jnp.asarray(start.numpy()), ef, jnp.asarray(mask)
        )
    else:
        got = beam.hnsw_search_filtered(tdev, tq, tqn, torch.from_numpy(mask), ef)
        want = jax_beam.hnsw_search_filtered(jdev, jnp.asarray(queries), jnp.asarray(qn), jnp.asarray(mask), ef)
    slots = got.slots.numpy()
    np.testing.assert_array_equal(slots, np.asarray(want.slots))
    assert int(got.iters) == int(want.iters)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    _assert_dists(name, got.dists.numpy(), np.asarray(want.dists))
    assert mask[slots[slots >= 0]].all()  # only candidates come back
    assert (slots[:, :10] >= 0).all()


# --------------------------------------------------------------------------
# (b) both Readers on one store the JAX Writer wrote
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    """{"fresh": directory the JAX Writer built at 1500 x 32 cosine,
    "deleted": a copy after the JAX Writer deleted 100 items}, and the
    deleted ids."""
    fresh = tmp_path_factory.mktemp("jax_fresh")
    db = hannoy_tpu.Database(fresh, hannoy_tpu.Metric.COSINE)
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    deleted = shutil.copytree(fresh, tmp_path_factory.mktemp("jax_deleted") / "db")
    doomed = sorted(np.random.default_rng(46).choice(N, 100, replace=False).tolist())
    db = hannoy_tpu.Database(deleted, hannoy_tpu.Metric.COSINE)
    w = db.writer(D, m=M, ef=EF)
    for i in doomed:
        w.del_item(i)
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    return {"fresh": fresh, "deleted": deleted}, doomed


def _both(path, ask):
    """``ask(reader)`` with the JAX package's Reader, then the port's."""
    out = []
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        kw = {"device": "cpu"} if pkg is hannoy_tpu_torch else {}
        db = pkg.Database(path, pkg.Metric.COSINE, **kw)  # one exclusive lock per path: close before the next
        try:
            out.append(ask(db.reader()))
        finally:
            db.close()
    return out


def _assert_searched_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert [i for i, _ in g.nns] == [i for i, _ in w.nns]
        np.testing.assert_allclose([d for _, d in g.nns], [d for _, d in w.nns], rtol=1e-6, atol=1e-5)
        assert (g.did_cancel, g.truncated) == (w.did_cancel, w.truncated)


_RNG_CANDS = np.random.default_rng(47)
CANDS_200 = sorted(_RNG_CANDS.choice(N, 200, replace=False).tolist())
CANDS_1200 = sorted(_RNG_CANDS.choice(N, 1200, replace=False).tolist())
CANDS_30 = sorted(_RNG_CANDS.choice(N, 30, replace=False).tolist())
ITEMS = [3, 999_999, 7, CANDS_200[0], CANDS_1200[5], 1499, 0]

CASES = {
    # by_vectors: (count, ef, linear_below, candidates)
    "linear": lambda r, q: r.nns(10).ef_search(64).candidates(CANDS_200).by_vectors(q),
    "graph": lambda r, q: r.nns(10).ef_search(64).linear_below(100).candidates(CANDS_1200).by_vectors(q),
    "disjoint": lambda r, q: r.nns(10).candidates([5000, 5001]).by_vectors(q),
    "count_over_candidates": lambda r, q: r.nns(50).ef_search(64).linear_below(5).candidates(CANDS_30).by_vectors(q),
    "by_items": lambda r, q: r.nns(10).ef_search(64).by_items(ITEMS),
    "by_items_linear": lambda r, q: r.nns(10).candidates(CANDS_200).by_items(ITEMS),
    "by_items_graph": lambda r, q: r.nns(10).ef_search(64).linear_below(100).candidates(CANDS_1200).by_items(ITEMS),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("store", ["fresh", "deleted"])
def test_both_readers_agree(tmp_path, jax_stores, store, case):
    stores, doomed = jax_stores
    path = shutil.copytree(stores[store], tmp_path / "copy")
    queries = _data(N_QUERIES, seed=5)
    want, got = _both(path, lambda r: CASES[case](r, queries))
    _assert_searched_equal(got, want)
    rows = [s for s in got if s is not None]
    if case == "disjoint":
        assert all(s.nns == [] for s in rows)
    elif case.startswith("by_items"):
        present = [i for i in ITEMS if i < N and not (store == "deleted" and i in doomed)]
        assert len(rows) == len(present)
        assert all(item not in [i for i, _ in s.nns] for item, s in zip(present, rows))
    if store == "deleted":
        assert not {i for s in rows for i, _ in s.nns} & set(doomed)
    if case in ("linear", "graph", "count_over_candidates", "by_items_linear", "by_items_graph"):
        allowed = {"linear": CANDS_200, "graph": CANDS_1200, "count_over_candidates": CANDS_30,
                   "by_items_linear": CANDS_200, "by_items_graph": CANDS_1200}[case]
        assert {i for s in rows for i, _ in s.nns} <= set(allowed)


def test_reader_by_vecs_and_by_items_take_candidates(tmp_path, jax_stores):
    """``Reader.by_vecs(candidates=)`` and ``Reader.by_items`` are the
    QueryBuilder's calls (python.rs-style surface)."""
    path = shutil.copytree(jax_stores[0]["fresh"], tmp_path / "copy")
    db = Database(path, Metric.COSINE, device="cpu")
    r = db.reader()
    queries = _data(N_QUERIES, seed=5)
    assert r.by_vecs(queries, n=10, ef_search=64, candidates=CANDS_200) == [
        s.nns for s in r.nns(10).ef_search(64).candidates(CANDS_200).by_vectors(queries)]
    rows = r.by_items(ITEMS, n=4, ef_search=64)
    assert rows == [None if s is None else s.nns for s in r.nns(4).ef_search(64).by_items(ITEMS)]
    assert rows[1] is None and all(len(row) == 4 for row in rows if row is not None)
    assert r.nns(4).by_item(999_999) is None
    db.close()


# --------------------------------------------------------------------------
# (c) the JAX package's own cases on the port
# --------------------------------------------------------------------------


@pytest.fixture
def db(tmp_path):
    d = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    yield d
    d.close()


def _fill(db, n, d, seed=0, m=8):
    data = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    with db.writer(d, m=m, ef=48) as w:
        w.add_items(range(n), data)
    return data


def test_by_item_excludes_self(db):
    _fill(db, 200, 8)
    reader = db.reader()
    ids = [i for i, _ in reader.nns(5).ef_search(64).by_item(3).nns]
    assert 3 not in ids and len(ids) == 5
    assert reader.nns(5).by_item(999999) is None


def test_filtered_search_exact(db, rng):
    """Small candidate sets take the linear scan and are exact."""
    data = _fill(db, 300, 16)
    reader = db.reader()
    cand = sorted(rng.choice(300, size=20, replace=False).tolist())
    ids = [i for i, _ in reader.nns(5).candidates(cand).by_vector(data[0]).nns]
    d = ((data[cand] - data[0]) ** 2).sum(1)
    assert ids == [cand[j] for j in np.argsort(d)[:5]]


def test_filtered_search_graph_path(db, rng):
    data = _fill(db, 400, 16)
    reader = db.reader()
    cand = sorted(rng.choice(400, size=350, replace=False).tolist())
    ids = [i for i, _ in reader.nns(10).ef_search(80).linear_below(10).candidates(cand).by_vector(data[0]).nns]
    assert set(ids) <= set(cand) and len(ids) == 10


def test_filtered_search_exact_batched(db, rng):
    data = _fill(db, 300, 16)
    reader = db.reader()
    cand = sorted(rng.choice(300, size=20, replace=False).tolist())
    rows = reader.by_vecs(data[:6], n=5, candidates=cand)
    for b in range(6):
        d = ((data[cand] - data[b]) ** 2).sum(1)
        assert [i for i, _ in rows[b]] == [cand[j] for j in np.argsort(d)[:5]]


def test_filtered_search_graph_path_batched(db, rng):
    data = _fill(db, 400, 16)
    reader = db.reader()
    cand = sorted(rng.choice(400, size=350, replace=False).tolist())
    searched = reader.nns(10).ef_search(80).linear_below(10).candidates(cand).by_vectors(data[:6])
    for b, res in enumerate(searched):
        ids = [i for i, _ in res.nns]
        assert set(ids) <= set(cand) and len(ids) == 10
        single = reader.nns(10).ef_search(80).linear_below(10).candidates(cand).by_vector(data[b])
        assert ids == [i for i, _ in single.nns]


def test_batched_filtered_disjoint_candidates(db):
    _fill(db, 50, 8)
    assert db.reader().by_vecs(np.zeros((3, 8), np.float32), n=5, candidates=[1000, 1001]) == [[], [], []]


def test_batched_count_more_than_candidates(db, rng):
    """The degraded top-up honours the candidates filter."""
    data = _fill(db, 100, 8)
    reader = db.reader()
    cand = sorted(rng.choice(100, size=30, replace=False).tolist())
    for res in reader.nns(50).ef_search(64).linear_below(5).candidates(cand).by_vectors(data[:3]):
        assert {i for i, _ in res.nns} == set(cand)


def test_by_items_batched(db):
    data = _fill(db, 200, 8)
    rows = db.reader().nns(5).ef_search(64).by_items([3, 999999, 7])
    assert rows[1] is None
    for b, item in [(0, 3), (2, 7)]:
        ids = [i for i, _ in rows[b].nns]
        assert item not in ids and len(ids) == 5
        d = ((data - data[item]) ** 2).sum(1)
        d[item] = np.inf
        assert len(set(ids) & set(np.argsort(d)[:5].tolist())) >= 4
        assert ids[0] == int(np.argmin(d))


def test_by_items_filtered_exact(db, rng):
    data = _fill(db, 300, 16)
    reader = db.reader()
    cand = sorted(rng.choice(300, size=20, replace=False).tolist())
    rows = reader.nns(5).candidates(cand).by_items([cand[0], 999999, cand[5]])
    assert rows[1] is None
    for b, item in [(0, cand[0]), (2, cand[5])]:
        d = ((data[cand] - data[item]) ** 2).sum(1)
        assert [i for i, _ in rows[b].nns] == [cand[j] for j in np.argsort(d) if cand[j] != item][:5]


def test_by_items_filtered_graph_path(db, rng):
    _fill(db, 400, 16)
    reader = db.reader()
    cand = sorted(rng.choice(400, size=350, replace=False).tolist())
    rows = reader.nns(10).ef_search(80).linear_below(10).candidates(cand).by_items([cand[0], cand[1]])
    for b, item in [(0, cand[0]), (1, cand[1])]:
        ids = [i for i, _ in rows[b].nns]
        assert item not in ids and set(ids) <= set(cand) and len(ids) == 10


def test_by_items_count_more_than_candidates(db, rng):
    """The per-row top-up excludes each row's own item."""
    _fill(db, 100, 8)
    reader = db.reader()
    cand = sorted(rng.choice(100, size=30, replace=False).tolist())
    notc = next(i for i in range(100) if i not in cand)
    rows = reader.nns(50).ef_search(64).linear_below(5).candidates(cand).by_items([cand[0], notc])
    assert {i for i, _ in rows[0].nns} == set(cand) - {cand[0]}
    assert {i for i, _ in rows[1].nns} == set(cand)


def test_by_items_convenience(db):
    _fill(db, 150, 8)
    rows = db.reader().by_items([3, 999999, 7], n=4, ef_search=64)
    assert rows[1] is None and len(rows[0]) == 4 and len(rows[2]) == 4
    assert all(isinstance(i, int) for i, _ in rows[0]) and 3 not in [i for i, _ in rows[0]]


def test_linear_below_ratio_and_defaults(db):
    """The linear side needs fewer candidates than ``linear_below`` and at
    most ``linear_below_ratio`` of the items (reader.rs:622-640)."""
    _fill(db, 100, 8)
    reader = db.reader()
    qb = reader.nns(5).candidates(range(40))
    assert (qb._linear_below, qb._linear_below_ratio) == (hannoy_tpu.api.DEFAULT_LINEAR_SCAN_THRESHOLD,
                                                          hannoy_tpu.api.DEFAULT_LINEAR_SCAN_THRESHOLD_RATIO)
    assert reader._should_linear_scan(qb)
    assert not reader._should_linear_scan(qb.linear_below_ratio(0.3))
    assert not reader._should_linear_scan(reader.nns(5))
    with pytest.raises(ValueError):
        qb.linear_below_ratio(1.5)


def test_filtered_beam_excludes_non_candidates():
    """tests/test_beam.py:88 — no non-candidate leaks, and recall against
    the exact answer over the candidates."""
    rng = np.random.default_rng(42)
    n, d, k = 400, 16, 10
    data = rng.standard_normal((n, d)).astype(np.float32)
    g = hnsw.HostGraph.empty(distances.EUCLIDEAN, d, 8, 16, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(distances.EUCLIDEAN, data)
    builder.build_graph(g, np.arange(n, dtype=np.int64), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=48), device="cpu")
    dev = hnsw.to_device(g, "cpu", serve_only=True)
    queries = rng.standard_normal((8, d)).astype(np.float32)
    q = torch.from_numpy(queries)
    qn = torch.from_numpy(distances.np_norms(distances.EUCLIDEAN, queries))
    cand = np.zeros(dev.capacity, dtype=bool)
    cand[rng.choice(n, size=120, replace=False)] = True
    res = beam.hnsw_search_filtered(dev, q, qn, torch.from_numpy(cand), ef=40)
    slots = res.slots.numpy()
    assert cand[slots[slots >= 0]].all(), "non-candidate leaked into filtered results"
    _, exact_s = flat_topk("euclidean", q, qn, dev.vectors, dev.norms, dev.valid & torch.from_numpy(cand), k)
    recall = np.mean([len(set(a[a >= 0]) & set(b)) / k for a, b in zip(slots[:, :k], exact_s.numpy())])
    assert recall >= 0.85, f"filtered recall {recall}"
