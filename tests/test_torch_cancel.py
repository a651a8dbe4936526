"""Cancellation of searches and builds in the port against the JAX
package, on the CPU.

* searches: both Readers on one store the JAX Writer wrote (1500 x 32
  cosine; then the port's Writer deleted 100 items) answer every
  cancellable call — the
  four ``*_with_cancellation`` methods, ``Reader.by_vecs`` /
  ``by_items(cancel=)``, unfiltered, on the graph side of a filter and on
  its linear side — with equal ``Searched`` rows when the cancel never
  fires and when it fires at once (ids exactly, distances to 1e-5
  absolute plus 1e-6 relative, ``did_cancel`` and ``truncated``); on the
  port a cancel that never fires gives the uncancelled rows bit for bit,
  and one that fires mid-flight gives rows that are valid: live ids,
  sorted, each distance the exact one (1e-5), ``did_cancel`` on every row;
* builds: a cancel that never fires gives the port's uncancelled link
  rows exactly (by waves, by ``bulk=True``, with deletions); a cancelled
  build compared with the JAX package's by validity and recall (the JAX
  package switches a cancellable build to other algorithms, ROADMAP.md
  §3); ``BuildCancelled`` then ``abort_rw_txn`` leaves both packages'
  stores as they were, and a later build equals one never cancelled; the
  JAX package's own cancellation cases (``tests/test_builder.py:176, 317,
  353``, ``tests/test_api.py:266-393, 565, 852``) on the port.
"""

import copy
import shutil

import numpy as np
import pytest
import torch

import hannoy_tpu
from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import distances as jax_distances
import hannoy_tpu_torch
from hannoy_tpu_torch import Database, Metric, errors
from hannoy_tpu_torch.build import builder
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import codecs, distances

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, EF = 1500, 32, 8, 32
N_QUERIES = 24


def _data(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


class FireAt:
    """A cancel closure that returns True at its ``n``-th call only (0:
    never) and counts its calls."""

    def __init__(self, n: int):
        self.n, self.calls = n, 0

    def __call__(self) -> bool:
        self.calls += 1
        return self.calls == self.n


# --------------------------------------------------------------------------
# (a) searches on one store the JAX Writer wrote
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """A directory the JAX Writer built at 1500 x 32 cosine, from which the
    port's Writer then deleted 100 items (both Writers leave equal records
    after deletions, ``tests/test_torch_delete.py``), and the deleted ids."""
    path = tmp_path_factory.mktemp("jax_cancel") / "db"
    db = hannoy_tpu.Database(path, hannoy_tpu.Metric.COSINE)
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    doomed = sorted(np.random.default_rng(46).choice(N, 100, replace=False).tolist())
    db = _open(hannoy_tpu_torch, path)
    w = db.writer(D, m=M, ef=EF)
    for i in doomed:
        w.del_item(i)
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    return path, doomed


_RNG_CANDS = np.random.default_rng(47)
CANDS_200 = sorted(_RNG_CANDS.choice(N, 200, replace=False).tolist())
CANDS_1200 = sorted(_RNG_CANDS.choice(N, 1200, replace=False).tolist())
ITEMS = [3, 999_999, 7, CANDS_1200[5], 1499, 0, 20, 41]
QUERIES = _data(N_QUERIES, seed=5)

#: name -> call(reader, cancel) → list of Searched (None for an absent item)
CASES = {
    "by_vector": lambda r, c: [r.nns(10).ef_search(64).by_vector_with_cancellation(QUERIES[0], c)],
    "by_vectors": lambda r, c: r.nns(10).ef_search(64).by_vectors_with_cancellation(QUERIES, c),
    "by_item": lambda r, c: [r.nns(10).ef_search(64).by_item_with_cancellation(ITEMS[0], c)],
    "by_items": lambda r, c: r.nns(10).ef_search(64).by_items_with_cancellation(ITEMS, c),
    "filtered_graph": lambda r, c: r.nns(10).ef_search(64).linear_below(100).candidates(CANDS_1200)
    .by_vectors_with_cancellation(QUERIES, c),
    "filtered_linear": lambda r, c: r.nns(10).candidates(CANDS_200).by_vectors_with_cancellation(QUERIES, c),
    "filtered_by_items": lambda r, c: r.nns(10).ef_search(64).linear_below(100).candidates(CANDS_1200)
    .by_items_with_cancellation(ITEMS, c),
    "filtered_by_items_linear": lambda r, c: r.nns(10).candidates(CANDS_200).by_items_with_cancellation(ITEMS, c),
}
#: case -> the Reader's own cancellable call of the same search
READER_CALLS = {
    "by_vectors": lambda r, c: r.by_vecs(QUERIES, n=10, ef_search=64, cancel=c),
    "by_items": lambda r, c: r.by_items(ITEMS, n=10, ef_search=64, cancel=c),
    "filtered_graph": lambda r, c: r.by_vecs(QUERIES, n=10, ef_search=64, candidates=CANDS_1200, cancel=c),
}
#: the same searches without a cancel
PLAIN = {
    "by_vector": lambda r: [r.nns(10).ef_search(64).by_vector(QUERIES[0])],
    "by_vectors": lambda r: r.nns(10).ef_search(64).by_vectors(QUERIES),
    "by_item": lambda r: [r.nns(10).ef_search(64).by_item(ITEMS[0])],
    "by_items": lambda r: r.nns(10).ef_search(64).by_items(ITEMS),
    "filtered_graph": lambda r: r.nns(10).ef_search(64).linear_below(100).candidates(CANDS_1200).by_vectors(QUERIES),
    "filtered_linear": lambda r: r.nns(10).candidates(CANDS_200).by_vectors(QUERIES),
    "filtered_by_items": lambda r: r.nns(10).ef_search(64).linear_below(100).candidates(CANDS_1200).by_items(ITEMS),
    "filtered_by_items_linear": lambda r: r.nns(10).candidates(CANDS_200).by_items(ITEMS),
}


def _open(pkg, path):
    kw = {"device": "cpu"} if pkg is hannoy_tpu_torch else {}
    return pkg.Database(path, pkg.Metric.COSINE, **kw)  # one exclusive lock per path: close before the next


def _assert_searched_equal(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert [i for i, _ in g.nns] == [i for i, _ in w.nns]
        if exact:
            assert [d for _, d in g.nns] == [d for _, d in w.nns]
        else:
            np.testing.assert_allclose([d for _, d in g.nns], [d for _, d in w.nns], rtol=1e-6, atol=1e-5)
        assert (g.did_cancel, g.truncated) == (w.did_cancel, w.truncated)


@pytest.mark.parametrize("case", list(CASES))
def test_both_readers_agree_when_the_cancel_never_fires_or_fires_at_once(tmp_path, jax_store, case):
    path = shutil.copytree(jax_store[0], tmp_path / "copy")
    answers = {}
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        db = _open(pkg, path)
        try:
            r = db.reader()
            answers[pkg.__name__] = {"never": CASES[case](r, FireAt(0)), "at_once": CASES[case](r, FireAt(1))}
            if case in READER_CALLS:  # the Reader's own calls, by_vecs / by_items(cancel=)
                answers[pkg.__name__].update({f"reader_{k}": READER_CALLS[case](r, FireAt(k)) for k in (0, 1)})
        finally:
            db.close()
    got, want = answers["hannoy_tpu_torch"], answers["hannoy_tpu"]
    for kind in ("never", "at_once"):
        _assert_searched_equal(got[kind], want[kind])
    for kind in ("reader_0", "reader_1"):
        if kind in got:
            assert len(got[kind]) == len(want[kind])
            for g, w in zip(got[kind], want[kind]):
                assert (g is None) == (w is None) and (g is None or [i for i, _ in g] == [i for i, _ in w])
                if g:
                    np.testing.assert_allclose([d for _, d in g], [d for _, d in w], rtol=1e-6, atol=1e-5)
    assert all(s is None or (not s.did_cancel and s.nns) for s in got["never"])
    assert all(s is None or (s.did_cancel and s.nns == []) for s in got["at_once"])


def test_never_firing_cancel_gives_the_uncancelled_rows_bit_for_bit(tmp_path, jax_store):
    path = shutil.copytree(jax_store[0], tmp_path / "copy")
    db = _open(hannoy_tpu_torch, path)
    r = db.reader()
    for case in CASES:
        cancel = FireAt(0)
        _assert_searched_equal(CASES[case](r, cancel), PLAIN[case](r), exact=True)
        assert cancel.calls >= 1 or case.endswith("_linear")
    assert r.by_vecs(QUERIES, n=10, ef_search=64, cancel=FireAt(0)) == r.by_vecs(QUERIES, n=10, ef_search=64)
    assert r.by_items(ITEMS, n=10, ef_search=64, cancel=FireAt(0)) == r.by_items(ITEMS, n=10, ef_search=64)
    db.close()


@pytest.mark.parametrize("fire_at", [2, 3, 5])
@pytest.mark.parametrize("case", ["by_vectors", "by_items", "filtered_graph", "filtered_by_items"])
def test_mid_flight_cancel_gives_valid_partial_rows(tmp_path, jax_store, case, fire_at):
    """Every row: ``did_cancel``, at most 10 entries, live items only (and
    candidates only under a filter; never the item itself), sorted, each
    distance the exact one (numpy, 1e-5)."""
    path, doomed = jax_store
    db = _open(hannoy_tpu_torch, shutil.copytree(path, tmp_path / "copy"))
    r = db.reader()
    cancel = FireAt(fire_at)
    rows = CASES[case](r, cancel)
    assert cancel.calls >= fire_at
    data = _data()
    live = set(r.item_ids().to_array().tolist())
    assert not live & set(doomed)
    allowed = set(CANDS_1200) & live if case.startswith("filtered") else live
    queries = QUERIES if "items" not in case else data[[i for i in ITEMS if i in live]]
    present = [i for i in ITEMS if i in live]
    rows_present = [s for s in rows if s is not None]
    assert len(rows_present) == len(queries)
    metric = distances.COSINE
    for b, s in enumerate(rows_present):
        assert s.did_cancel and len(s.nns) <= 10
        ids = [i for i, _ in s.nns]
        dists = np.asarray([d for _, d in s.nns], dtype=np.float32)
        assert set(ids) <= allowed and len(set(ids)) == len(ids)
        if "items" in case:
            assert present[b] not in ids
        assert (np.diff(dists) >= 0).all()
        if ids:
            exact = distances.np_pairwise(metric, queries[b : b + 1], distances.np_norms(metric, queries[b : b + 1]),
                                          data[ids], distances.np_norms(metric, data[ids]))[0]
            np.testing.assert_allclose(dists, exact, rtol=0, atol=1e-5)
    if case in ("by_vectors", "filtered_graph") and fire_at >= 3:
        assert any(s.nns for s in rows_present)  # partial, not empty: the pools so far
    db.close()


def test_cancel_that_fires_at_the_final_check_sets_did_cancel(tmp_path, jax_store):
    """The search runs to its end, then the closure first returns True at
    the check after the loops (JAX ``beam.py:772, 865``): the rows are the
    full answers, without the top-up, and ``did_cancel`` is set."""
    db = _open(hannoy_tpu_torch, shutil.copytree(jax_store[0], tmp_path / "copy"))
    r = db.reader()
    probe = FireAt(0)
    r.nns(10).ef_search(64).by_vectors_with_cancellation(QUERIES, probe)
    last = FireAt(probe.calls)
    rows = r.nns(10).ef_search(64).by_vectors_with_cancellation(QUERIES, last)
    assert last.calls == probe.calls and all(s.did_cancel for s in rows)
    assert [s.nns for s in rows] == [s.nns for s in r.nns(10).ef_search(64).by_vectors(QUERIES)]
    db.close()


# --------------------------------------------------------------------------
# (b) builds
# --------------------------------------------------------------------------


def _stage(metric, data, m=M, m0=2 * M):
    n = len(data)
    g = hnsw.HostGraph.empty(metric, data.shape[1], m, m0, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = codecs.pack(data, metric.codec)
    g.norms[:n] = distances.np_norms(metric, g.vectors[:n])
    return g


def _graph_arrays(g):
    return [g.links0, g.dists0, *g.upper_links, *g.upper_dists, np.asarray(g.entry_slots), g.levels]


@pytest.mark.parametrize("path", ["waves", "bulk", "delete"])
def test_never_firing_cancel_builds_the_same_graph(path):
    base = _stage(distances.COSINE, _data())
    if path == "delete":  # one built graph, then a deletion build of each copy
        builder.build_graph(base, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=EF, wave_size=128, bulk=False), device="cpu")
    graphs = []
    for cancel in (None, FireAt(0)):
        opts = builder.BuildOptions(ef_construction=EF, wave_size=128, bulk=(path == "bulk"))
        if cancel is not None:
            opts.cancel = cancel
        g = copy.deepcopy(base)
        if path == "delete":
            stats = builder.build_graph(g, np.empty(0, np.int64), np.arange(0, N, 15, dtype=np.int64), opts, device="cpu")
        else:
            stats = builder.build_graph(g, np.arange(N, dtype=np.int64), np.empty(0, np.int64), opts, device="cpu")
        graphs.append((g, stats))
        if cancel is not None:
            assert cancel.calls > 1
    (a, sa), (b, sb) = graphs
    for x, y in zip(_graph_arrays(a), _graph_arrays(b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(sa.touched, sb.touched)
    assert sa.waves == sb.waves


def _exact_recall(g, data, queries, k=10, ef=64):
    from hannoy_tpu_torch.ops import beam

    metric = g.metric
    dev = hnsw.to_device(g, "cpu", serve_only=True)
    res = beam.hnsw_search(dev, torch.from_numpy(queries), torch.from_numpy(distances.np_norms(metric, queries)), ef)
    exact = np.sort(distances.np_pairwise(metric, queries, distances.np_norms(metric, queries), data,
                                          distances.np_norms(metric, data)), axis=1)[:, k - 1 : k]
    return float((res.dists.numpy()[:, :k] <= exact + 1e-6).mean())


def test_cancellable_build_against_the_jax_cancellable_build():
    """Both packages build 1500 x 32 cosine by waves with a cancel that
    never fires. The JAX package then takes its chunked construction
    beam, the port its one algorithm: held by validity and recall (the
    port within 0.02 of the JAX package, both >= 0.9), not by records."""
    data, queries = _data(), _data(64, seed=9)
    g = _stage(distances.COSINE, data)
    builder.build_graph(g, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=EF, wave_size=128, bulk=False, cancel=FireAt(0)),
                        device="cpu")
    g.check_validity()
    jg = jax_hnsw.HostGraph.empty(jax_distances.COSINE, D, M, 2 * M, capacity=jax_hnsw.slot_capacity(N))
    for i in range(N):
        jg.alloc_slot(i)
    jg.vectors[:N] = data
    jg.norms[:N] = distances.np_norms(distances.COSINE, data)
    jax_builder.build_graph(jg, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                            jax_builder.BuildOptions(ef_construction=EF, wave_size=128, bulk=False, cancel=lambda: False))
    jg.check_validity()
    tg = _stage(distances.COSINE, data)
    tg.links0, tg.dists0, tg.levels = jg.links0.copy(), np.asarray(jg.dists0, np.float32).copy(), jg.levels.copy()
    tg.upper_links, tg.upper_dists = [a.copy() for a in jg.upper_links], [np.asarray(a, np.float32).copy() for a in jg.upper_dists]
    tg.slot_rows, tg.upper_row_count = [a.copy() for a in jg.slot_rows], list(jg.upper_row_count)
    tg.entry_slots, tg.max_level = list(jg.entry_slots), jg.max_level
    t_rec, j_rec = _exact_recall(g, data, queries), _exact_recall(tg, data, queries)
    print(f"cancellable builds: recall@10 port {t_rec:.4f}, JAX {j_rec:.4f}")
    assert t_rec >= j_rec - 0.02 and min(t_rec, j_rec) >= 0.9


def _records(db):
    return dict(db._db.prefix_iter(db._env.read_txn(), b""))


def test_cancelled_build_then_abort_leaves_both_stores_as_they_were(tmp_path, jax_store, monkeypatch):
    """Both Writers on copies of the JAX-written store: add 60, delete 40,
    then a build whose cancel fires raises ``BuildCancelled`` (the port's
    at its 3rd check, inside the first wave; the JAX package's at its 1st,
    before its first wave, which spares compiling the wave); after
    ``abort_rw_txn`` each store holds what it held before, and the port's
    Reader gives the answers it gave before.
    Then the port repeats the changes and builds without a cancel: the
    records equal those of a copy that was never cancelled."""
    monkeypatch.setattr(jax_hnsw, "_SYNC_BF16", False)
    extra = _data(60, seed=11)
    doomed = [i for i in range(200, 300) if i not in set(jax_store[1])][:40]
    before = {}
    for pkg in (hannoy_tpu, hannoy_tpu_torch):
        path = shutil.copytree(jax_store[0], tmp_path / pkg.__name__)
        db = _open(pkg, path)
        original = _records(db)
        answers = db.reader().by_vecs(QUERIES, n=10, ef_search=64)
        w = db.writer(D, m=M, ef=EF)
        w.add_items(range(N, N + 60), extra)
        for i in doomed:
            assert w.del_item(i)
        cancel = FireAt(3 if pkg is hannoy_tpu_torch else 1)
        with pytest.raises(pkg.errors.BuildCancelled):
            w.builder(seed=42).cancel(cancel).build()
        assert cancel.calls == cancel.n
        assert db.abort_rw_txn()
        assert _records(db) == original
        before[pkg.__name__] = original
        if pkg is hannoy_tpu_torch:
            assert db.reader().by_vecs(QUERIES, n=10, ef_search=64) == answers
            w = db.writer(D, m=M, ef=EF)
            w.add_items(range(N, N + 60), extra)
            for i in doomed:
                w.del_item(i)
            w.builder(seed=42).build()
            db.commit_rw_txn()
            again = _records(db)
        db.close()
    assert before["hannoy_tpu"] == before["hannoy_tpu_torch"]
    db = _open(hannoy_tpu_torch, shutil.copytree(jax_store[0], tmp_path / "never"))
    w = db.writer(D, m=M, ef=EF)
    w.add_items(range(N, N + 60), extra)
    for i in doomed:
        w.del_item(i)
    w.builder(seed=42).build()
    db.commit_rw_txn()
    assert _records(db) == again
    db.close()


# --------------------------------------------------------------------------
# (c) the JAX package's own cases on the port
# --------------------------------------------------------------------------


def test_jax_case_cancellation():
    """``tests/test_builder.py:176``: a cancel at its 3rd check raises."""
    data = np.random.default_rng(42).standard_normal((400, 8)).astype(np.float32)
    g = _stage(distances.EUCLIDEAN, data, m=4, m0=8)
    with pytest.raises(errors.BuildCancelled):
        builder.build_graph(g, np.arange(400, dtype=np.int64), np.empty(0, np.int64),
                            builder.BuildOptions(wave_size=32, cancel=lambda c=iter(range(10**6)): next(c) >= 2),
                            device="cpu")


def test_jax_case_in_wave_cancellation_fires_mid_wave():
    """``tests/test_builder.py:317``: a cancel firing inside one wide
    wave aborts inside that wave's beam, not after it."""
    data = np.random.default_rng(42).standard_normal((3000, 16)).astype(np.float32)
    g = _stage(distances.COSINE, data, m=8, m0=16)
    calls = {"n": 0, "waves": 0}
    real = builder._insert_wave

    def counted(*a, **kw):
        calls["waves"] += 1
        return real(*a, **kw)

    def cancel():
        calls["n"] += 1
        return calls["n"] > 40

    builder._insert_wave, saved = counted, real
    try:
        with pytest.raises(errors.BuildCancelled):
            builder.build_graph(g, np.arange(3000, dtype=np.int64), np.empty(0, np.int64),
                                builder.BuildOptions(ef_construction=48, wave_size=2048, cancel=cancel, bulk=False),
                                device="cpu")
    finally:
        builder._insert_wave = saved
    assert calls["n"] > 40 and calls["waves"] < calls["n"]  # far more checks than waves


def _jax_api_db(tmp_path, n=200, d=8, seed=0):
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    data = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    with db.writer(d, m=8, ef=48) as w:
        w.add_items(range(n), data)
    return db, data


def test_jax_cases_search_cancellation(tmp_path):
    """``tests/test_api.py:266, 363, 389``: a cancel that fires at once."""
    db, data = _jax_api_db(tmp_path)
    reader = db.reader()
    rows = reader.by_vecs(data[:4], n=10, cancel=lambda: True)
    assert rows == [[], [], [], []]
    searched = reader.nns(10).by_vectors_with_cancellation(data[:4], lambda: True)
    assert all(s.did_cancel for s in searched)
    rows = reader.nns(10).by_items_with_cancellation([3, 999999, 7], lambda: True)
    assert rows[1] is None and rows[0].did_cancel and rows[2].did_cancel
    res = reader.nns(10).by_vector_with_cancellation(np.zeros(8, np.float32), lambda: True)
    assert res.did_cancel
    db.close()


def _after_3():
    """``cancel_after_3`` of the JAX package's tests: True from the 4th call on."""
    calls = [0]

    def cancel():
        calls[0] += 1
        return calls[0] > 3

    return cancel


def test_jax_case_mid_search_cancellation_partial_results(tmp_path, rng):
    """``tests/test_api.py:565``: a cancel firing mid-beam returns a
    non-empty partial answer whose first hit is the query's own item;
    uncancelled searches are not flagged."""
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    with db.writer(16, m=8, ef=48) as w:
        w.add_items(range(2000), data)
    reader = db.reader()
    res = reader.nns(10).ef_search(128).by_vector_with_cancellation(np.asarray(data[0]), _after_3())
    assert res.did_cancel and len(res.nns) > 0 and res.nns[0][0] == 0
    full = reader.nns(10).ef_search(128).by_vector(data[0])
    assert not full.did_cancel
    db.close()


def test_jax_case_filtered_search_cancellation_mid_flight(tmp_path, rng):
    """``tests/test_api.py:852``: a filtered search cancels mid-flight,
    keeps only candidates and finds the query's item first; uncancelled
    it finds the same top hit."""
    db = Database(tmp_path / "db", Metric.EUCLIDEAN, device="cpu")
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    with db.writer(16, m=8, ef=48) as w:
        w.add_items(range(2000), data)
    reader = db.reader()
    cands = list(range(0, 2000, 2))
    res = reader.nns(10).ef_search(128).candidates(cands).by_vector_with_cancellation(np.asarray(data[2]), _after_3())
    assert res.did_cancel and len(res.nns) > 0
    assert all(i % 2 == 0 for i, _ in res.nns) and res.nns[0][0] == 2
    full = reader.nns(10).ef_search(128).candidates(cands).by_vector(data[2])
    assert not full.did_cancel and full.nns[0][0] == 2
    db.close()
