"""The port's tracing spans (``hannoy_tpu_torch.utils.tracing``): their
clock, parents and counters, the shared no-op handle, and the span trees
that a search call, a build, a commit and a ``Reader.open`` leave through
``Database`` / ``Writer`` / ``Reader`` on the CPU (600 x 16 cosine)."""

import logging
import os

import numpy as np
import pytest
import torch

from hannoy_tpu_torch import Database, Metric
from hannoy_tpu_torch.utils import tracing

torch.set_num_threads(2)

N, D, M, EF = 600, 16, 8, 32


def _data(n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _by_id(spans):
    return {s.id: s for s in spans}


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.id) if s.parent == parent.id]


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, [s.name for s in spans])
    return found[0]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A committed 600-item cosine database on the CPU, open; its path."""
    path = tmp_path_factory.mktemp("tracing") / "db"
    db = Database(path, Metric.COSINE, device="cpu")
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    yield db, path
    db.close()


def test_a_span_carries_its_clock_and_ms_agrees():
    with tracing.record() as spans:
        with tracing.span("outer"):
            sum(range(1000))
    (s,) = spans
    assert 0 < s.start_ns <= s.end_ns
    assert s.ms == pytest.approx((s.end_ns - s.start_ns) / 1e6)


def test_nested_spans_name_their_parents_and_roots():
    with tracing.record() as spans:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d"):
                pass
        with tracing.span("e"):
            pass
    assert [s.name for s in spans] == ["c", "b", "d", "a", "e"]  # closing order
    by = {s.name: s for s in spans}
    assert len({s.id for s in spans}) == 5
    assert by["a"].parent is None and by["e"].parent is None
    assert by["b"].parent == by["a"].id and by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    # a child lies inside its parent on the clock
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].end_ns <= by["b"].end_ns <= by["a"].end_ns


def test_set_adds_fields_known_at_the_end():
    with tracing.record() as spans:
        with tracing.span("work", queries=3) as sp:
            assert sp.recording
            sp.set(hops=7)
            sp.set(waves=2)
    assert spans[0].fields == {"queries": 3, "hops": 7, "waves": 2}


def test_with_nothing_recording_span_is_the_shared_no_op(caplog):
    caplog.set_level(logging.INFO, logger="hannoy_tpu_torch")
    a, b = tracing.span("x", n=1), tracing.span("y")
    assert a is b and not a.recording
    with a as handle:
        handle.set(hops=1)
    assert handle is a


def test_the_debug_log_line_stays_without_a_recorder(caplog):
    caplog.set_level(logging.DEBUG, logger="hannoy_tpu_torch")
    with tracing.span("load", items=4) as sp:
        assert sp.recording
        sp.set(waves=2)
    assert any(r.getMessage().startswith("load items=4 waves=2 took=") for r in caplog.records)


def test_fence_and_probe_run_at_both_ends():
    fenced, launches = [], [0]

    def probe():
        return launches[0]

    with tracing.record(fence=lambda: fenced.append(1), probe=probe) as spans:
        with tracing.span("launching"):
            launches[0] += 3
    assert len(fenced) == 2 and spans[0].probed == 3


SEARCH_SPANS = {"search_descend", "search_beam", "search_to_host"}


@pytest.mark.parametrize("call", ["by_vectors", "by_vector", "by_items"])
def test_a_search_call_is_one_tree(built, call):
    db, _ = built
    reader = db.reader()
    queries = _data(8, seed=3)
    qb = reader.nns(10).ef_search(32)
    with tracing.record() as spans:
        if call == "by_vectors":
            qb.by_vectors(queries)
        elif call == "by_vector":
            qb.by_vector(queries[0])
        else:
            qb.by_items([1, 5, 9])
    root = _one(spans, "reader_query")
    assert root.parent is None
    assert _children(spans, root) == ["reader_prep", "reader_search", "reader_collect", "reader_top_up"]
    search = _one(spans, "reader_search")
    assert search.fields["hops"] >= 1
    inner = set(_children(spans, search))
    assert inner == (SEARCH_SPANS if call != "by_items" else {"search_to_host"})
    # every span of the call hangs under its root, inside it on the clock
    by = _by_id(spans)
    for s in spans:
        top = s
        while top.parent is not None:
            top = by[top.parent]
        assert top is root and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


def _hamming_reader(path):
    """A committed 600-item hamming database (16 sign bits an item) on the
    CPU → (db, reader)."""
    db = Database(path, Metric.HAMMING, device="cpu")
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    return db, db.reader()


def _beam_route(reader, queries, candidates=None):
    """``on_kernel`` of ``search_beam`` in one ``by_vectors`` call, with a
    filter where ``candidates`` is given (the descent carries no such
    counter)."""
    query = reader.nns(10).ef_search(EF)
    if candidates is not None:
        query = query.candidates(candidates).linear_below(0)  # the graph, not a scan
    with tracing.record() as spans:
        query.by_vectors(queries)
    assert "on_kernel" not in _one(spans, "search_descend").fields
    return _one(spans, "search_beam").fields["on_kernel"]


@pytest.mark.parametrize("metric", ["cosine", "cosine-filtered", "hamming"])
def test_a_search_on_the_cpu_records_the_host_loop(built, tmp_path, metric):
    if metric == "hamming":
        db, reader = _hamming_reader(tmp_path / "db")
    else:
        db, reader = None, built[0].reader()
    candidates = range(0, N, 2) if metric == "cosine-filtered" else None
    assert _beam_route(reader, _data(8, seed=3), candidates) == 0
    if db is not None:
        db.close()


@pytest.mark.cuda
def test_on_the_card_cosine_runs_on_the_kernels_and_hamming_on_the_host_loop(tmp_path):
    """A cosine f32 search records 1 and launches the search kernels; a
    filtered cosine search records 0 (its beam is the host loop); a
    hamming search of 16 bits (2 lanes: the gather kernel's group design,
    which the search kernels' packed form does not take) records 0 and
    launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hannoy_tpu_torch.ops import search_cuda

    found = {}
    for metric in ("cosine", "hamming"):
        db = Database(tmp_path / metric, Metric(metric), device="cuda")
        w = db.writer(D, m=M, ef=EF)
        w.add_items(np.arange(N), _data())
        w.builder(seed=42).build()
        db.commit_rw_txn()
        reader = db.reader()
        before = sum(search_cuda.KERNELS.launches.values())
        found[metric] = _beam_route(reader, _data(8, seed=3)), sum(search_cuda.KERNELS.launches.values()) - before
        if metric == "cosine":
            before = sum(search_cuda.KERNELS.launches.values())
            routes = _beam_route(reader, _data(8, seed=3), range(0, N, 2))
            found["filtered"] = routes, sum(search_cuda.KERNELS.launches.values()) - before
        db.close()
    assert found["cosine"][0] == 1 and found["cosine"][1] >= 2
    assert found["filtered"][0] == 0
    assert found["hamming"] == (0, 0)


def test_a_build_nests_its_plan_and_upload_and_counts_its_waves(built):
    _, path = built
    # a reopened database loads its graph from the store in the prologue
    db = Database(path.parent / "again", Metric.COSINE, device="cpu")
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    db = Database(path.parent / "again", Metric.COSINE, device="cpu")
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N, N + 50), _data(50, seed=1))
    with tracing.record() as spans:
        w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    graph = _one(spans, "build_graph")
    assert graph.parent is None and graph.fields["waves"] >= 1
    assert {"build_plan", "build_upload"} <= set(_children(spans, graph))
    prologue = _one(spans, "build_prologue")
    assert prologue.fields == {"graph_reused": 0}
    load = _one(spans, "load_graph")
    assert load.parent == prologue.id
    assert _children(spans, prologue)[:1] == ["load_graph"]
    assert {"load_to_device", "fill_link_dists", "load_from_device"} <= set(_children(spans, prologue))
    assert _one(spans, "build_epilogue").parent is None


def test_a_warm_append_forks_the_committed_graph_in_its_prologue(tmp_path):
    db = Database(tmp_path / "db", Metric.COSINE, device="cpu")
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    w.add_items(np.arange(N, N + 50), _data(50, seed=1))
    with tracing.record() as spans:
        w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    prologue = _one(spans, "build_prologue")
    assert prologue.parent is None and prologue.fields == {"graph_reused": 1}
    fork = _one(spans, "fork_graph")
    assert fork.parent == prologue.id and fork.fields == {"items": N}
    assert _children(spans, prologue) == ["fork_graph"]  # no load, no distances to fill
    assert prologue.start_ns <= fork.start_ns <= fork.end_ns <= prologue.end_ns


@pytest.mark.parametrize("backend", ["native", "python"])
def test_a_commit_reports_its_steps(tmp_path, backend):
    db = Database(tmp_path / "db", Metric.COSINE, device="cpu", backend=backend)
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(100), _data(100))
    w.builder(seed=42).build()
    log = tmp_path / "db" / "hannoy.log"
    before = os.path.getsize(log) if log.exists() else 0
    with tracing.record() as spans:
        assert db.commit_rw_txn()
    s = _one(spans, "store_commit")
    assert set(s.fields) == {"batch_bytes", "serialize_ns", "log_ns", "publish_ns"}
    assert s.fields["batch_bytes"] == os.path.getsize(log) - before > 0
    assert all(s.fields[k] >= 0 for k in ("serialize_ns", "log_ns", "publish_ns"))
    assert sum(s.fields[k] for k in ("serialize_ns", "log_ns", "publish_ns")) <= s.end_ns - s.start_ns
    db.close()


def test_reader_open_is_the_root_of_its_load_and_upload(built):
    _, path = built
    db = Database(path.parent / "open", Metric.COSINE, device="cpu")
    w = db.writer(D, m=M, ef=EF)
    w.add_items(np.arange(N), _data())
    w.builder(seed=42).build()
    db.commit_rw_txn()
    db.close()
    db = Database(path.parent / "open", Metric.COSINE, device="cpu")
    with tracing.record() as spans:
        db.reader()
    db.close()
    root = _one(spans, "reader_open")
    assert root.parent is None
    assert _children(spans, root) == ["reader_load_graph", "reader_to_device"]
