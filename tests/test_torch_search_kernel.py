"""The search kernels' algorithm on the CPU: ``search_cuda``'s per-row
plain versions against the host loop of ``ops/beam.py`` and against the
JAX package's ``beam_search``, ``greedy_descend`` and ``hnsw_search``.

The kernels themselves (``csrc/search.cu``) run only on a card
(``tests/test_torch_cuda.py``); their plain versions run each query's
loop on its own, as every block of the kernels does, and stand for them
here. Against the host loop, which runs the batch's loop, they must agree
exactly: slots, distance bits, iteration count and active rows. Against
the JAX package, which sums in another order, the tolerance of
``tests/test_torch_build.py::test_hnsw_search_matches_jax``: at least 99%
identical slots and, where the slots match, cosine distances within atol
1e-5 (squared L2 and L1, sums of a few hundred here, within rtol 1e-5, as
``tests/test_torch_cuda.py`` holds the gather kernel to its twin).

One JAX wave build of 1500 x 32 (the shapes ``test_torch_build.py``'s
``ref`` compiles), shared by the module; euclidean and manhattan search
the same links with their own distances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import beam as jax_beam
from hannoy_tpu.ops import distances as jax_distances
from hannoy_tpu_torch import Database, Metric
from hannoy_tpu_torch.build import builder
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, beam_cuda, codecs, distances, search_cuda
from test_torch_build import N, N_QUERIES, _data, _device_state, _opts, _stage

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

METRICS = ("cosine", "euclidean", "manhattan")


@pytest.fixture(scope="module")
def built():
    """The JAX-built graph, its queries, and per metric the same graph as
    both packages' device graphs."""
    data, queries = _data()
    jg = _stage(jax_hnsw, data)
    jax_builder.build_graph(jg, np.arange(N, dtype=np.int64), np.empty(0, np.int64), _opts(jax_builder))
    assert jg.max_level >= 2
    base = jax_hnsw.to_device(jg, cache=False)
    graphs = {}
    for name in METRICS:
        norms = jax_distances.np_norms(jax_distances.by_name(name), np.asarray(base.vectors))
        jdev = dataclasses.replace(base, metric_name=name, norms=jnp.asarray(norms))
        graphs[name] = (jdev, hnsw.device_graph_from_arrays("cpu", **_device_state(jdev)))
    return data, queries, graphs


def _queries(name, queries):
    qn = jax_distances.np_norms(jax_distances.by_name(name), queries)
    return (jnp.asarray(queries), jnp.asarray(qn)), (torch.from_numpy(queries), torch.from_numpy(qn))


def _seeds(seed, n_pad, b=N_QUERIES, s=6):
    """Seed slots with -1, repeats and slots past the items among them."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, N, (b, s)).astype(np.int32)
    start[:, 1] = start[:, 0]
    start[rng.random((b, s)) < 0.15] = -1
    start[:, -1] = rng.integers(N, n_pad, b)  # free slots: not valid
    return start


def _same(got, want):
    """Exact agreement of two beam results."""
    assert torch.equal(got.slots, want.slots)
    assert torch.equal(got.dists.view(torch.int32), want.dists.view(torch.int32))
    assert int(got.iters) == int(want.iters)
    assert torch.equal(got.active, want.active)


def _near(label, got_slots, got_d, want_slots, want_d):
    """The JAX package's tolerance (test_hnsw_search_matches_jax): 99%
    identical slots; cosine distances within atol 1e-5 and, as the gather
    kernel is held to its twin, squared L2 and L1 (sums of a few hundred
    here) within rtol 1e-5, the summation order's."""
    ws, gs = np.asarray(want_slots), np.asarray(got_slots)
    share = float((ws == gs).mean())
    print(f"{label}: identical slots {share:.4f}")
    assert share >= 0.99
    same = (ws == gs) & (ws >= 0)
    tol = dict(rtol=0, atol=1e-5) if label.split()[1] == "cosine" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_d)[same], np.asarray(want_d)[same], **tol)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("ef", [1, 10, 48])
@pytest.mark.parametrize("name", METRICS)
def test_beam_rowwise_equals_host_loop_and_jax(built, name, ef, level):
    _, queries, graphs = built
    jdev, tg = graphs[name]
    (jq, jqn), (tq, tqn) = _queries(name, queries)
    start = _seeds(3 + ef + level, tg.capacity)
    got, n_dist = search_cuda.beam_search_rowwise(tg, tq, tqn, torch.from_numpy(start), ef, level=level)
    want = beam.beam_search_loop(tg, tq, tqn, torch.from_numpy(start), ef, level=level)
    _same(got, want)
    assert int((n_dist > 0).sum()) == N_QUERIES
    jres = jax_beam.beam_search(jdev, jq, jqn, jnp.asarray(start), ef, level=level)
    _near(f"beam {name} ef={ef} level={level}", got.slots, got.dists, jres.slots, jres.dists)
    # the plain twin's distances on the CPU are the ones the host loop used
    _same(search_cuda.beam_search_rowwise(tg, tq, tqn, torch.from_numpy(start), ef, level=level, plain=True)[0], want)


@pytest.mark.parametrize("name", METRICS)
def test_greedy_rowwise_equals_host_loop_and_jax(built, name):
    _, queries, graphs = built
    jdev, tg = graphs[name]
    (jq, jqn), (tq, tqn) = _queries(name, queries)
    for top, bottom in ((tg.max_level, 1), (tg.max_level, 2), (1, 1)):
        got = search_cuda.greedy_descend_rowwise(tg, tq, tqn, top, bottom)
        assert torch.equal(got, beam.greedy_descend_loop(tg, tq, tqn, top, bottom))
        want = np.asarray(jax_beam.greedy_descend(jdev, jq, jqn, top, bottom))
        share = float((got.numpy() == want).mean())
        print(f"greedy {name} {top}..{bottom}: identical slots {share:.4f}")
        assert share >= 0.99


@pytest.mark.parametrize("ef_upper", [1, 8])
@pytest.mark.parametrize("ef", [1, 10, 48])
@pytest.mark.parametrize("name", METRICS)
def test_hnsw_rowwise_equals_host_loop_and_jax(built, name, ef, ef_upper):
    _, queries, graphs = built
    jdev, tg = graphs[name]
    (jq, jqn), (tq, tqn) = _queries(name, queries)
    got = search_cuda.hnsw_search_rowwise(tg, tq, tqn, ef, ef_upper=min(ef_upper, ef))
    _same(got, beam.hnsw_search(tg, tq, tqn, ef, ef_upper=min(ef_upper, ef)))
    jres = jax_beam.hnsw_search(jdev, jq, jqn, ef, ef_upper=min(ef_upper, ef))
    _near(f"hnsw {name} ef={ef} ef_upper={ef_upper}", got.slots, got.dists, jres.slots, jres.dists)
    if bool((got.slots.numpy() == np.asarray(jres.slots)).all()):
        assert int(got.iters) == int(jres.iters)


@pytest.mark.parametrize("name", METRICS)
def test_max_iters_truncates_rows(built, name):
    """A budget of 4 hops cuts rows short: they stay active, and each row
    holds its pool after 4 hops."""
    _, queries, graphs = built
    jdev, tg = graphs[name]
    (jq, jqn), (tq, tqn) = _queries(name, queries)
    start = _seeds(5, tg.capacity)
    got, _ = search_cuda.beam_search_rowwise(tg, tq, tqn, torch.from_numpy(start), 48, max_iters=4)
    _same(got, beam.beam_search_loop(tg, tq, tqn, torch.from_numpy(start), 48, max_iters=4))
    assert int(got.iters) == 4 and int(got.active.sum()) > N_QUERIES // 2
    jres = jax_beam.beam_search(jdev, jq, jqn, jnp.asarray(start), 48, max_iters=4)
    _near(f"truncated {name} beam", got.slots, got.dists, jres.slots, jres.dists)
    assert np.array_equal(got.active.numpy(), np.asarray(jres.active))


def test_node_ok_drops_deleted_slots(built):
    """A node_ok without a tenth of the items (deleted slots): no walk
    settles on one and no pool holds one."""
    _, queries, graphs = built
    jdev, tg = graphs["cosine"]
    (jq, jqn), (tq, tqn) = _queries("cosine", queries)
    ok = tg.valid.clone()
    dropped = np.random.default_rng(9).choice(N, N // 10, replace=False)
    ok[dropped] = False
    jok = jnp.asarray(ok.numpy())
    cur = search_cuda.greedy_descend_rowwise(tg, tq, tqn, tg.max_level, 1, node_ok=ok)
    assert torch.equal(cur, beam.greedy_descend_loop(tg, tq, tqn, tg.max_level, 1, node_ok=ok))
    assert bool(ok[cur.long()].all())
    assert float((cur.numpy() == np.asarray(jax_beam.greedy_descend(jdev, jq, jqn, tg.max_level, 1, node_ok=jok))).mean()) >= 0.99
    start = cur[:, None]
    got, _ = search_cuda.beam_search_rowwise(tg, tq, tqn, start, 48, node_ok=ok)
    _same(got, beam.beam_search_loop(tg, tq, tqn, start, 48, node_ok=ok))
    assert not np.isin(got.slots.numpy(), dropped).any()
    jres = jax_beam.beam_search(jdev, jq, jqn, jnp.asarray(start.numpy()), 48, node_ok=jok)
    _near("beam cosine with deleted slots", got.slots, got.dists, jres.slots, jres.dists)


def _with_nan_rows(g, rows):
    """``g`` with NaN in the store rows ``rows``."""
    vectors = g.vectors.clone()
    vectors[torch.as_tensor(rows).long()] = float("nan")
    return dataclasses.replace(g, vectors=vectors)


@pytest.mark.parametrize("name", METRICS)
def test_nan_rows_as_the_host_loop(built, name):
    """Rows that hold NaN: the plain versions' greedy descent takes a NaN
    distance where the host loop's ``torch.argmin`` does (before every
    number, the first one winning) and keeps a NaN ``cur_d`` as
    ``torch.minimum`` does; their merges rank NaN last, as ``torch.sort``
    does, so a NaN row never enters a pool (its ef entries start at
    +inf). They equal the host loop exactly — with NaN on the walks (every
    37th row and each entry point's first link at the highest level it has
    one) and at an entry point."""
    _, queries, graphs = built
    _, tg = graphs[name]
    _, (tq, tqn) = _queries(name, queries)
    top = tg.max_level
    entries = [int(e) for e in tg.entry_slots if e >= 0]
    rows = [tg.upper_links[lv - 1][int(tg.slot_rows[lv - 1][e])] for e in entries for lv in range(top, 0, -1)]
    firsts = {int(r[r >= 0][0]) for r in rows if bool((r >= 0).any())}
    g = _with_nan_rows(tg, list(range(0, N, 37)) + sorted(firsts))
    for bottom in (1, 2):
        got = search_cuda.greedy_descend_rowwise(g, tq, tqn, top, bottom)
        assert torch.equal(got, beam.greedy_descend_loop(g, tq, tqn, top, bottom))
        assert not torch.equal(got, beam.greedy_descend_loop(tg, tq, tqn, top, bottom))
    nan_rows = torch.isnan(g.vectors).any(1).nonzero()[:, 0]
    for ef, ef_upper in ((10, 1), (48, 8)):
        got = search_cuda.hnsw_search_rowwise(g, tq, tqn, ef, ef_upper=ef_upper)
        _same(got, beam.hnsw_search(g, tq, tqn, ef, ef_upper=ef_upper))
        assert not bool(torch.isin(got.slots, nan_rows).any()) and not bool(torch.isnan(got.dists).any())
    # a NaN entry point: argmin takes it, and no step improves on NaN
    g = _with_nan_rows(tg, entries[-1:])
    got = search_cuda.greedy_descend_rowwise(g, tq, tqn, top, 1)
    assert torch.equal(got, beam.greedy_descend_loop(g, tq, tqn, top, 1))
    assert bool((got == entries[-1]).all())
    _same(search_cuda.hnsw_search_rowwise(g, tq, tqn, 10), beam.hnsw_search(g, tq, tqn, 10))


def test_flat_graph(built):
    """A graph of max_level 0: the layer-0 beam from the entry points."""
    _, queries, graphs = built
    jdev, tg = graphs["cosine"]
    (jq, jqn), (tq, tqn) = _queries("cosine", queries)
    flat_j = dataclasses.replace(jdev, upper_links=jdev.upper_links[:0], upper_dists=jdev.upper_dists[:0],
                                 slot_rows=jdev.slot_rows[:0], max_level=0)
    flat_t = hnsw.device_graph_from_arrays("cpu", **_device_state(flat_j))
    assert flat_t.max_level == 0 and flat_t.upper_links.shape[0] == 0
    got = search_cuda.hnsw_search_rowwise(flat_t, tq, tqn, 48)
    _same(got, beam.hnsw_search(flat_t, tq, tqn, 48))
    jres = jax_beam.hnsw_search(flat_j, jq, jqn, 48)
    _near("flat cosine graph", got.slots, got.dists, jres.slots, jres.dists)


@pytest.mark.parametrize("fire_at", [1, 2])
def test_cancel_falls_on_the_host_loops_hop(built, fire_at):
    """A cancel that fires at the k-th check of the layer-0 beam leaves
    each row's pool after 8 (k - 1) hops: the plain version with that
    budget, which is what the kernel's launches of SYNC_EVERY hops give."""
    _, queries, graphs = built
    _, tg = graphs["cosine"]
    _, (tq, tqn) = _queries("cosine", queries)
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) >= fire_at

    got = beam.hnsw_search(tg, tq, tqn, 48, cancel=cancel)
    assert len(calls) == fire_at
    budget = beam.SYNC_EVERY * (fire_at - 1)
    _same(search_cuda.hnsw_search_rowwise(tg, tq, tqn, 48, max_iters=budget), got)
    assert int(got.iters) == budget and bool(got.active.any())


def test_query_builder_ef_upper(built, tmp_path):
    """ef_upper 32, set through ``QueryBuilder.ef_upper``: a Reader's
    answers are those of the plain versions on its own graph."""
    data, queries, _ = built
    db = Database(tmp_path / "db", Metric.COSINE, device="cpu")
    writer = db.writer(dimensions=data.shape[1], m=8, ef=32)
    writer.add_items(range(N), data)
    writer.builder(seed=42).build()
    db.commit_rw_txn()
    reader = db.reader()
    got = reader.nns(10).ef_search(48).ef_upper(32).by_vectors(queries)
    q, qn = reader._prep_queries(queries)
    want = search_cuda.hnsw_search_rowwise(reader._dev, q, qn, 48, 2 * 48 + 16, ef_upper=32)
    ids = reader._graph.ids[want.slots[:, :10].numpy()]
    for b, row in enumerate(got):
        assert [i for i, _ in row.nns] == ids[b].tolist()
        assert [d for _, d in row.nns] == want.dists[b, :10].tolist()
    db.close()


@pytest.mark.parametrize("case, want", [
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True), "kernel"),
    (dict(device_type="cuda", row_dtype=torch.bfloat16, metric="euclidean", dim=768, aligned=True), "kernel"),
    (dict(device_type="cuda", row_dtype=torch.int8, metric="manhattan", dim=768, aligned=True), "kernel"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True, ef=512, width=40), "kernel"),
    (dict(device_type="cpu", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True), "host"),
    (dict(device_type="cuda", row_dtype=torch.int32, metric="hamming", dim=24, aligned=True), "kernel"),
    (dict(device_type="cuda", row_dtype=torch.int32, metric="binary quantized cosine", dim=48, aligned=True, ef=100,
          width=32), "kernel"),
    (dict(device_type="cuda", row_dtype=torch.int32, metric="hamming", dim=5, aligned=True), "host"),
    (dict(device_type="cuda", row_dtype=torch.int32, metric="hamming", dim=48, aligned=False), "host"),
    (dict(device_type="cpu", row_dtype=torch.int32, metric="hamming", dim=48, aligned=True), "host"),
    (dict(device_type="cuda", row_dtype=torch.int32, metric="hamming", dim=48, aligned=True, expand=2), "host"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=37, aligned=True), "host"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=False), "host"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True, expand=2), "host"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True, traverse_k=24), "host"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True, tail_allow=3), "host"),
    (dict(device_type="cuda", row_dtype=torch.float32, metric="cosine", dim=768, aligned=True, ef=20000), "host"),
])
def test_search_design_rule(case, want):
    """Which loops take the kernels: CUDA tensors of the staged design's
    dense rows or of the pair design's packed rows (lanes in whole 16-byte
    units from an aligned base; 5 lanes is the group design), one entry a
    hop, whole rows, no tail, a pool that fits; CPU tensors never."""
    case = dict(case, metric=distances.by_name(case["metric"]))
    assert search_cuda.search_design_of(**case) == want


def _packed_shared_rule():
    """The packed block (48 lanes, 1,536 bits): no query and no staging
    rows in shared memory, so at ef 100 and 32 links it fits
    ``BLOCK_BUDGET`` with room to spare; the routing rule takes the same
    limits as for dense rows."""
    lanes, metric = 48, distances.by_name("hamming")
    design = lambda ef, width=32: search_cuda.search_design_of(  # noqa: E731
        "cuda", torch.int32, metric, lanes, True, ef=ef, width=width)
    cap, rows, nbytes = search_cuda.beam_shared(lanes, 4 * lanes, 100, 32, packed=True)
    assert (cap, rows) == (32, 0) and nbytes <= search_cuda.BLOCK_BUDGET // 4
    assert nbytes == search_cuda.CLOCK_BYTES + 24 * 100 + 8 * 32 + 8 * search_cuda.WARPS  # clocks, pools, hop, finds
    assert design(100) == "kernel"
    fits = [ef for ef in range(1, 20000, 4)
            if search_cuda.beam_shared(lanes, 4 * lanes, ef, 32, packed=True)[2] <= beam_cuda.STAGED_SMEM]
    past = max(fits) + 4
    assert design(max(fits)) == "kernel" and design(past) == "host"
    assert design(100, search_cuda.MAX_CAP) == "kernel" and design(100, search_cuda.MAX_CAP + 1) == "host"
    rows, nbytes = search_cuda.greedy_shared(lanes, 4 * lanes, 16, packed=True)
    assert rows == 0 and nbytes == search_cuda.CLOCK_BYTES + 8 * search_cuda.MAX_CAP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.int32], ids=str)
def test_beam_shared_rule_on_both_sides_of_the_limit(dtype):
    """The staging buffer's one rule (``beam_shared``) and the routing
    rule: at the main path's shapes a block fits ``BLOCK_BUDGET`` (four
    blocks an SM), with two slots a warp for 768 f32 rows and a slot for
    each link of a hop for bf16 and int8 rows; a wide pool or a wide row
    leaves fewer slots than candidates (rounds), never fewer than one a
    warp; the largest ef whose block fits ``STAGED_SMEM`` takes the kernel
    and the next one that does not the host loop, as does a link row past
    ``MAX_CAP``. int32: the packed block (``_packed_shared_rule``)."""
    if dtype == torch.int32:
        return _packed_shared_rule()
    dim, w = 768, search_cuda.WARPS
    rb = dim * dtype.itemsize
    design = lambda ef, width=32: search_cuda.search_design_of(  # noqa: E731
        "cuda", dtype, distances.COSINE, dim, True, ef=ef, width=width)
    cap, rows, nbytes = search_cuda.beam_shared(dim, rb, 100, 32)
    assert (cap, rows) == (32, 16 if dtype == torch.float32 else 32) and nbytes <= search_cuda.BLOCK_BUDGET
    assert 4 * (nbytes + 1024) <= 228 * 1024
    for ef, width in ((640, 32), (100, 40), (100, 64), (3000, 16)):
        cap, rows, nbytes = search_cuda.beam_shared(dim, rb, ef, width)
        assert cap == (width + 31) // 32 * 32 and rows % w == 0 and w <= rows <= -(-width // w) * w
        assert rows == w or nbytes <= search_cuda.BLOCK_BUDGET
    if dtype == torch.float32:
        assert search_cuda.beam_shared(dim, rb, 640, 32)[1] < 32 and search_cuda.beam_shared(dim, rb, 100, 40)[1] < 40
    fits = [ef for ef in range(1, 20000, 4) if search_cuda.beam_shared(dim, rb, ef, 32)[2] <= beam_cuda.STAGED_SMEM]
    largest = max(fits)
    assert design(largest) == "kernel" and search_cuda.beam_shared(dim, rb, largest, 32)[1] == w
    past = next(ef for ef in range(largest, 40000) if search_cuda.beam_shared(dim, rb, ef, 32)[2] > beam_cuda.STAGED_SMEM)
    assert design(past) == "host" and design(past - 4) == "kernel"
    assert design(100, search_cuda.MAX_CAP) == "kernel" and design(100, search_cuda.MAX_CAP + 1) == "host"
    rows, nbytes = search_cuda.greedy_shared(dim, rb, 16)
    assert rows == 16 and nbytes <= search_cuda.BLOCK_BUDGET


def test_cpu_tensors_take_the_host_loop(built, monkeypatch):
    """On CPU tensors ``beam_search`` and ``greedy_descend`` never reach
    the kernels' wrappers."""
    _, queries, graphs = built
    _, tg = graphs["cosine"]
    _, (tq, tqn) = _queries("cosine", queries[:4])

    def refuse(*a, **k):
        raise AssertionError("a CPU search reached a kernel wrapper")

    monkeypatch.setattr(search_cuda, "beam_search_kernel", refuse)
    monkeypatch.setattr(search_cuda, "greedy_descend_kernel", refuse)
    res = beam.hnsw_search(tg, tq, tqn, 10, ef_upper=4)
    assert res.slots.shape == (4, 10)


@pytest.mark.parametrize("name", METRICS)
def test_unfiltered_by_items_beam_is_the_filtered_beam_of_every_item(built, name):
    """An unfiltered ``by_items`` runs the unfiltered beam (on the card, the
    search kernel) where the JAX package runs the filtered beam with every
    live item a candidate: the two give the same pools, seeded at items'
    own slots, and so does the plain version."""
    _, _, graphs = built
    _, tg = graphs[name]
    slots = torch.arange(0, N, 23, dtype=torch.int32)
    q, qn = tg.vectors[slots.long()], tg.norms[slots.long()]
    start = slots[:, None]
    got = beam.beam_search_loop(tg, q, qn, start, 48)
    _same(got, beam.beam_search_filtered(tg, q, qn, start, 48, tg.valid.clone()))
    _same(search_cuda.beam_search_rowwise(tg, q, qn, start, 48)[0], got)


PACKED_N, PACKED_BITS = 1500, 2048  # 64 lanes


@pytest.fixture(scope="module")
def packed():
    """A packed graph of 1500 x 2,048 bits (64 lanes) made by the port alone
    on the CPU: the links of a cosine wave build of 1500 x 32 points in 12
    clusters (m 8, m0 16), the rows the signs of the points' random
    projections to 2,048 dimensions (hamming then follows their angles),
    and 24 queries made the same way. Distances are multiples of 1/2,048,
    so pools hold ties."""
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((12, 32)).astype(np.float32) * 3
    points = (centers[rng.integers(0, 12, PACKED_N + 24)] + rng.standard_normal((PACKED_N + 24, 32))).astype(np.float32)
    data, queries = points[:PACKED_N], points[PACKED_N:]
    g = hnsw.HostGraph.empty(distances.COSINE, 32, 8, 16, capacity=hnsw.slot_capacity(PACKED_N))
    for i in range(PACKED_N):
        g.alloc_slot(i)
    g.vectors[:PACKED_N] = data
    g.norms[:PACKED_N] = distances.np_norms(distances.COSINE, data)
    builder.build_graph(g, np.arange(PACKED_N), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=16, wave_size=512, bulk=False), device="cpu")
    project = rng.standard_normal((32, PACKED_BITS)).astype(np.float32)
    rows = np.zeros((g.capacity, PACKED_BITS // 32), dtype=np.uint32)
    rows[:PACKED_N] = codecs.pack(data @ project, distances.HAMMING.codec)
    dev = hnsw.to_device(g, "cpu")
    return dataclasses.replace(dev, vectors=torch.from_numpy(distances.as_lanes(rows))), rows, codecs.pack(
        queries @ project, distances.HAMMING.codec)


@pytest.mark.parametrize("name, ef, ef_upper", [("hamming", 16, 1), ("binary quantized cosine", 24, 8)])
def test_packed_rowwise_equals_host_loop(packed, name, ef, ef_upper):
    """Packed rows: the plain versions (the kernels' per-row algorithm)
    equal the host loop slot for slot and bit for bit, through the greedy
    descent to layer 1 (hamming) or to layer 2 and an 8-wide layer-1 beam
    (BQ cosine), then the layer-0 beam, where the 10th place ties."""
    dev, rows, q_lanes = packed
    metric = distances.by_name(name)
    dev = dataclasses.replace(dev, metric_name=name, norms=torch.from_numpy(distances.np_norms(metric, rows)))
    q = torch.from_numpy(distances.as_lanes(q_lanes))
    qn = torch.from_numpy(distances.np_norms(metric, q_lanes))
    assert dev.max_level >= 2 and dev.vectors.dtype == torch.int32 and dev.vectors.shape[1] == 64
    got = search_cuda.hnsw_search_rowwise(dev, q, qn, ef, ef_upper=ef_upper)
    _same(got, beam.hnsw_search(dev, q, qn, ef, ef_upper=ef_upper))
    assert bool((got.slots[:, 0] >= 0).all())
    assert bool((got.dists[:, 9] == got.dists[:, 10]).any()), "no tie at the 10th place"
