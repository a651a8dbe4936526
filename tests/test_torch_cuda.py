"""The hand-written CUDA gather-distance kernel, the port's build and its
Database / Writer / Reader path on a CUDA device. Marked ``cuda``: without a card every test skips. On a
machine with one (and without JAX, so without ``tests/conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernel sums each row in another order than the twin, so
cosine agrees to atol 1e-5 and sqL2/L1 to rtol 1e-5; the bulk build's
block distances agree to atol 1e-5 on unit-scale rows. The API path on the
card against the same path on the CPU: 95% of the links records, recall
within 0.02, and the same answers after a reopen.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hannoy_tpu_torch import Database, Metric
from hannoy_tpu_torch.build import builder
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, beam_cuda, distances, search_cuda

pytestmark = pytest.mark.cuda


def _launches() -> int:
    """Launches of the port's kernels so far: the gather kernel's and the
    search kernels' (a build's beams on the card run in the latter)."""
    return beam_cuda.KERNEL.launches + sum(search_cuda.KERNELS.launches.values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, n, d, b, k, name):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    nrm = distances.np_norms(distances.by_name(name), x)
    q = rng.standard_normal((b, d)).astype(np.float32)
    qn = distances.np_norms(distances.by_name(name), q)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    idx[rng.random((b, k)) < 0.05] = -1
    return [torch.from_numpy(a) for a in (x, nrm, q, qn, idx)]


@pytest.mark.parametrize("dim", [768, 130, 37])
@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan"])
def test_kernel_matches_twin(cuda, name, dim):
    metric = distances.by_name(name)
    x, nrm, q, qn, idx = (t.to(cuda) for t in _inputs(11, 3000, dim, 67, 29, name))
    before, before_shape = beam_cuda.KERNEL.launches, beam_cuda.KERNEL.by_shape.get((67, 29), 0)
    got = beam_cuda.gathered_distances(metric, x, nrm, q, qn, idx)
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.launches == before + 1
    assert beam_cuda.KERNEL.by_shape[(67, 29)] == before_shape + 1
    want = beam_cuda.gathered_distances_plain(metric, x, nrm, q, qn, idx)
    tol = dict(rtol=0, atol=1e-5) if name == "cosine" else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)


def test_kernel_marks_out_of_range_rows_nan(cuda):
    x, nrm, q, qn, idx = (t.to(cuda) for t in _inputs(12, 100, 64, 4, 8, "cosine"))
    idx[1, 3] = 100
    got = beam_cuda.gathered_distances(distances.COSINE, x, nrm, q, qn, idx)
    assert torch.isnan(got[1, 3]) and int(torch.isnan(got).sum()) == 1


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    x, nrm, q, qn, idx = (t.to(cuda) for t in _inputs(13, 100, 64, 4, 8, "cosine"))
    with pytest.raises(ValueError):
        beam_cuda.gathered_distances(distances.COSINE, x, nrm, q, qn, idx.t())
    with pytest.raises(TypeError):
        beam_cuda.gathered_distances(distances.COSINE, x, nrm, q, qn, idx.long())
    with pytest.raises(TypeError):  # a packed metric takes int32 lanes, not f32 rows
        beam_cuda.gathered_distances(distances.HAMMING, x, nrm, q, qn, idx)
    with pytest.raises(TypeError):  # and an f32 metric no lanes
        beam_cuda.gathered_distances(distances.COSINE, x.to(torch.int32), nrm, q, qn, idx)
    with pytest.raises(TypeError):  # an int8 query only on int8 rows
        beam_cuda.gathered_distances(distances.COSINE, x, nrm, q.to(torch.int8), qn, idx)


@pytest.mark.parametrize("dim", [768, 130, 37])
@pytest.mark.parametrize("query", ["search", "build"])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan"])
def test_tier_kernel_forms_match_twin(cuda, name, tier, query, dim):
    """bf16 and int8 rows, with an f32 query (a search) and with a query
    gathered from the store (a build; int8: dequantised by its scale).
    Same rounded inputs on both sides: summation order only."""
    metric = distances.by_name(name)
    x, nrm, q, qn, idx = _inputs(21, 3000, dim, 67, 29, name)
    g = hnsw.HostGraph.empty(metric, dim, 8, 16, capacity=3000)
    g.vectors[:], g.norms[:] = x.numpy(), nrm.numpy()
    dev = hnsw.to_device(g, cuda, tier=tier)
    if query == "build":
        q, qn = dev.vectors[:67].contiguous(), dev.norms[:67].contiguous()
    form = beam_cuda.form_of(metric, dev.vectors.dtype)
    before = beam_cuda.KERNEL.by_form.get(form, 0)
    got = beam_cuda.gathered_distances(metric, dev.vectors, dev.norms, q.to(cuda), qn.to(cuda), idx.to(cuda))
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.by_form[form] == before + 1 and form[0] == tier
    want = beam_cuda.gathered_distances_plain(metric, dev.vectors, dev.norms, q.to(cuda), qn.to(cuda), idx.to(cuda))
    tol = dict(rtol=0, atol=1e-5) if name == "cosine" else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)


def _tier_store(cuda, name, tier, n=3000, dim=768, seed=31):
    """A random [n, dim] store in ``tier`` through the port's upload, with
    its headers, and a numpy generator for the rest of the case."""
    rng = np.random.default_rng(seed)
    metric = distances.by_name(name)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    g = hnsw.HostGraph.empty(metric, dim, 8, 16, capacity=n)
    g.vectors[:], g.norms[:] = x, distances.np_norms(metric, x)
    dev = hnsw.to_device(g, cuda, tier=tier)
    return metric, dev.vectors, dev.norms, rng


def _check_against_twin(metric, rows, norms, q, qn, idx, design):
    """One launch: it goes through ``design``, and agrees with the twin
    (NaN where the twin has NaN) at the tiers' tolerance."""
    row = beam_cuda.form_of(metric, rows.dtype)[0]
    before = beam_cuda.KERNEL.by_design.get((row, design), 0)
    got = beam_cuda.gathered_distances(metric, rows, norms, q, qn, idx)
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.by_design[(row, design)] == before + 1
    want = beam_cuda.gathered_distances_plain(metric, rows, norms, q, qn, idx)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    tol = dict(rtol=0, atol=1e-5) if metric.name == "cosine" else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, equal_nan=True, **tol)
    return got


@pytest.mark.parametrize("dim", [768, 130])
@pytest.mark.parametrize("tier", ["raw", "bf16", "int8"])
def test_kernel_keeps_nan_rows_under_cosine(cuda, tier, dim):
    """Rows that hold NaN with a finite norm, and rows with a NaN norm,
    under cosine: the kernel (staged design at 768, warp design at 130)
    equals its twin, NaN where the twin has NaN (the epilogue's clamp keeps
    a NaN, as torch.clamp and jnp.clip do; a NaN norm gives 0)."""
    metric = distances.COSINE
    rng = np.random.default_rng(41)
    x = rng.standard_normal((3000, dim)).astype(np.float32)
    g = hnsw.HostGraph.empty(metric, dim, 8, 16, capacity=3000)
    g.vectors[:], g.norms[:] = x, distances.np_norms(metric, x)
    dev = hnsw.to_device(g, cuda, tier=tier)
    rows, norms = dev.vectors.clone(), dev.norms.clone()
    nan_rows = torch.arange(0, 3000, 7, device=cuda)
    if tier != "int8":  # int8 rows cannot hold a NaN: the header alone does
        rows[nan_rows, 3] = float("nan")
    norms[torch.arange(5, 3000, 14, device=cuda)] = float("nan")  # never a NaN row's
    q = torch.from_numpy(rng.standard_normal((37, dim)).astype(np.float32)).to(cuda)
    qn = torch.from_numpy(distances.np_norms(metric, q.cpu().numpy())).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 3000, (37, 33)).astype(np.int32)).to(cuda)
    idx[:, 0] = nan_rows[:37].int()
    got = _check_against_twin(metric, rows, norms, q, qn, idx, "staged" if dim == 768 else "warp")
    assert bool(torch.isnan(got[:, 0]).all()) == (tier != "int8")


@pytest.mark.parametrize("k", [1, 8, 31, 32, 33, 64])
@pytest.mark.parametrize("tier", ["raw", "bf16", "int8"])
@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan"])
def test_staged_design_tiles(cuda, name, tier, k):
    """The staged design's tiles: partial (K < 32, K = 31, 33), whole and
    several a query, with B·K not a multiple of anything; the first tile
    of query 3 all -1 (row 0) and one index past the store inside a tile."""
    metric, rows, norms, rng = _tier_store(cuda, name, tier)
    b = 37
    q = torch.from_numpy(rng.standard_normal((b, rows.shape[1])).astype(np.float32)).to(cuda)
    qn = torch.from_numpy(distances.np_norms(metric, q.cpu().numpy())).to(cuda)
    idx = torch.from_numpy(rng.integers(-1, rows.shape[0], (b, k)).astype(np.int32)).to(cuda)
    idx[3, : min(k, 32)] = -1
    idx[5, k // 2] = rows.shape[0]
    got = _check_against_twin(metric, rows, norms, q, qn, idx, "staged")
    assert int(torch.isnan(got).sum()) == 1 and bool(torch.isnan(got[5, k // 2]))


@pytest.mark.parametrize("k", [24, 33, 49, 64])
@pytest.mark.parametrize("tier", ["raw", "bf16", "int8", "packed", "packed-bq-cosine"])
def test_option_widths_match_twin(cuda, tier, k):
    """The build options' hop widths: [W, traverse] (24), [W, 1 + M0 + 16]
    chain seeds at M0 = 32 with slack 16 (49), [W, E·M0] at E = 2 (64), and
    a one-candidate tail tile (33). Each row ends in a run of -1 (the
    rows of inactive expansions, a truncated row's padding) of its own
    length, one row is all -1, and one index lies past the store. Packed
    rows (hamming, and BQ cosine) take the pair design."""
    name = "cosine"
    if tier.startswith("packed"):
        metric = distances.BQ_COSINE if tier == "packed-bq-cosine" else distances.HAMMING
        rows, norms, rng = _packed_store(metric, 3000, 768, 41)
        q, qn = rows[:53].contiguous(), norms[:53].contiguous()
    else:
        metric, rows, norms, rng = _tier_store(cuda, name, tier, seed=41)
        q = torch.from_numpy(rng.standard_normal((53, 768)).astype(np.float32)).to(cuda)
        qn = torch.from_numpy(distances.np_norms(metric, q.cpu().numpy())).to(cuda)
    idx = rng.integers(0, rows.shape[0], (53, k)).astype(np.int32)
    tails = rng.integers(0, k, 53)
    idx[np.arange(k)[None, :] >= (k - tails)[:, None]] = -1
    idx[7] = -1
    idx[11, 0] = rows.shape[0]
    idx = torch.from_numpy(idx).to(cuda)
    if tier.startswith("packed"):
        got = _check_packed(metric, rows, norms, q, qn, idx, "pair")
        assert int(torch.isnan(got).sum()) == 1 and bool(torch.isnan(got[11, 0]))
    else:
        got = _check_against_twin(metric, rows, norms, q, qn, idx, "staged")
        assert int(torch.isnan(got).sum()) == 1 and bool(torch.isnan(got[11, 0]))


@pytest.mark.parametrize("change", [dict(bulk=False, beam_expand=2), dict(bulk=False, traverse=24),
                                    dict(bulk=False, link_slack=16), dict(bulk=True, bulk_backbone=False, bulk_upper=1),
                                    dict(bulk=True, backbone_flat=False)],
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if k != "bulk"))
def test_option_builds_on_cuda_match_cpu(cuda, change):
    """A build with each option (1500 x 32, m0 = 32) on the card against the
    same build on the CPU: the kernel sums in another order, so near-ties
    may flip (95% of links0 rows, the same levels and entry points)."""
    data, _ = _clustered(1500)
    graphs = []
    for dev in ("cpu", cuda):
        g = hnsw.HostGraph.empty(distances.COSINE, 32, 16, 32, capacity=hnsw.slot_capacity(1500))
        for i in range(1500):
            g.alloc_slot(i)
        g.vectors[:1500] = data
        g.norms[:1500] = distances.np_norms(distances.COSINE, data)
        builder.build_graph(g, np.arange(1500), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=48, wave_size=128, **change), device=dev)
        g.check_validity()
        graphs.append(g)
    a, b = graphs
    assert np.array_equal(a.levels, b.levels) and a.entry_slots == b.entry_slots
    live = a.valid_mask()
    share = float(np.mean(np.all(a.links0[live] == b.links0[live], axis=1)))
    print(f"{change} cuda vs cpu: identical links0 rows {share:.4f}")
    assert share >= 0.95


@pytest.mark.parametrize("dim", [768, 130, 37])
@pytest.mark.parametrize("tier", ["raw", "bf16", "int8"])
def test_design_follows_the_row_width(cuda, tier, dim):
    """768-wide rows are whole 16-byte units and take the staged design;
    130 and 37 wide rows are not (f32 rows of 130: 520 bytes) and take the
    warp design."""
    metric, rows, norms, rng = _tier_store(cuda, "euclidean", tier, dim=dim)
    assert beam_cuda.design_of(rows.dtype, metric, dim, True) == ("staged" if dim == 768 else "warp")
    q = torch.from_numpy(rng.standard_normal((19, dim)).astype(np.float32)).to(cuda)
    qn = torch.zeros(19, device=cuda)
    idx = torch.from_numpy(rng.integers(-1, rows.shape[0], (19, 32)).astype(np.int32)).to(cuda)
    _check_against_twin(metric, rows, norms, q, qn, idx, "staged" if dim == 768 else "warp")


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan"])
def test_staged_design_build_query_and_own_row(cuda, name, tier):
    """A build's query, gathered from the store (int8: dequantised by its
    scale), against the twin; under euclidean and manhattan a row against
    its own copy gives exactly 0."""
    metric, rows, norms, rng = _tier_store(cuda, name, tier)
    pick = torch.from_numpy(rng.integers(0, rows.shape[0], 41)).to(cuda)
    q, qn = rows[pick].contiguous(), norms[pick].contiguous()
    idx = torch.from_numpy(rng.integers(-1, rows.shape[0], (41, 32)).astype(np.int32)).to(cuda)
    idx[:, 7] = pick.to(torch.int32)
    got = _check_against_twin(metric, rows, norms, q, qn, idx, "staged")
    if name != "cosine":
        assert bool((got[:, 7] == 0).all())


@pytest.mark.parametrize("tier", ["raw", "bf16", "int8"])
@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_staged_design_one_row_store(cuda, name, tier):
    """A store of one row: every index reads it (-1 too), 1 is past it."""
    metric, rows, norms, rng = _tier_store(cuda, name, tier, n=1)
    q = torch.from_numpy(rng.standard_normal((5, 768)).astype(np.float32)).to(cuda)
    qn = torch.from_numpy(distances.np_norms(metric, q.cpu().numpy())).to(cuda)
    idx = torch.from_numpy(rng.integers(-1, 1, (5, 9)).astype(np.int32)).to(cuda)
    idx[4, 8] = 1
    got = _check_against_twin(metric, rows, norms, q, qn, idx, "staged")
    assert int(torch.isnan(got).sum()) == 1


def _packed_store(metric, n, dim, seed):
    """A random [n, dim]-bit store under a packed metric: int32 lanes on the
    card and their norms, and a numpy generator for the rest of the case."""
    from hannoy_tpu_torch.ops import codecs

    rng = np.random.default_rng(seed)
    lanes = codecs.pack(rng.standard_normal((n, dim)).astype(np.float32), metric.codec)
    rows = torch.from_numpy(distances.as_lanes(lanes)).to("cuda")
    return rows, torch.from_numpy(distances.np_norms(metric, lanes)).to("cuda"), rng


def _check_packed(metric, rows, norms, q, qn, idx, design):
    """One packed launch: it goes through ``design`` and equals the twin,
    NaN where the twin has NaN (BQ cosine to one f32 ulp)."""
    before = beam_cuda.KERNEL.by_design.get(("packed", design), 0)
    got = beam_cuda.gathered_distances(metric, rows, norms, q, qn, idx)
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.by_design[("packed", design)] == before + 1
    want = beam_cuda.gathered_distances_plain(metric, rows, norms, q, qn, idx)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    if metric.name == "binary quantized cosine":
        torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=1.2e-7)
    else:
        assert torch.equal(got[keep], want[keep])
    return got


@pytest.mark.parametrize("k", [1, 8, 24, 32, 33, 64])
@pytest.mark.parametrize("b", [1, 3, 128, 4096])
@pytest.mark.parametrize("dim", [768, 128, 1024, 160, 37])
@pytest.mark.parametrize("metric", [m for m in distances.ALL_METRICS if m.is_packed], ids=lambda m: m.name)
def test_packed_kernel_forms_match_twin(cuda, metric, dim, b, k):
    """Packed lanes: popcounts are integers, so hamming, BQ euclidean and
    BQ manhattan are bit-equal; the BQ cosine epilogue to one f32 ulp.
    768, 128 and 1024 bits (24, 4 and 32 lanes: whole 16-byte units) take
    the pair design, 160 and 37 bits (6 and 2 lanes) the group design. The
    queries are rows of the store, each row ends in a run of -1 of its own
    length, one index lies past the store (NaN), and under BQ cosine every
    17th row and the first query have norm 0 (distance 0)."""
    rows, norms, rng = _packed_store(metric, 3000, dim, 22)
    if metric.name == "binary quantized cosine":
        norms[::17] = 0
    pick = torch.from_numpy(rng.integers(0, 3000, b)).to(cuda)
    q, qn = rows[pick].contiguous(), norms[pick].contiguous()
    qn[0] = 0
    idx = rng.integers(0, 3000, (b, k)).astype(np.int32)
    tails = rng.integers(0, k, b)
    idx[np.arange(k)[None, :] >= (k - tails)[:, None]] = -1
    idx[:, 0] = pick.cpu().numpy()  # each query against its own row
    idx[b // 2, k // 2] = 3000
    idx = torch.from_numpy(idx).to(cuda)
    design = "pair" if rows.shape[1] % 4 == 0 else "group"
    assert beam_cuda.design_of(rows.dtype, metric, rows.shape[1], True) == design
    got = _check_packed(metric, rows, norms, q, qn, idx, design)
    assert bool(torch.isnan(got[b // 2, k // 2])) and int(torch.isnan(got).sum()) == 1
    own = got[:, 0][idx[:, 0] < 3000]
    if metric.name == "binary quantized cosine":
        zero = (qn == 0) | (norms[idx[:, 0].clamp(max=2999).long()] == 0)
        assert bool((own[zero[idx[:, 0] < 3000]] == 0).all())
    else:
        assert bool((own == 0).all())  # a row against its own copy


@pytest.mark.parametrize("dim", [768, 37])
@pytest.mark.parametrize("metric", [m for m in distances.ALL_METRICS if m.is_packed], ids=lambda m: m.name)
def test_packed_one_row_store(cuda, metric, dim):
    """A store of one row: every index reads it (-1 too), 1 is past it."""
    rows, norms, rng = _packed_store(metric, 1, dim, 23)
    q, qn = rows.expand(5, -1).contiguous(), norms.expand(5).contiguous()
    idx = torch.from_numpy(rng.integers(-1, 1, (5, 9)).astype(np.int32)).to(cuda)
    idx[4, 8] = 1
    got = _check_packed(metric, rows, norms, q, qn, idx, "pair" if dim == 768 else "group")
    assert int(torch.isnan(got).sum()) == 1


@pytest.mark.parametrize("metric", [m for m in distances.ALL_METRICS if m.is_packed], ids=lambda m: m.name)
def test_packed_group_design_serves_narrow_and_unaligned_rows(cuda, metric):
    """A 2-lane store (64 bits), and 768-bit rows in a view that starts one
    lane into its storage (4-byte aligned, not 16), take the group design."""
    rows, norms, rng = _packed_store(metric, 2000, 64, 24)
    idx = torch.from_numpy(rng.integers(-1, 2000, (37, 32)).astype(np.int32)).to(cuda)
    _check_packed(metric, rows, norms, rows[:37].contiguous(), norms[:37].contiguous(), idx, "group")
    wide, norms, _ = _packed_store(metric, 2000, 768, 25)
    flat = torch.empty(2000 * 24 + 1, dtype=torch.int32, device=cuda)
    view = flat[1:].view(2000, 24)
    view.copy_(wide)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    q = view[:37].contiguous()
    assert beam_cuda.design_of(view.dtype, metric, 24, False) == "group"
    _check_packed(metric, view, norms, q, norms[:37].contiguous(), idx, "group")


@pytest.mark.parametrize("metric, tier", [(Metric.BQ_COSINE, "raw"), (Metric.HAMMING, "raw"), (Metric.COSINE, "int8"), (Metric.EUCLIDEAN, "bf16")],
                         ids=lambda v: getattr(v, "value", v))
def test_packed_and_tier_api_paths_on_cuda(cuda, tmp_path, metric, tier):
    """add -> build (bulk) -> commit -> reopen -> search on the card for a
    packed metric and a tier: the kernel's form for those rows runs, the
    graph is valid, and every vector finds itself (under a packed metric,
    where equal codes tie: tie-aware recall@10 against ``flat_topk``)."""
    from hannoy_tpu_torch.models.flat import flat_topk

    data, _ = _clustered(d=256 if metric.distance.is_packed else 32)
    beam_cuda.KERNEL.reset_counts()
    db = Database(tmp_path / "d", metric, tier=tier)
    w = db.writer(data.shape[1], m=8, ef=32)
    w.add_items(range(len(data)), data)
    w.builder(seed=42).bulk(True).build()
    db.commit_rw_txn()
    db.close()
    db = Database(tmp_path / "d", metric, tier=tier)
    r = db.reader()
    r.assert_validity()
    if metric.distance.is_packed:
        rows = r.by_vecs(data[:200], n=10, ef_search=64)
        q, qn = r._prep_queries(data[:200])
        exact_d, _ = flat_topk(metric.distance.name, q, qn, r._dev.vectors, r._dev.norms, r._dev.valid, 10)
        kth = (exact_d[:, 9] + 1e-6).cpu().numpy()
        recall = float(np.mean([[d <= kth[b] for _, d in row] for b, row in enumerate(rows)]))
        assert all(len(row) == 10 for row in rows) and recall >= 0.9, recall
    else:
        rows = r.by_vecs(data[:200], n=1, ef_search=64)
        assert np.mean([row[0][0] == i for i, row in enumerate(rows)]) >= 0.99
    form = beam_cuda.form_of(metric.distance, r._dev.vectors.dtype)
    assert beam_cuda.KERNEL.by_form.get(form, 0) > 0 and set(beam_cuda.KERNEL.by_form) == {form}
    db.close()


def test_build_and_search_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(5)
    n, d = 1500, 48
    data = rng.standard_normal((n, d)).astype(np.float32)
    graphs = {}
    for dev in ("cpu", cuda):
        g = hnsw.HostGraph.empty(distances.COSINE, d, 8, 16, capacity=hnsw.slot_capacity(n))
        for i in range(n):
            g.alloc_slot(i)
        g.vectors[:n] = data
        g.norms[:n] = distances.np_norms(distances.COSINE, data)
        before = _launches()
        builder.build_graph(g, np.arange(n), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=32, wave_size=128, bulk=False), device=dev)
        assert (_launches() > before) == (dev != "cpu")
        g.check_validity()
        graphs[str(dev)] = g
    a, b = graphs["cpu"], graphs["cuda"]
    assert np.array_equal(a.levels, b.levels) and a.entry_slots == b.entry_slots
    live = a.valid_mask()
    share = float(np.mean(np.all(a.links0[live] == b.links0[live], axis=1)))
    assert share >= 0.98, share

    q = torch.from_numpy(data[:64] + 0.01)
    qn = torch.from_numpy(distances.np_norms(distances.COSINE, data[:64] + 0.01))
    res_cpu = beam.hnsw_search(hnsw.to_device(a, "cpu"), q, qn, 48)
    res_gpu = beam.hnsw_search(hnsw.to_device(b, cuda), q.to(cuda), qn.to(cuda), 48)
    assert float((res_cpu.slots == res_gpu.slots.cpu()).float().mean()) >= 0.98


def _bulk_built(dev, data):
    n, d = data.shape
    g = hnsw.HostGraph.empty(distances.COSINE, d, 8, 16, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(distances.COSINE, data)
    before = _launches()
    builder.build_graph(g, np.arange(n), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=32, bulk=True), device=dev)
    assert (_launches() > before) == (dev != "cpu")
    g.check_validity()
    return g


def _clustered(n=6000, d=32):
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((n // 256, d)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, len(centers), n)] + rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, len(centers), 64)] + rng.standard_normal((64, d))).astype(np.float32)
    return data, queries


def test_bulk_build_on_cuda_matches_cpu(cuda):
    """The bulk build at 6000 × 32 on the card against the CPU build: the
    block products and k-means sums run in another order, so near-ties may
    flip (95% of links0 rows identical, recall within 0.02)."""
    data, queries = _clustered()
    a, b = _bulk_built("cpu", data), _bulk_built(cuda, data)
    assert np.array_equal(a.levels, b.levels) and a.entry_slots == b.entry_slots
    live = a.valid_mask()
    share = float(np.mean(np.all(a.links0[live] == b.links0[live], axis=1)))
    print(f"bulk build cuda vs cpu: identical links0 rows {share:.4f}")
    assert share >= 0.95
    qn = distances.np_norms(distances.COSINE, queries)
    exact = distances.np_pairwise(distances.COSINE, queries, qn, data, a.norms[: len(data)])
    kth = np.sort(exact, axis=1)[:, 9:10] + 1e-5
    recalls = []
    for g, dev in ((a, "cpu"), (b, cuda)):
        res = beam.hnsw_search(hnsw.to_device(g, dev), torch.from_numpy(queries).to(dev), torch.from_numpy(qn).to(dev), 64)
        recalls.append(float((res.dists[:, :10].cpu().numpy() <= kth).mean()))
    print(f"recall@10 cpu {recalls[0]:.4f} cuda {recalls[1]:.4f}")
    assert recalls[1] >= recalls[0] - 0.02


def test_bulk_build_on_cuda_is_deterministic(cuda):
    data, _ = _clustered()
    a, b = _bulk_built(cuda, data), _bulk_built(cuda, data)
    assert np.array_equal(a.links0, b.links0) and np.array_equal(a.dists0, b.dists0)
    for ua, ub in zip(a.upper_links, b.upper_links):
        assert np.array_equal(ua, ub)


@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_block_distances_on_cuda_match_cpu(cuda, name):
    rng = np.random.default_rng(14)
    q = torch.from_numpy((rng.standard_normal((4, 96, 768)) / np.sqrt(768)).astype(np.float32))
    c = torch.from_numpy((rng.standard_normal((4, 700, 768)) / np.sqrt(768)).astype(np.float32))
    qn, cn = q.norm(dim=-1), c.norm(dim=-1)
    metric = distances.by_name(name)
    want = distances.block_distances(metric, q, qn, c, cn)
    got = distances.block_distances(metric, q.to(cuda), qn.to(cuda), c.to(cuda), cn.to(cuda))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_api_path_on_cuda_matches_cpu(cuda, tmp_path):
    """add -> build (bulk) -> commit -> close -> reopen -> search -> append
    -> build at 6000 x 32 through ``Database(device="cuda")`` (the default)
    against the same calls with ``device="cpu"``."""
    data, queries = _clustered()
    extra = data[:200] + 0.05
    n = len(data)
    links, answers = {}, {}
    for name, kw in (("cpu", {"device": "cpu"}), ("cuda", {})):
        before = _launches()
        db = Database(tmp_path / name, Metric.COSINE, **kw)
        assert db.device.type == name
        w = db.writer(32, m=8, ef=32)
        w.add_items(range(n), data)
        w.builder(seed=42).bulk(True).build()
        db.commit_rw_txn()
        first = db.reader().by_vecs(queries, n=10, ef_search=64)
        db.close()
        db = Database(tmp_path / name, Metric.COSINE, **kw)
        r = db.reader()
        assert r._dev.vectors.device.type == name and r.n_items() == n
        assert r.by_vecs(queries, n=10, ef_search=64) == first
        w = db.writer(32, m=8, ef=32)
        w.add_items(range(n, n + 200), extra)
        w.builder(seed=42).build()
        db.commit_rw_txn()
        r = db.reader()
        r.assert_validity()
        hits = [row[0][0] for row in r.by_vecs(extra, n=1, ef_search=64)]
        assert np.mean(np.asarray(hits) == np.arange(n, n + 200)) >= 0.99
        answers[name] = r.by_vecs(queries, n=10, ef_search=64)
        links[name] = {k: v for k, v in db._db.prefix_iter(db._env.read_txn(), b"") if k[2] == 2}
        db.close()
        assert (_launches() > before) == (name == "cuda")
    assert links["cpu"].keys() == links["cuda"].keys()
    share = float(np.mean([links["cpu"][k] == links["cuda"][k] for k in links["cpu"]]))
    print(f"API path cuda vs cpu: identical links records {share:.4f} of {len(links['cpu'])}")
    assert share >= 0.95
    exact = distances.np_pairwise(
        distances.COSINE, queries, distances.np_norms(distances.COSINE, queries),
        np.concatenate([data, extra]), distances.np_norms(distances.COSINE, np.concatenate([data, extra])),
    )
    kth = np.sort(exact, axis=1)[:, 9] + 1e-5
    recall = {k: float(np.mean([[d <= kth[b] for _, d in row] for b, row in enumerate(v)])) for k, v in answers.items()}
    print(f"recall@10 cpu {recall['cpu']:.4f} cuda {recall['cuda']:.4f}")
    assert recall["cuda"] >= recall["cpu"] - 0.02


@pytest.mark.parametrize("form", ["cosine/raw", "euclidean/raw", "manhattan/raw", "cosine/bf16", "euclidean/bf16",
                                  "manhattan/bf16", "cosine/int8", "euclidean/int8", "manhattan/int8",
                                  "hamming", "binary quantized cosine", "binary quantized euclidean",
                                  "binary quantized manhattan"])
def test_repair_shape_matches_twin(cuda, form):
    """The deletion repair's launch, [REPAIR_BLOCK, 64] at D = 768, for
    every dense and packed form: the owners' own rows as queries (a
    build's), the spliced ids as candidates with -1 padding at the end of
    a row, as ``wave_ops.repair_deleted_rows`` hands them over."""
    from hannoy_tpu_torch.ops import codecs

    b, k = builder.REPAIR_BLOCK, 64
    name, _, tier = form.partition("/")
    metric = distances.by_name(name)
    if metric.is_packed:
        rng = np.random.default_rng(41)
        lanes = codecs.pack(rng.standard_normal((3000, 768)).astype(np.float32), metric.codec)
        rows = torch.from_numpy(distances.as_lanes(lanes)).to(cuda)
        norms = torch.from_numpy(distances.np_norms(metric, lanes)).to(cuda)
    else:
        metric, rows, norms, rng = _tier_store(cuda, name, tier)
    pick = torch.from_numpy(rng.integers(0, rows.shape[0], b)).to(cuda)
    q, qn = rows[pick].contiguous(), norms[pick].contiguous()
    idx = rng.integers(0, rows.shape[0], (b, k)).astype(np.int32)
    idx[np.arange(k)[None, :] >= rng.integers(1, k + 1, (b, 1))] = -1  # each row's splice ends early
    idx = torch.from_numpy(idx).to(cuda)
    before = beam_cuda.KERNEL.by_shape.get((b, k), 0)
    got = beam_cuda.gathered_distances(metric, rows, norms, q, qn, idx)
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.by_shape[(b, k)] == before + 1
    want = beam_cuda.gathered_distances_plain(metric, rows, norms, q, qn, idx)
    if metric.name == "binary quantized cosine":
        torch.testing.assert_close(got, want, rtol=0, atol=1.2e-7)
    elif metric.is_packed:
        assert torch.equal(got, want)
    else:
        tol = dict(rtol=0, atol=1e-5) if name == "cosine" else dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, want, **tol)


def test_delete_and_filter_on_cuda_match_cpu(cuda, tmp_path):
    """At 1500 x 32 cosine through ``Database``: build → commit → delete 50
    items and every entry point, add 50 → build (the repair launches the
    kernel on the card) → commit → filtered ``by_vecs`` and ``by_items``,
    on the card against the same calls on the CPU. Items and metadata are
    equal; links records and answers up to the kernel's summation order
    (near-ties), distances to 1e-5."""
    n, d = 1500, 32
    rng = np.random.default_rng(8)
    data = rng.standard_normal((n, d)).astype(np.float32)
    extra = rng.standard_normal((50, d)).astype(np.float32)
    queries = rng.standard_normal((64, d)).astype(np.float32)
    cands = sorted(rng.choice(n + 50, 600, replace=False).tolist())
    records, answers = {}, {}
    for name, kw in (("cpu", {"device": "cpu"}), ("cuda", {})):
        db = Database(tmp_path / name, Metric.COSINE, **kw)
        w = db.writer(d, m=8, ef=32)
        w.add_items(range(n), data)
        w.builder(seed=42).bulk(False).build()
        db.commit_rw_txn()
        eps = db.reader()._metadata.entry_points
        doomed = sorted(set(range(0, n, 30)) | set(eps))
        w = db.writer(d, m=8, ef=32)
        for i in doomed:
            assert w.del_item(i)
        w.add_items(range(n, n + 50), extra)
        before = beam_cuda.KERNEL.by_shape.get((builder.REPAIR_BLOCK, 64), 0)
        w.builder(seed=42).build()
        db.commit_rw_txn()
        assert (beam_cuda.KERNEL.by_shape.get((builder.REPAIR_BLOCK, 64), 0) > before) == (name == "cuda")
        r = db.reader()
        r.assert_validity()
        answers[name] = (r.nns(10).ef_search(64).linear_below(100).candidates(cands).by_vectors(queries)
                         + r.nns(10).ef_search(64).by_items(list(range(100, 400, 7))))
        found = {i for s in answers[name] if s is not None for i, _ in s.nns}
        assert not found & set(doomed) and found - set(r.item_ids()) == set()
        records[name] = dict(db._db.prefix_iter(db._env.read_txn(), b""))
        db.close()
    a, b = records["cpu"], records["cuda"]
    assert a.keys() == b.keys()
    links = [k for k in a if k[2] == 2]
    assert all(a[k] == b[k] for k in a if k[2] != 2)  # items, metadata, version
    share = float(np.mean([a[k] == b[k] for k in links]))
    print(f"delete + add on cuda vs cpu: identical links records {share:.4f} of {len(links)}")
    assert share >= 0.98
    pairs = [(g, c) for g, c in zip(answers["cuda"], answers["cpu"]) if c is not None]
    same = [[i for i, _ in g.nns] == [i for i, _ in c.nns] for g, c in pairs]
    print(f"filtered and by-item answers identical on {np.mean(same):.4f} of {len(pairs)} rows")
    assert np.mean(same) >= 0.95
    for (g, c), eq in zip(pairs, same):
        if eq:
            np.testing.assert_allclose([x for _, x in g.nns], [x for _, x in c.nns], rtol=1e-5, atol=1e-5)


def test_cancel_mid_flight_on_cuda_matches_cpu(cuda, tmp_path):
    """At 1500 x 32 cosine through ``Database``: searches whose cancel
    never fires, fires at once, and fires at its 3rd check, on the card
    against the same calls on the CPU. Never and at once: the same rows
    up to the kernel's summation order (near-ties); at the 3rd check every
    row on both devices is flagged, sorted, and holds each item at its
    exact distance (numpy, 1e-5)."""
    n, d = 1500, 32
    rng = np.random.default_rng(12)
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((64, d)).astype(np.float32)

    def fire_at(k):
        calls = [0]

        def cancel():
            calls[0] += 1
            return calls[0] == k

        return cancel

    rows = {}
    for name, kw in (("cpu", {"device": "cpu"}), ("cuda", {})):
        db = Database(tmp_path / name, Metric.COSINE, **kw)
        w = db.writer(d, m=8, ef=32)
        w.add_items(range(n), data)
        w.builder(seed=42).bulk(False).build()
        db.commit_rw_txn()
        r = db.reader()
        rows[name] = {k: r.nns(10).ef_search(64).by_vectors_with_cancellation(queries, fire_at(k)) for k in (0, 1, 3)}
        db.close()
    metric = distances.COSINE
    for name in rows:
        assert all(s.did_cancel and s.nns == [] for s in rows[name][1])
        assert not any(s.did_cancel for s in rows[name][0])
        for b, s in enumerate(rows[name][3]):
            ids = [i for i, _ in s.nns]
            got = np.asarray([x for _, x in s.nns], dtype=np.float32)
            assert s.did_cancel and ids and (np.diff(got) >= 0).all()
            exact = distances.np_pairwise(metric, queries[b : b + 1], distances.np_norms(metric, queries[b : b + 1]),
                                          data[ids], distances.np_norms(metric, data[ids]))[0]
            np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)
    same = np.mean([[i for i, _ in g.nns] == [i for i, _ in c.nns] for g, c in zip(rows["cuda"][0], rows["cpu"][0])])
    print(f"cancellable search on cuda vs cpu: identical rows {same:.4f}")
    assert same >= 0.95


def test_sharded_search_and_lockstep_build_on_cuda_match_cpu(cuda, tmp_path):
    """800 x 16 euclidean in 4 shards through ``ShardedWriter`` (lockstep
    builds, a fresh one and one that adds 24 and deletes 16) and
    ``ShardedReader``, with every shard on the card, against the same calls
    with every shard on the CPU: items and metadata equal, links records
    and answers up to the kernel's summation order, self-search exact."""
    from hannoy_tpu_torch.parallel import ShardedReader, ShardedWriter

    n, d, S = 800, 16, 4
    rng = np.random.default_rng(13)
    data = rng.standard_normal((n, d)).astype(np.float32)
    extra = rng.standard_normal((24, d)).astype(np.float32)
    records, answers = {}, {}
    for name, kw in (("cpu", {"device": "cpu"}), ("cuda", {})):
        devices = [torch.device(name)] * S
        db = Database(tmp_path / name, Metric.EUCLIDEAN, **kw)
        with ShardedWriter(db, d, n_shards=S, m=8, ef=48, devices=devices) as w:
            w.add_items(range(n), data)
        w = ShardedWriter(db, d, n_shards=S, m=8, ef=48, devices=devices)
        w.add_items(range(n, n + 24), extra)
        for i in range(16):
            assert w.del_item(i)
        w.build()
        db.commit_rw_txn()
        r = ShardedReader(db, n_shards=S, devices=devices)
        r.assert_validity()
        assert r.n_items() == n + 24 - 16
        assert [row[0][0] for row in r.search(extra, n=1, ef_search=48)] == list(range(n, n + 24))
        answers[name] = r.search(data[16:80], n=10, ef_search=48)
        records[name] = dict(db._db.prefix_iter(db._env.read_txn(), b""))
        db.close()
    a, b = records["cpu"], records["cuda"]
    assert a.keys() == b.keys()
    assert all(a[k] == b[k] for k in a if k[2] != 2)  # items, metadata, version
    share = float(np.mean([a[k] == b[k] for k in a if k[2] == 2]))
    same = [[i for i, _ in g] == [i for i, _ in c] for g, c in zip(answers["cuda"], answers["cpu"])]
    print(f"sharded on cuda vs cpu: identical links records {share:.4f}, answers {np.mean(same):.4f}")
    assert share >= 0.95 and np.mean(same) >= 0.95
    for (g, c), eq in zip(zip(answers["cuda"], answers["cpu"]), same):
        if eq:
            np.testing.assert_allclose([x for _, x in g], [x for _, x in c], rtol=1e-5, atol=1e-5)


# ---- the search kernels (csrc/search.cu) against the host loop and their plain versions ----


def _search_graph(cuda, name="cosine", tier="raw", n=3000, d=64, slack=0, seed=21):
    """A wave build on the CPU (m 8, m0 16), uploaded to the card in
    ``tier`` with ``slack`` extra layer-0 columns → (host graph, device
    graph, queries and their norms on the card)."""
    metric = distances.by_name(name)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(1, n // 256), d)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, len(centers), n)] + rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, len(centers), 96)] + rng.standard_normal((96, d))).astype(np.float32)
    g = hnsw.HostGraph.empty(metric, d, 8, 16, capacity=hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = distances.np_norms(metric, data)
    builder.build_graph(g, np.arange(n), np.empty(0, np.int64),
                        builder.BuildOptions(ef_construction=32, wave_size=256, bulk=False), device="cpu")
    dev = hnsw.to_device(g, cuda, tier=tier, link_slack=slack)
    q = torch.from_numpy(queries).to(cuda)
    qn = torch.from_numpy(distances.np_norms(metric, queries)).to(cuda)
    return g, dev, q, qn


def _packed_search_graph(cuda, name, bits=1536, seed=21):
    """``_search_graph``'s cosine graph with packed rows under ``name``: the
    signs of its points' random projections to ``bits`` dimensions
    (hamming then follows their angles), and its queries' → (device graph,
    queries' lanes and their norms on the card)."""
    from hannoy_tpu_torch.ops import codecs

    g, dev, q, _ = _search_graph(cuda, seed=seed)
    metric = distances.by_name(name)
    project = np.random.default_rng(seed + 1).standard_normal((g.vectors.shape[1], bits)).astype(np.float32)
    rows = codecs.pack(g.vectors @ project, metric.codec)
    q_lanes = codecs.pack(q.cpu().numpy() @ project, metric.codec)
    lanes = lambda x: torch.from_numpy(distances.as_lanes(x)).to(cuda)  # noqa: E731
    norms = lambda x: torch.from_numpy(distances.np_norms(metric, x)).to(cuda)  # noqa: E731
    dev = dataclasses.replace(dev, metric_name=name, vectors=lanes(rows), norms=norms(rows))
    return dev, lanes(q_lanes), norms(q_lanes)


def _bits(res):
    return res.slots.cpu(), res.dists.cpu().view(torch.int32), int(res.iters), res.active.cpu()


def _assert_same(a, b):
    for x, y in zip(_bits(a), _bits(b)):
        assert (x == y) if isinstance(x, int) else torch.equal(x, y)


def _host_search(monkeypatch, fn):
    """``fn()`` with the searches' loops on the host (``beam_search_loop``,
    ``greedy_descend_loop``)."""
    with monkeypatch.context() as m:
        m.setattr(beam, "beam_search", beam.beam_search_loop)
        m.setattr(beam, "greedy_descend", beam.greedy_descend_loop)
        return fn()


def _check_search(monkeypatch, dev, q, qn, ef, ef_upper=1, rows=None, twin=True):
    """``hnsw_search`` by the kernels against the host loop on the card and
    the plain versions (on ``rows`` of the batch where given), bit for
    bit, and (``twin``) against the plain versions with the plain twin's
    distances (99% of slots, distances within 1e-5 relative)."""
    search_cuda.KERNELS.reset_counts()
    beam_cuda.KERNEL.reset_counts()
    got = beam.hnsw_search(dev, q, qn, ef, ef_upper=ef_upper)
    torch.cuda.synchronize()
    launches = dict(search_cuda.KERNELS.launches)
    assert beam_cuda.KERNEL.launches == 0, "a hop of the search launched the gather kernel"
    assert launches.get("beam_search", 0) == (2 if ef_upper > 1 and dev.max_level >= 1 else 1)
    assert launches.get("greedy_descend", 0) == (1 if dev.max_level >= (2 if ef_upper > 1 else 1) else 0)
    _assert_same(got, _host_search(monkeypatch, lambda: beam.hnsw_search(dev, q, qn, ef, ef_upper=ef_upper)))
    sel = slice(None) if rows is None else slice(0, rows)
    part = beam.hnsw_search(dev, q[sel], qn[sel], ef, ef_upper=ef_upper)
    _assert_same(part, search_cuda.hnsw_search_rowwise(dev, q[sel], qn[sel], ef, ef_upper=ef_upper))
    if not twin:
        return got
    plain = search_cuda.hnsw_search_rowwise(dev, q[sel], qn[sel], ef, ef_upper=ef_upper, plain=True)
    same = (plain.slots == part.slots) & (part.slots >= 0)
    assert float((plain.slots == part.slots).float().mean()) >= 0.99
    torch.testing.assert_close(part.dists[same], plain.dists[same], rtol=1e-5, atol=1e-5)
    return got


PACKED_NAMES = [m.name for m in distances.ALL_METRICS if m.is_packed]


@pytest.mark.parametrize("name, tier", [(name, tier) for name in ("cosine", "euclidean", "manhattan")
                                        for tier in ("raw", "bf16", "int8")]
                         + [(name, "packed-1536") for name in PACKED_NAMES] + [("hamming", "packed-3072")])
def test_search_kernels_match_host_loop(cuda, monkeypatch, name, tier):
    """``hnsw_search`` by the kernels equals the host loop on the card and
    the plain versions, slots and distance bits, through the greedy descent
    and the layer-1 and layer-0 beams, in every row form: f32, bf16 and
    int8 rows, and packed rows of 48 lanes (1,536 bits: the hamming cell's
    rows, each packed metric) and of 96 (3,072 bits: wider than a group's
    registers hold, so that the query's further lanes are read in a loop);
    the launches count under the graph's form."""
    if tier.startswith("packed"):
        dev, q, qn = _packed_search_graph(cuda, name, bits=int(tier.split("-")[1]))
        assert dev.vectors.dtype == torch.int32 and dev.vectors.shape[1] == int(tier.split("-")[1]) // 32
    else:
        _, dev, q, qn = _search_graph(cuda, name, tier)
    assert search_cuda.search_design_of("cuda", dev.vectors.dtype, dev.metric, dev.vectors.shape[1], True,
                                        ef=100, width=dev.m0) == "kernel"
    form = beam_cuda.form_of(dev.metric, dev.vectors.dtype)
    wide = ((100, 32),) if tier.startswith("packed") else ()
    for ef, ef_upper in ((1, 1), (10, 8), (48, 1), (48, 8)) + wide:
        got = _check_search(monkeypatch, dev, q, qn, ef, ef_upper, rows=24)
        assert got.slots.shape == (96, ef) and bool((got.slots[:, 0] >= 0).all())
        by_form = search_cuda.KERNELS.by_form
        assert by_form.get((search_cuda.BEAM, *form), 0) >= 1
        assert set(by_form) <= {(search_cuda.BEAM, *form), (search_cuda.GREEDY, *form)}


def nan_walk_rows(dev) -> list[int]:
    """Slots to fill with NaN so that searches meet them: each entry point's
    first link at the highest level it has one, and every 37th slot."""
    top = dev.max_level
    entries = [int(e) for e in dev.entry_slots if e >= 0]
    rows = [dev.upper_links[lv - 1][int(dev.slot_rows[lv - 1][e])] for e in entries for lv in range(top, 0, -1)]
    return sorted({int(r[r >= 0][0]) for r in rows if bool((r >= 0).any())}) + list(range(0, dev.capacity, 37))


@pytest.mark.parametrize("case", ["one_row", "ef_past_reach", "link_slack", "ef_512", "nan_rows", "nan_rows_cosine"])
def test_search_kernels_edge_cases(cuda, monkeypatch, case):
    """A one-row store; ef larger than the items (a pool that never fills);
    layer-0 rows wider than m0 (slack columns of -1); ef 512; euclidean and
    cosine rows that hold NaN on the walks and at an entry point (the
    greedy descent takes a NaN first, as ``torch.argmin`` does; no pool
    keeps one; under cosine too a NaN row is at distance NaN)."""
    if case == "one_row":
        g = hnsw.HostGraph.empty(distances.COSINE, 64, 8, 16, capacity=hnsw.slot_capacity(1))
        g.alloc_slot(0)
        g.vectors[0] = np.random.default_rng(1).standard_normal(64).astype(np.float32)
        g.norms[:1] = distances.np_norms(distances.COSINE, g.vectors[:1])
        builder.build_graph(g, np.arange(1), np.empty(0, np.int64), builder.BuildOptions(bulk=False), device="cpu")
        dev = hnsw.to_device(g, cuda)
        qs = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
        q, qn = torch.from_numpy(qs).to(cuda), torch.from_numpy(distances.np_norms(distances.COSINE, qs)).to(cuda)
        got = _check_search(monkeypatch, dev, q, qn, 10)
        assert bool((got.slots[:, 0] == 0).all()) and bool((got.slots[:, 1:] == -1).all())
    elif case == "ef_past_reach":
        _, dev, q, qn = _search_graph(cuda, n=40)
        got = _check_search(monkeypatch, dev, q, qn, 64, 8)
        assert int((got.slots[0] >= 0).sum()) == 40 and bool(torch.isinf(got.dists[:, 40:]).all())
    elif case == "link_slack":
        _, dev, q, qn = _search_graph(cuda, "euclidean", slack=8)
        assert dev.links0.shape[1] == 24
        _check_search(monkeypatch, dev, q, qn, 48, 8, rows=24)
    elif case == "ef_512":
        _, dev, q, qn = _search_graph(cuda)
        _check_search(monkeypatch, dev, q, qn, 512, 8, rows=8)
    else:
        _, dev, q, qn = _search_graph(cuda, "euclidean" if case == "nan_rows" else "cosine")
        dev.vectors[torch.tensor(nan_walk_rows(dev), device=cuda)] = float("nan")
        for ef_upper in (1, 8):
            # (the plain twin's other rounding takes other turns at NaN rows:
            # only the bit-for-bit checks apply here)
            got = _check_search(monkeypatch, dev, q, qn, 48, ef_upper, rows=24, twin=False)
            assert not bool(torch.isnan(got.dists).any())
        dev.vectors[int(dev.entry_slots[dev.entry_slots >= 0][-1])] = float("nan")
        entry = next(int(e) for e in dev.entry_slots if e >= 0 and bool(torch.isnan(dev.vectors[e]).any()))
        cur = beam.greedy_descend(dev, q, qn, dev.max_level, 1)
        assert torch.equal(cur, beam.greedy_descend_loop(dev, q, qn, dev.max_level, 1))
        assert bool((cur == entry).all())
        assert torch.equal(cur, search_cuda.greedy_descend_rowwise(dev, q, qn, dev.max_level, 1))


@pytest.mark.parametrize("graph", ["cosine", "hamming-1536"])
@pytest.mark.parametrize("fire_at", [1, 2, 3])
def test_search_kernels_cancel_at_the_host_loops_checks(cuda, fire_at, graph):
    """A cancel that fires at the k-th check: the kernels' launches of
    SYNC_EVERY hops stop where the host loop stops, with its pools; on f32
    rows and on packed rows of 48 lanes."""
    if graph == "cosine":
        _, dev, q, qn = _search_graph(cuda)
    else:
        dev, q, qn = _packed_search_graph(cuda, "hamming")

    def firing():
        calls = []

        def cancel():
            calls.append(1)
            return len(calls) >= fire_at
        return cancel, calls

    cancel, calls = firing()
    got = beam.beam_search(dev, q, qn, dev.entry_slots[None, :].expand(q.shape[0], -1), 48, cancel=cancel)
    host_cancel, host_calls = firing()
    want = beam.beam_search_loop(dev, q, qn, dev.entry_slots[None, :].expand(q.shape[0], -1), 48, cancel=host_cancel)
    assert len(calls) == len(host_calls) == fire_at
    _assert_same(got, want)
    cancel, calls = firing()
    cur = beam.greedy_descend(dev, q, qn, dev.max_level, 1, cancel=cancel)
    host_cancel, host_calls = firing()
    assert torch.equal(cur, beam.greedy_descend_loop(dev, q, qn, dev.max_level, 1, cancel=host_cancel))
    assert len(calls) == len(host_calls)


@pytest.mark.parametrize("tier", ["raw", "bf16", "int8"])
def test_insertion_seeds_by_the_kernels(cuda, monkeypatch, tier):
    """``descend_for_slots`` (a build's seeds, its queries rows of the
    store) by the kernels against the host loop, at ef_upper 1 and 8."""
    _, dev, _, _ = _search_graph(cuda, "euclidean", tier)
    wave = torch.arange(0, 3000, 7, dtype=torch.int32, device=cuda)
    for ef_upper in (1, 8):
        search_cuda.KERNELS.reset_counts()
        got = beam.descend_for_slots(dev, wave, dev.max_level, 1, ef_upper=ef_upper)
        assert sum(search_cuda.KERNELS.launches.values()) >= 1
        want = _host_search(monkeypatch, lambda: beam.descend_for_slots(dev, wave, dev.max_level, 1, ef_upper=ef_upper))
        assert torch.equal(got, want)


def test_reader_by_vecs_through_the_kernels(cuda, tmp_path, monkeypatch):
    """``Reader.by_vecs`` and an unfiltered ``by_items`` on the card: the
    kernels answer (at most three launches, none of the gather kernel) and
    the answers are the host loop's, id for id and distance for distance."""
    data, queries = _clustered()
    db = Database(tmp_path / "db", Metric.COSINE)
    w = db.writer(32, m=8, ef=32)
    w.add_items(range(len(data)), data)
    w.builder(seed=42).build()
    db.commit_rw_txn()
    r = db.reader()
    for ef, efu in ((64, None), (48, 32)):
        search_cuda.KERNELS.reset_counts()
        beam_cuda.KERNEL.reset_counts()
        got = r.nns(10).ef_search(ef)
        got = (got.ef_upper(efu) if efu else got).by_vectors(queries)
        assert beam_cuda.KERNEL.launches == 0 and 1 <= sum(search_cuda.KERNELS.launches.values()) <= 3
        want = _host_search(monkeypatch, lambda: (r.nns(10).ef_search(ef).ef_upper(efu) if efu else r.nns(10).ef_search(ef)).by_vectors(queries))
        assert [row.nns for row in got] == [row.nns for row in want]
    # an unfiltered by_items: one launch of the beam kernel, the host loop's answers
    items = list(range(0, len(data), 97))
    search_cuda.KERNELS.reset_counts()
    beam_cuda.KERNEL.reset_counts()
    got = r.nns(10).ef_search(64).by_items(items)
    assert beam_cuda.KERNEL.launches == 0 and search_cuda.KERNELS.launches == {"beam_search": 1}
    want = _host_search(monkeypatch, lambda: r.nns(10).ef_search(64).by_items(items))
    assert [row.nns for row in got] == [row.nns for row in want]
    db.close()


# ---- the staged hop: rows in flight at once, in rounds through the warps' slots ----


def _full_rows(dev, seed=5):
    """``dev`` with every layer-0 link row full: as many distinct live ids
    as it has columns, none the row's own slot."""
    n, w = int(dev.valid.sum()), dev.links0.shape[1]
    rng = np.random.default_rng(seed)
    rows = np.full(tuple(dev.links0.shape), -1, dtype=np.int32)
    for slot in range(n):
        ids = rng.choice(n - 1, w, replace=False)
        rows[slot] = ids + (ids >= slot)
    return dataclasses.replace(dev, links0=torch.from_numpy(rows).to(dev.links0.device))


def _check_beam(monkeypatch, dev, q, qn, start, ef, max_iters=None, node_ok=None, rows=8):
    """One beam by the kernel (a single launch, no gather launch) against
    the host loop on the batch and the plain version on its first
    ``rows`` rows, bit for bit → the kernel's result."""
    search_cuda.KERNELS.reset_counts()
    beam_cuda.KERNEL.reset_counts()
    got = beam.beam_search(dev, q, qn, start, ef, max_iters=max_iters, node_ok=node_ok)
    torch.cuda.synchronize()
    assert search_cuda.KERNELS.launches == {"beam_search": 1} and beam_cuda.KERNEL.launches == 0
    _assert_same(got, beam.beam_search_loop(dev, q, qn, start, ef, max_iters=max_iters, node_ok=node_ok))
    part = beam.beam_search(dev, q[:rows], qn[:rows], start[:rows], ef, max_iters=max_iters, node_ok=node_ok)
    _assert_same(part, search_cuda.beam_search_rowwise(dev, q[:rows], qn[:rows], start[:rows], ef, max_iters,
                                                       node_ok=node_ok)[0])
    return got


@pytest.mark.parametrize("case", ["admits_none", "admits_every_column", "rounds_at_slack_width", "rounds_at_a_wide_pool",
                                  "bf16_rows", "int8_rows", "seed_batch_4096"])
def test_search_kernels_staged_hop(cuda, monkeypatch, case):
    """The hop's cases at 768-wide rows: a hop that admits no candidate
    (node_ok holds the seeds alone) and one that admits every column (full
    link rows of 40, one hop from one seed: 1 + 40 distances a row, more
    than the warps' slots, so in rounds); a wide row and a wide pool (ef
    640) whose candidates outnumber the slots (``beam_shared``'s rows below
    the width); bf16 and int8 rows; and the builds' batches of 4096 seeds. The
    kernels equal the host loop and the plain versions bit for bit."""
    if case == "seed_batch_4096":
        _, dev, _, _ = _search_graph(cuda, "euclidean", n=6000)
        wave = torch.arange(0, 6000, dtype=torch.int32, device=cuda)[:4096]
        for ef_upper in (1, 8):
            search_cuda.KERNELS.reset_counts()
            got = beam.descend_for_slots(dev, wave, dev.max_level, 1, ef_upper=ef_upper)
            assert sum(search_cuda.KERNELS.launches.values()) >= 1
            want = _host_search(monkeypatch, lambda: beam.descend_for_slots(dev, wave, dev.max_level, 1, ef_upper=ef_upper))
            assert torch.equal(got, want)
        return
    tier = {"bf16_rows": "bf16", "int8_rows": "int8"}.get(case, "raw")
    slack = {"admits_none": 0, "rounds_at_a_wide_pool": 16}.get(case, 24)
    _, dev, q, qn = _search_graph(cuda, "cosine" if case != "int8_rows" else "euclidean", tier, n=2000, d=768,
                                  slack=slack)
    width, rb = dev.links0.shape[1], 768 * dev.vectors.element_size()
    start = dev.entry_slots[None, :1].expand(q.shape[0], -1).contiguous()
    if case == "admits_none":
        ok = torch.zeros_like(dev.valid)
        ok[dev.entry_slots[:1].long()] = True
        got = _check_beam(monkeypatch, dev, q, qn, start, 16, node_ok=ok)
        assert bool((got.slots[:, 0] == dev.entry_slots[0]).all()) and bool((got.slots[:, 1:] == -1).all())
        assert bool((search_cuda.KERNELS.last["beam_search"]["n_dist"] == 1).all())
    elif case == "admits_every_column":
        dev = _full_rows(dev)
        assert search_cuda.beam_shared(768, rb, 48, width)[1] < width  # rounds
        _check_beam(monkeypatch, dev, q, qn, start, 48, max_iters=1)
        assert bool((search_cuda.KERNELS.last["beam_search"]["n_dist"] == 1 + width).all())
        _check_beam(monkeypatch, dev, q, qn, start, 48)
        _check_search(monkeypatch, dev, q, qn, 48, 8, rows=8)
    elif case == "rounds_at_slack_width":
        assert width == 40 and search_cuda.beam_shared(768, rb, 48, width)[1] < width
        _check_search(monkeypatch, dev, q, qn, 48, 8, rows=8)
    elif case == "rounds_at_a_wide_pool":
        assert width == 32 and search_cuda.beam_shared(768, rb, 640, width)[1] < width
        _check_search(monkeypatch, dev, q, qn, 640, 8, rows=4)
    else:
        assert dev.vectors.dtype == {"bf16": torch.bfloat16, "int8": torch.int8}[tier]
        for ef, ef_upper in ((10, 1), (48, 8)):
            _check_search(monkeypatch, dev, q, qn, ef, ef_upper, rows=8)


@pytest.mark.parametrize("name", ["hamming", "binary quantized cosine"])
def test_packed_search_kernels_skip_deleted_slots(cuda, monkeypatch, name):
    """Packed rows of 48 lanes and a ``node_ok`` without a tenth of the
    items (deleted slots): the greedy descent and the beam by the kernels'
    packed form equal the host loop and the plain versions, and no walk
    ends on a deleted slot and no pool holds one."""
    dev, q, qn = _packed_search_graph(cuda, name)
    form = (search_cuda.GREEDY, *beam_cuda.form_of(dev.metric, dev.vectors.dtype))
    assert form[1:] == ("packed", "popcount")
    ok = dev.valid.clone()
    dropped = torch.from_numpy(np.random.default_rng(9).choice(3000, 300, replace=False)).to(cuda)
    ok[dropped] = False
    search_cuda.KERNELS.reset_counts()
    cur = beam.greedy_descend(dev, q, qn, dev.max_level, 1, node_ok=ok)
    assert search_cuda.KERNELS.by_form == {form: 1}
    assert torch.equal(cur, beam.greedy_descend_loop(dev, q, qn, dev.max_level, 1, node_ok=ok))
    assert torch.equal(cur, search_cuda.greedy_descend_rowwise(dev, q, qn, dev.max_level, 1, node_ok=ok))
    assert bool(ok[cur.long()].all())
    got = _check_beam(monkeypatch, dev, q, qn, cur[:, None].contiguous(), 100, node_ok=ok)
    assert set(search_cuda.KERNELS.by_form) == {(search_cuda.BEAM, *form[1:])}
    assert not bool(torch.isin(got.slots, dropped).any()) and bool((got.slots[:, 0] >= 0).all())
