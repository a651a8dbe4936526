"""The port's bulk (cluster-blocked) fresh build against the JAX package:
its block distances, k-means, candidates, streamed reverse merge and
triangular flat candidates on the same inputs and states, and whole
``bulk=True`` builds (CPU, clustered data made with numpy from a seed).

Tolerances: f32 sums run in another order in the two frameworks, so
distances agree to atol 1e-5 (on unit-scale rows for euclidean, whose norm
expansion cancels); k-means centroids are such sums, so 99.5% of the
assignments must agree (only near-ties flip), candidate rows 99%, and
whole builds 95% of their ``links0`` rows, with recall within 0.02 of the
JAX build. Ops that only sort, merge and prune a given state must agree
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.build import bulk as jax_bulk
from hannoy_tpu.build import wave_ops as jax_wave_ops
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import beam as jax_beam
from hannoy_tpu.ops import distances as jax_distances
from hannoy_tpu_torch.build import builder, bulk, wave_ops
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, distances
from hannoy_tpu_torch.utils import tracing

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, M0, EFC = 6000, 32, 8, 16, 32
N_QUERIES, K = 64, 10


def _clustered(n, d, seed=42):
    """``tests/test_bulk.py``'s data: Gaussian clusters around n/256 centres."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(16, n // 256), d)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, len(centers), size=n)] + rng.standard_normal((n, d))).astype(np.float32)
    return data, centers


def _stage(mod, data, name):
    metric = (jax_distances if mod is jax_hnsw else distances).by_name(name)
    n = len(data)
    g = mod.HostGraph.empty(metric, D, M, M0, capacity=jax_hnsw.slot_capacity(n))
    for i in range(n):
        g.alloc_slot(i)
    g.vectors[:n] = data
    g.norms[:n] = jax_distances.np_norms(jax_distances.by_name(name), data)
    return g


def _device_state(jdev) -> dict:
    return {
        f: np.asarray(getattr(jdev, f))
        for f in ("vectors", "norms", "links0", "dists0", "upper_links", "upper_dists", "slot_rows", "entry_slots", "valid")
    } | {"metric_name": jdev.metric_name, "max_level": jdev.max_level}


def _both_devs(jg):
    """The JAX device graph of ``jg`` and the port's copy of its state."""
    jdev = jax_hnsw.to_device(jg, cache=False)
    return jdev, hnsw.device_graph_from_arrays("cpu", **_device_state(jdev))


@pytest.fixture(scope="module")
def data():
    return _clustered(N, D)


@pytest.fixture(scope="module")
def staged(data):
    """Both packages' device graphs of the staged (unbuilt) items."""
    return _both_devs(_stage(jax_hnsw, data[0], "cosine"))


@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_block_distances_match_jax(name):
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((3, 20, D)) / np.sqrt(D)).astype(np.float32)
    c = (rng.standard_normal((3, 50, D)) / np.sqrt(D)).astype(np.float32)
    qn = np.linalg.norm(q, axis=-1).astype(np.float32)
    cn = np.linalg.norm(c, axis=-1).astype(np.float32)
    want = np.asarray(jax_distances.block_distances(jax_distances.by_name(name), *map(jnp.asarray, (q, qn, c, cn))))
    got = distances.block_distances(distances.by_name(name), *map(torch.from_numpy, (q, qn, c, cn))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        distances.block_distances(distances.MANHATTAN, *map(torch.from_numpy, (q, qn, c, cn)))


def test_maxmin_indices_match_jax(data):
    geom = data[0][:3000]
    want = np.asarray(jax_bulk._maxmin_indices(jnp.asarray(geom), 40))
    got = bulk._maxmin_indices(torch.from_numpy(geom), 40).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_partition_matches_jax(staged, monkeypatch):
    jdev, tdev = staged
    members = np.arange(N, dtype=np.int64)
    monkeypatch.setattr(bulk, "INIT_SAMPLE", 4096)
    want = jax_bulk.kmeans_partition(jdev, members, 23, 3, np.random.default_rng(5), init="maxmin", init_sample=4096)
    got = bulk.kmeans_partition(tdev, members, 23, 3, np.random.default_rng(5))
    share = float((got == want).mean())
    print(f"kmeans_partition: equal assignments {share:.4f}")
    assert got.shape == want.shape and share >= 0.995


@pytest.mark.parametrize(
    "const, option",
    [
        (bulk.CLUSTER_SIZE, "bulk_cluster_size"),
        (bulk.KMEANS_ITERS, "bulk_kmeans_iters"),
        (bulk.ADJ, "bulk_adj"),
        (bulk.INIT_SAMPLE, "bulk_init_sample"),
        (bulk.RAND_CANDIDATES, "bulk_rand"),
        (builder.BACKBONE_FLAT_MAX, "backbone_flat_max"),
        (builder.BACKBONE_FLAT_POOL, "backbone_flat_pool"),
    ],
)
def test_bulk_constants_are_jax_defaults(const, option):
    """The port runs the bulk path with the JAX package's default knobs."""
    assert const == getattr(jax_builder.BuildOptions(), option)


@pytest.mark.parametrize(
    "name, n_active, n_deleted, n_insert, bulk_opt",
    [
        ("cosine", 0, 0, 8192, None),
        ("euclidean", 0, 0, 8191, None),
        ("manhattan", 0, 0, 20000, None),
        ("cosine", 10, 0, 20000, None),
        ("cosine", 0, 3, 20000, True),
        ("euclidean", 0, 0, 2, True),
        ("cosine", 0, 0, 20000, False),
    ],
)
def test_eligible_matches_jax(name, n_active, n_deleted, n_insert, bulk_opt):
    want = jax_bulk.eligible(jax_distances.by_name(name), n_active, n_deleted, n_insert,
                             jax_builder.BuildOptions(bulk=bulk_opt))
    got = bulk.eligible(distances.by_name(name), n_active, n_deleted, n_insert, builder.BuildOptions(bulk=bulk_opt))
    assert got == want


def test_brute_candidates_match_jax(staged):
    jdev, tdev = staged
    members = np.arange(0, N, 2, dtype=np.int64)  # 3000 members, chunked by 1024
    chunk, k = 1024, 40
    slots_pad = jax_bulk._pad_to(members.astype(np.int32), chunk, -1)
    j_ids, j_d = jax_bulk._brute_candidates_jit(
        jdev.vectors, jdev.norms, jnp.asarray(slots_pad), metric_name="cosine", K=k,
        n_steps=len(slots_pad) // chunk, chunk=chunk,
    )
    t_ids, t_d = bulk._brute_candidates(tdev, members, k, chunk)
    _assert_candidates_match("brute", t_ids.numpy(), t_d.numpy(), np.asarray(j_ids), np.asarray(j_d))


def _assert_candidates_match(what, t_ids, t_d, j_ids, j_d):
    assert t_ids.shape == j_ids.shape
    share = float(np.mean(np.all(t_ids == j_ids, axis=1)))
    print(f"{what} candidates: identical rows {share:.4f}")
    assert share >= 0.99
    same = t_ids == j_ids
    np.testing.assert_allclose(t_d[same], j_d[same], rtol=0, atol=1e-5)


def test_cluster_candidates_match_jax(staged):
    """Both packages' candidate step on the same pseudo-cluster tables
    (from the JAX package's k-means), plus the tables and adjacency."""
    jdev, tdev = staged
    members = np.arange(N, dtype=np.int64)
    C, k = 23, 40
    assign = jax_bulk.kmeans_partition(jdev, members, C, 3, np.random.default_rng(5))
    s_cap = int(np.ceil(1.3 * N / C))
    tab_pos, parent, _ = jax_bulk._pseudo_cluster_tables(assign, C, s_cap)
    t_pos, t_parent = bulk._pseudo_cluster_tables(assign, C, s_cap)
    np.testing.assert_array_equal(t_pos, tab_pos)
    np.testing.assert_array_equal(t_parent, parent)
    Cp = len(tab_pos)
    pad = (-Cp) % jax_bulk.CAND_GROUP
    tab_pos = np.concatenate([tab_pos, np.full((pad, s_cap), -1, dtype=np.int64)])
    parent = np.concatenate([parent, np.zeros(pad, dtype=np.int64)])
    tab_slots = np.where(tab_pos >= 0, members[np.maximum(tab_pos, 0)], -1)

    j_cent = jax_bulk._segment_centroids(jdev, members, assign, C)
    t_cent = bulk._segment_centroids(tdev, members, assign, C)
    np.testing.assert_allclose(t_cent.numpy(), np.asarray(j_cent), rtol=0, atol=1e-5)
    adj = np.array(jax_bulk._cluster_adjacency_jit(j_cent, jnp.asarray(parent.astype(np.int32)), metric_name="cosine", A=8))
    np.testing.assert_array_equal(bulk._cluster_adjacency(distances.COSINE, t_cent, parent, 8), adj)
    adj[Cp:] = -1

    j_out = jax_bulk._cluster_candidates_jit(
        jdev.vectors, jdev.norms, jnp.asarray(tab_slots.astype(np.int32)),
        jnp.asarray(np.where(tab_pos >= 0, tab_pos, N).astype(np.int32)), jnp.asarray(adj.astype(np.int32)),
        n_pad=N, metric_name="cosine", K=k, G=jax_bulk.CAND_GROUP, n_steps=len(tab_pos) // jax_bulk.CAND_GROUP,
    )
    t_out = bulk._cluster_candidates(tdev, tab_slots, tab_pos, adj, N, k)
    j_ids, j_d, j_src, j_dst, j_xd = (np.asarray(a).reshape(-1) if i >= 2 else np.asarray(a) for i, a in enumerate(j_out))
    t_ids, t_d, t_src, t_dst, t_xd = (a.numpy() for a in t_out)
    _assert_candidates_match("cluster", t_ids, t_d, j_ids, j_d)
    pairs = float(np.mean((t_src == j_src) & (t_dst == j_dst)))
    print(f"boundary pairs: identical {pairs:.4f} of {len(j_src)}")
    assert pairs >= 0.99 and (j_src >= 0).sum() > 0
    same = (t_src == j_src) & (t_dst == j_dst) & (j_src >= 0)
    np.testing.assert_allclose(t_xd[same], j_xd[same], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def built(data):
    """A JAX wave build of the first N/2 items (a graph with full rows)."""
    jg = _stage(jax_hnsw, data[0][: N // 2], "cosine")
    jax_builder.build_graph(
        jg, np.arange(N // 2, dtype=np.int64), np.empty(0, np.int64),
        jax_builder.BuildOptions(ef_construction=EFC, wave_size=512, bulk=False),
    )
    return jg


def test_reverse_merge_edges_streamed_matches_jax(built):
    """Reverse edges of 1200 sources (their own rows as selections) into
    full rows: phase A fits some destinations, phase B α-prunes the rest."""
    jdev, tdev = _both_devs(built)
    rng = np.random.default_rng(4)
    src = np.full(1280, -1, dtype=np.int32)
    src[:1200] = rng.choice(N // 2, 1200, replace=False)
    links, dists = np.asarray(jdev.links0), np.asarray(jdev.dists0)
    sel_ids = np.where(src[:, None] >= 0, np.roll(links[np.maximum(src, 0)], 3, axis=0), -1).astype(np.int32)
    sel_d = np.where(sel_ids >= 0, np.roll(dists[np.maximum(src, 0)], 3, axis=0), np.inf).astype(np.float32)

    j_g, j_cnt, j_u = jax_wave_ops.reverse_merge_edges_streamed(
        jdev, 0, jnp.asarray(src), jnp.asarray(sel_ids), jnp.asarray(sel_d), jnp.zeros((4,), jnp.int32),
        cap=M0, alpha=1.1, inc_cap=M0,
    )
    t_g, t_cnt, t_u = wave_ops.reverse_merge_edges_streamed(
        tdev, 0, torch.from_numpy(src), torch.from_numpy(sel_ids), torch.from_numpy(sel_d),
        torch.zeros(4, dtype=torch.int32), cap=M0, alpha=1.1, inc_cap=M0,
    )
    j_u = np.asarray(j_u)
    np.testing.assert_array_equal(t_u.numpy(), j_u[j_u >= 0])
    np.testing.assert_array_equal(t_g.links0.numpy(), np.asarray(j_g.links0))
    np.testing.assert_array_equal(t_g.dists0.numpy(), np.asarray(j_g.dists0))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    assert int(t_cnt[wave_ops.CNT_REV_DELTA]) != 0


def test_wave_insert_level_flat_col_order_matches_jax(built):
    """One full-width wave of 256 new items at layer 0 with triangular
    candidates: each sees the built graph and the wave items before it."""
    jg = _stage(jax_hnsw, np.concatenate([np.asarray(built.vectors[: N // 2]), _clustered(256, D, seed=9)[0]]), "cosine")
    jg.levels[: N // 2] = 0  # the built layer 0 alone
    jg.links0[: N // 2] = built.links0[: N // 2]
    jg.dists0[: N // 2] = built.dists0[: N // 2]
    jg.entry_slots = list(built.entry_slots)
    jdev, tdev = _both_devs(jg)
    wave = np.arange(N // 2, N // 2 + 256, dtype=np.int32)
    members = np.full(4096, -1, dtype=np.int32)
    members[: N // 2 + 256] = np.arange(N // 2 + 256)
    order = np.where(members >= 0, -1, 2**30).astype(np.int32)
    order[wave] = np.arange(256)
    node_ok = np.asarray(jdev.valid) | (np.arange(jdev.capacity) < N // 2 + 256)
    seeds = np.zeros((256, 1), dtype=np.int32)
    kw = dict(ef=64, cap=M0, alpha=1.0)

    j_res = jax_wave_ops.wave_insert_level(
        jdev, jnp.asarray(wave), jnp.asarray(seeds), jnp.asarray(node_ok), jnp.int32(0),
        jnp.zeros((jdev.capacity,), bool), jnp.zeros((4,), jnp.int32), is_level0=True,
        flat_members=jnp.asarray(members), flat_col_order=jnp.asarray(order), flat_row_base=jnp.int32(0), **kw,
    )
    t_res = wave_ops.wave_insert_level(
        tdev, torch.from_numpy(wave), torch.from_numpy(seeds), torch.from_numpy(node_ok), 0,
        torch.zeros(tdev.capacity, dtype=torch.bool), torch.zeros(4, dtype=torch.int32),
        flat_members=torch.from_numpy(members), flat_col_order=torch.from_numpy(order), flat_row_base=0, **kw,
    )
    sel = t_res.selected.numpy()
    np.testing.assert_array_equal(sel, np.asarray(j_res.selected))
    assert (sel[1:] >= N // 2).any(), "no wave item picked an earlier wave item"
    np.testing.assert_array_equal(t_res.graph.links0.numpy(), np.asarray(j_res.graph.links0))
    np.testing.assert_array_equal(t_res.dirty.numpy(), np.asarray(j_res.dirty))
    np.testing.assert_array_equal(t_res.counters.numpy(), np.asarray(j_res.counters))


def _recall(dists, vecs, queries, name):
    m = jax_distances.by_name(name)
    exact = jax_distances.np_pairwise(m, queries, jax_distances.np_norms(m, queries), vecs, jax_distances.np_norms(m, vecs))
    kth = np.sort(exact, axis=1)[:, K - 1 : K]
    return float((np.asarray(dists)[:, :K] <= kth + 1e-5 * np.abs(kth) + 1e-6).mean())


def _build_both(data, name, spans_expected, jax_opts=None):
    """Both packages' ``bulk=True`` builds; ``jax_opts`` are the JAX
    package's options that the port's constants were patched to match."""
    vecs, centers = data
    jg = _stage(jax_hnsw, vecs, name)
    jax_builder.build_graph(jg, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                            jax_builder.BuildOptions(ef_construction=EFC, bulk=True, **(jax_opts or {})))
    tg = _stage(hnsw, vecs, name)
    with tracing.record() as spans:
        stats = builder.build_graph(tg, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                                    builder.BuildOptions(ef_construction=EFC, bulk=True), device="cpu")
    assert stats.links_added > 0
    assert set(spans_expected) <= {s.name for s in spans}
    assert np.array_equal(tg.levels, jg.levels)
    assert tg.entry_slots == jg.entry_slots and tg.max_level == jg.max_level
    tg.check_validity()
    rng = np.random.default_rng(7)
    queries = (centers[rng.integers(0, len(centers), N_QUERIES)] + rng.standard_normal((N_QUERIES, D))).astype(np.float32)
    qn = jax_distances.np_norms(jax_distances.by_name(name), queries)
    t_res = beam.hnsw_search(hnsw.to_device(tg, "cpu", serve_only=True), torch.from_numpy(queries), torch.from_numpy(qn), 64)
    j_res = jax_beam.hnsw_search(jax_hnsw.to_device(jg, serve_only=True), jnp.asarray(queries), jnp.asarray(qn), 64)
    t_rec = _recall(t_res.dists.numpy(), vecs, queries, name)
    j_rec = _recall(j_res.dists, vecs, queries, name)
    live = tg.valid_mask()
    share = float(np.mean(np.all(tg.links0[live] == jg.links0[live], axis=1)))
    upper = [float(np.mean(np.all(a == b, axis=1))) for a, b in zip(tg.upper_links, jg.upper_links)]
    print(f"bulk build {name} {jax_opts or {}}: recall@10 port {t_rec:.4f} jax {j_rec:.4f}; "
          f"identical links0 rows {share:.4f}, upper rows {upper}")
    assert t_rec >= j_rec - 0.02
    assert share >= 0.95


@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_bulk_build_matches_jax(data, name):
    """Brute-force candidates (N <= BRUTE_MAX), flat backbone, random
    long edges, the three connect passes."""
    _build_both(data, name, ["bulk_build", "bulk_candidates", "bulk_random_candidates",
                             "connect_pass1", "connect_pass2", "connect_pass3"])


def test_bulk_kmeans_path_matches_jax(data, monkeypatch):
    """Above BRUTE_MAX: k-means, cluster blocks, forced cross links."""
    monkeypatch.setattr(jax_bulk, "BRUTE_MAX", 512)
    monkeypatch.setattr(bulk, "BRUTE_MAX", 512)
    monkeypatch.setattr(bulk, "CLUSTER_SIZE", 256)
    _build_both(data, "cosine", ["bulk_maxmin", "bulk_kmeans", "bulk_adjacency", "bulk_candidates",
                                 "bulk_cross_links"], jax_opts=dict(bulk_cluster_size=256))
