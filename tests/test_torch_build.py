"""The port's search, wave insertion and whole build against the JAX
package, on graphs and states the JAX package built (CPU; cosine, and
every f32 metric for the whole build).

Inputs are made with numpy from a seed and fed to both packages. Sums run
in another order in PyTorch than in XLA, so near-ties may flip: the tests
require at least 99% identical search slots (98% of wave rows), and
distances within atol 1e-5 where slots match. A whole port build must
reproduce the JAX build's levels and entry points exactly (both sample
them from the same numpy generator) and reach its recall within 0.02.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hannoy_tpu.build import builder as jax_builder
from hannoy_tpu.build import wave_ops as jax_wave_ops
from hannoy_tpu.models import hnsw as jax_hnsw
from hannoy_tpu.ops import beam as jax_beam
from hannoy_tpu.ops import distances as jax_distances
from hannoy_tpu_torch.build import builder, bulk, wave_ops
from hannoy_tpu_torch.build.bulk import bulk_build
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, distances

pytest_plugins = ("jax_programs",)  # clears JAX's compiled programs between tests: tests/jax_programs.py

torch.set_num_threads(2)

N, D, M, M0, EFC, WAVE = 1500, 32, 8, 16, 32, 128
N_QUERIES, K = 64, 10


def _opts(mod):
    return mod.BuildOptions(ef_construction=EFC, wave_size=WAVE, bulk=False)


def _data():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 2.0
    data = (centers[rng.integers(0, 16, N)] + rng.standard_normal((N, D))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, N_QUERIES)] + rng.standard_normal((N_QUERIES, D))).astype(np.float32)
    return data, queries


def _stage(mod, data, name="cosine"):
    metric = (jax_distances if mod is jax_hnsw else distances).by_name(name)
    g = mod.HostGraph.empty(metric, D, M, M0, capacity=jax_hnsw.slot_capacity(N))
    for i in range(N):
        g.alloc_slot(i)
    g.vectors[:N] = data
    g.norms[:N] = jax_distances.np_norms(jax_distances.by_name(name), data)
    return g


def _host_state(jg) -> dict:
    state = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg) if f.name != "dev_cache"}
    state["metric"] = jg.metric.name
    return state


def _device_state(jdev) -> dict:
    return {
        f: np.asarray(getattr(jdev, f))
        for f in ("vectors", "norms", "links0", "dists0", "upper_links", "upper_dists", "slot_rows", "entry_slots", "valid")
    } | {"metric_name": jdev.metric_name, "max_level": jdev.max_level}


def _oracle_recall(dists, data, queries, name="cosine"):
    m = jax_distances.by_name(name)
    exact = jax_distances.np_pairwise(m, queries, jax_distances.np_norms(m, queries), data, jax_distances.np_norms(m, data))
    kth = np.sort(exact, axis=1)[:, K - 1 : K]
    thresh = kth + 1e-5 * np.abs(kth) + 1e-6  # f32 sums differ from numpy's in the last bits
    return float((dists[:, :K] <= thresh).mean())


@pytest.fixture(scope="module")
def ref():
    """One JAX wave build of the whole dataset, shared by the tests."""
    data, queries = _data()
    jg = _stage(jax_hnsw, data)
    jax_builder.build_graph(jg, np.arange(N, dtype=np.int64), np.empty(0, np.int64), _opts(jax_builder))
    return data, queries, jg


def _queries(mod_q, queries, name="cosine"):
    qn = jax_distances.np_norms(jax_distances.by_name(name), queries)
    return mod_q(queries), mod_q(qn)


def test_greedy_descend_matches_jax(ref):
    data, queries, jg = ref
    tg = hnsw.to_device(hnsw.host_graph_from_arrays(**_host_state(jg)), "cpu")
    jdev = jax_hnsw.to_device(jg)
    assert jg.max_level >= 1
    jq, jqn = _queries(jnp.asarray, queries)
    tq, tqn = _queries(torch.from_numpy, queries)
    want = np.asarray(jax_beam.greedy_descend(jdev, jq, jqn, jg.max_level, 1))
    got = beam.greedy_descend(tg, tq, tqn, jg.max_level, 1).numpy()
    share = float((got == want).mean())
    print(f"greedy_descend identical slots {share:.4f}")
    assert share >= 0.99


@pytest.mark.parametrize("ef_upper", [1, 4])
@pytest.mark.parametrize("ef", [16, 48])
def test_hnsw_search_matches_jax(ref, ef, ef_upper):
    data, queries, jg = ref
    tg = hnsw.to_device(hnsw.host_graph_from_arrays(**_host_state(jg)), "cpu", serve_only=True)
    jdev = jax_hnsw.to_device(jg, serve_only=True)
    jq, jqn = _queries(jnp.asarray, queries)
    tq, tqn = _queries(torch.from_numpy, queries)
    want = jax_beam.hnsw_search(jdev, jq, jqn, ef, ef_upper=ef_upper)
    got = beam.hnsw_search(tg, tq, tqn, ef, ef_upper=ef_upper)
    ws, gs = np.asarray(want.slots), got.slots.numpy()
    share = float((ws == gs).mean())
    print(f"hnsw_search ef={ef} ef_upper={ef_upper}: identical slots {share:.4f}")
    assert share >= 0.99
    same = (ws == gs) & (ws >= 0)
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=0, atol=1e-5)
    if share == 1.0:  # the loop ran exactly as long as the JAX while_loop
        assert int(got.iters) == int(want.iters)


@pytest.mark.parametrize("ef_upper", [1, 4])
def test_insertion_seeds_match_jax_search_descent(ref, ef_upper):
    """The seeds of a level-0 item's insertion are the seeds a search for
    its vector starts from: ``descend_for_slots(..., ef_upper)`` on stored
    items against the JAX package's ``_descend_start`` on their vectors."""
    _, _, jg = ref
    tg = hnsw.to_device(hnsw.host_graph_from_arrays(**_host_state(jg)), "cpu")
    jdev = jax_hnsw.to_device(jg)
    wave = np.arange(0, N, 11, dtype=np.int32)
    want = np.asarray(jax_beam._descend_start(jdev, jnp.asarray(jg.vectors[wave]), jnp.asarray(jg.norms[wave]), ef_upper))
    got = beam.descend_for_slots(tg, torch.from_numpy(wave), jg.max_level, 1, ef_upper=ef_upper).numpy()
    assert got.shape == (len(wave), ef_upper)
    share = float((got == want).mean())
    print(f"insertion seeds ef_upper={ef_upper}: identical slots {share:.4f}")
    assert share >= 0.99


def test_append_seeds_level0_items_with_the_pooled_descent(monkeypatch):
    """An append to an index wide enough for ``default_ef_upper`` to exceed
    1 (forced here at a small size) seeds level-0 items with that width and
    items of higher levels greedily; the graph stays valid and every
    appended item is found first for its own vector."""
    data, _ = _data()
    n_built = N - 200
    g = _stage(hnsw, data)
    builder.build_graph(g, np.arange(n_built, dtype=np.int64), np.empty(0, np.int64), _opts(builder), device="cpu")
    widths = []
    descend = beam.descend_for_slots

    def spy(dev, wave, from_level, to_level, **kw):
        seeds = descend(dev, wave, from_level, to_level, **kw)
        widths.append((to_level, kw.get("ef_upper", 1), seeds.shape[1]))
        return seeds

    monkeypatch.setattr(beam, "descend_for_slots", spy)
    monkeypatch.setattr(beam, "default_ef_upper", lambda n, ef: 4)
    builder.build_graph(g, np.arange(n_built, N, dtype=np.int64), np.empty(0, np.int64), _opts(builder), device="cpu")
    assert widths and {w for w in widths if w[0] == 1} == {(1, 4, 4)}
    assert all(w[1:] == (1, 1) for w in widths if w[0] > 1)
    g.check_validity()
    q = torch.from_numpy(data[n_built:])
    qn = torch.from_numpy(distances.np_norms(distances.COSINE, data[n_built:]))
    res = beam.hnsw_search(hnsw.to_device(g, "cpu", serve_only=True), q, qn, 48)
    assert np.array_equal(res.slots[:, 0].numpy(), np.arange(n_built, N))


@pytest.fixture(scope="module")
def wave_state(ref):
    """A JAX graph of the first N-128 items, and the next 128 as a wave."""
    data, _, _ = ref
    jg = _stage(jax_hnsw, data)
    n_built = N - 128
    jax_builder.build_graph(jg, np.arange(n_built, dtype=np.int64), np.empty(0, np.int64), _opts(jax_builder))
    wave = np.arange(n_built, N, dtype=np.int32)
    jdev = jax_hnsw.to_device(jg, cache=False)
    node_ok = np.asarray(jdev.valid).copy()
    node_ok[wave] = True
    seeds = np.array(jax_beam.descend_for_slots(jdev, jnp.asarray(wave), jg.max_level, 1, node_ok=jnp.asarray(node_ok)))
    return jg, wave, node_ok, seeds


@pytest.mark.parametrize("candidates", ["beam", "flat_members"])
def test_wave_insert_level_matches_jax(wave_state, candidates):
    jg, wave, node_ok, seeds = wave_state
    jdev = jax_hnsw.to_device(jg, cache=False)
    state = _device_state(jdev)
    members = None
    if candidates == "flat_members":
        members = np.full(2048, -1, dtype=np.int32)
        live = np.nonzero(state["valid"])[0]
        members[: len(live)] = live
    kw = dict(ef=EFC, cap=M0, alpha=1.0)

    j_res = jax_wave_ops.wave_insert_level(
        jdev, jnp.asarray(wave), jnp.asarray(seeds), jnp.asarray(node_ok), jnp.int32(0),
        jnp.zeros((jdev.capacity,), bool), jnp.zeros((4,), jnp.int32), is_level0=True,
        flat_members=None if members is None else jnp.asarray(members), **kw,
    )
    tdev = hnsw.device_graph_from_arrays("cpu", **state)
    t_res = wave_ops.wave_insert_level(
        tdev, torch.from_numpy(wave), torch.from_numpy(seeds), torch.from_numpy(node_ok), 0,
        torch.zeros(tdev.capacity, dtype=torch.bool), torch.zeros(4, dtype=torch.int32),
        flat_members=None if members is None else torch.from_numpy(members), **kw,
    )
    sel_share = float(np.mean(np.all(t_res.selected.numpy() == np.asarray(j_res.selected), axis=1)))
    j_links = np.asarray(j_res.graph.links0)
    t_links = t_res.graph.links0.numpy()
    live = np.asarray(j_res.graph.valid) | node_ok
    links_share = float(np.mean(np.all(t_links[live] == j_links[live], axis=1)))
    print(f"wave_insert_level[{candidates}]: selected rows {sel_share:.4f}, links0 rows {links_share:.4f}")
    assert sel_share >= 0.98
    assert links_share >= 0.98
    if links_share == 1.0:
        assert np.array_equal(t_res.dirty.numpy(), np.asarray(j_res.dirty))


@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan"])
def test_whole_build_matches_jax(ref, name):
    data, queries, jg = ref
    if name != "cosine":
        jg = _stage(jax_hnsw, data, name)
        jax_builder.build_graph(jg, np.arange(N, dtype=np.int64), np.empty(0, np.int64), _opts(jax_builder))
    tg = _stage(hnsw, data, name)
    stats = builder.build_graph(tg, np.arange(N, dtype=np.int64), np.empty(0, np.int64), _opts(builder), device="cpu")
    assert np.array_equal(tg.levels, jg.levels)
    assert tg.entry_slots == jg.entry_slots and tg.max_level == jg.max_level
    tg.check_validity()
    live = tg.valid_mask()
    indeg = np.bincount(tg.links0[live][tg.links0[live] >= 0], minlength=tg.capacity)
    assert (indeg[live] >= 1).all(), f"{int((indeg[live] == 0).sum())} live slots with in-degree 0"
    assert stats.waves > 0 and stats.beam_iters > 0

    q, qn = _queries(torch.from_numpy, queries, name)
    jq, jqn = _queries(jnp.asarray, queries, name)
    t_res = beam.hnsw_search(hnsw.to_device(tg, "cpu", serve_only=True), q, qn, 48)
    j_res = jax_beam.hnsw_search(jax_hnsw.to_device(jg, serve_only=True), jq, jqn, 48)
    t_rec = _oracle_recall(t_res.dists.numpy(), data, queries, name)
    j_rec = _oracle_recall(np.asarray(j_res.dists), data, queries, name)
    same_links = float(np.mean(np.all(tg.links0[live] == jg.links0[live], axis=1)))
    same_upper = [float(np.mean(np.all(a == b, axis=1))) for a, b in zip(tg.upper_links, jg.upper_links)]
    print(f"whole build {name}: recall@10 port {t_rec:.4f} jax {j_rec:.4f}; identical links0 rows "
          f"{same_links:.4f}, upper rows {same_upper}")
    assert t_rec >= j_rec - 0.02
    assert same_links >= 0.98 and min(same_upper) >= 0.98


def test_deleting_a_built_slot_repairs_and_an_unbuilt_one_is_harmless():
    """A build that deletes slot 3 (built) and slot N-1 (staged, never
    built) unlinks 3 from every row and leaves a valid graph; neither slot
    is flushed as touched (tests/test_torch_delete.py holds the repair
    against the JAX package)."""
    data, _ = _data()
    g = _stage(hnsw, data)
    builder.build_graph(g, np.arange(N - 1, dtype=np.int64), np.empty(0, np.int64), _opts(builder), device="cpu")
    assert (g.links0 == 3).any() and g.levels[N - 1] == -1
    stats = builder.build_graph(g, np.empty(0, np.int64), np.asarray([3, N - 1]), _opts(builder), device="cpu")
    assert not (g.links0 == 3).any() and not any((a == 3).any() for a in g.upper_links)
    assert len(stats.touched) and not {3, N - 1} & set(stats.touched.tolist())
    g.release_slot(3)  # the Writer releases deleted slots after the build
    g.check_validity()
    assert g.n_items == N - 2 and 3 not in g.entry_slots


@pytest.mark.parametrize("flat_max", [builder.BuildOptions().backbone_flat_max, 0], ids=["flat_backbone", "beam_backbone"])
def test_bulk_default_builds_valid_graph(monkeypatch, flat_max):
    """bulk=None picks the bulk path at >= bulk_threshold fresh items; its
    backbone takes exact triangular candidates, or ramped beam waves once
    it has more than ``backbone_flat_max`` members."""
    data, queries = _data()
    g = _stage(hnsw, data)
    ran = []
    monkeypatch.setattr(bulk, "bulk_build", lambda *a, **k: ran.append(1) or bulk_build(*a, **k))
    stats = builder.build_graph(g, np.arange(N, dtype=np.int64), np.empty(0, np.int64),
                                builder.BuildOptions(ef_construction=EFC, bulk_threshold=1000,
                                                     backbone_flat_max=flat_max), device="cpu")
    assert ran == [1] and stats.links_added > 0
    g.check_validity()
    live = g.valid_mask()
    indeg = np.bincount(g.links0[live][g.links0[live] >= 0], minlength=g.capacity)
    assert (indeg[live] >= 1).all()
    q, qn = _queries(torch.from_numpy, queries)
    res = beam.hnsw_search(hnsw.to_device(g, "cpu", serve_only=True), q, qn, 48)
    rec = _oracle_recall(res.dists.numpy(), data, queries)
    print(f"default bulk build at N={N}, backbone_flat_max={flat_max}: recall@10 {rec:.4f}")
    assert rec >= 0.9


def test_force_inbound_for_matches_jax(ref):
    """The end-of-build repair step on the same state: force an inbound
    edge for a set of slots (here: 24 chosen live slots) with the current
    in-degrees, as the re-check round does."""
    _, _, jg = ref
    jdev = jax_hnsw.to_device(jg, cache=False)
    state = _device_state(jdev)
    live = np.nonzero(state["valid"])[0]
    stranded = np.random.default_rng(3).choice(live, 24, replace=False).astype(np.int32)
    j_indeg, j_outdeg = jax_wave_ops.layer0_degrees(jdev, cap=M0)
    tdev = hnsw.device_graph_from_arrays("cpu", **state)
    t_indeg, t_outdeg = wave_ops.layer0_degrees(tdev, cap=M0)
    np.testing.assert_array_equal(t_indeg.numpy(), np.asarray(j_indeg))
    np.testing.assert_array_equal(t_outdeg.numpy(), np.asarray(j_outdeg))

    for shift in (0, 1):
        jdev = jax_hnsw.to_device(jg, cache=False)
        j_g, j_dirty, j_cnt = jax_wave_ops.force_inbound_for(
            jdev, jnp.asarray(stranded), j_indeg, jnp.zeros((jdev.capacity,), bool),
            jnp.zeros((4,), jnp.int32), shift=shift, write_cap=M0,
        )
        tdev = hnsw.device_graph_from_arrays("cpu", **state)
        t_g, t_dirty, t_cnt = wave_ops.force_inbound_for(
            tdev, torch.from_numpy(stranded), t_indeg, torch.zeros(tdev.capacity, dtype=torch.bool),
            torch.zeros(4, dtype=torch.int32), shift=shift, write_cap=M0,
        )
        np.testing.assert_array_equal(t_g.links0.numpy(), np.asarray(j_g.links0))
        np.testing.assert_array_equal(t_dirty.numpy(), np.asarray(j_dirty))
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
